"""FSE (Finite State Entropy / tANS) encoder — RFC 8878 §4.1.

From-scratch implementation of the zstd-flavoured tANS coder: normalized
count serialization, the canonical symbol-spread, encoder state tables, and
backward interleaved bitstreams. Used for Huffman weight compression
(§4.2.1.2, two alternating states) and the sequences section (§3.1.1.3.2,
custom or predefined tables).

The port's copy of ``vbz_compression_tpu.ops.fse``, kept identical so the
port needs nothing of the JAX package; ``tests/test_torch_zstd.py`` holds
it to the original. Validated end-to-end against the stock libzstd decoder
in tests.
"""

from __future__ import annotations

import numpy as np


def highbit(v: int) -> int:
    return v.bit_length() - 1


# ---------------------------------------------------------------------------
# Count normalization (sum → 2^accuracy_log, zstd rules)
# ---------------------------------------------------------------------------


def normalize_counts(freqs: np.ndarray, accuracy_log: int,
                     total: int | None = None) -> np.ndarray:
    """Return normalized counts summing to 2^accuracy_log; rare symbols get
    -1 ("less than 1" probability). Mirrors FSE_normalizeCount semantics
    (not bit-exact — any valid normalization decodes identically)."""
    freqs = np.asarray(freqs, dtype=np.int64)
    total = int(freqs.sum()) if total is None else total
    table_size = 1 << accuracy_log
    assert total > 0
    norm = np.zeros_like(freqs)
    # scaled proportional shares
    scale = table_size / total
    norm = np.floor(freqs * scale).astype(np.int64)
    norm[(freqs > 0) & (norm == 0)] = -1  # low-prob symbols
    assigned = int(norm[norm > 0].sum()) + int((norm == -1).sum())
    rest = table_size - assigned
    if rest < 0:
        # shrink the largest entries
        while rest < 0:
            i = int(np.argmax(norm))
            take = min(-rest, norm[i] - 1)
            norm[i] -= take
            rest += take
    elif rest > 0:
        # give the remainder to the largest-frequency symbol(s); stable
        # order so the JAX package's native encoder's (-freq, index) sort
        # picks the SAME
        # symbol on frequency ties (frames must stay byte-identical).
        order = np.argsort(-freqs, kind="stable")
        for i in order:
            if norm[i] > 0:
                norm[i] += rest
                rest = 0
                break
    assert int(norm[norm > 0].sum()) + int((norm == -1).sum()) == table_size
    return norm


def write_norm_counts(norm: np.ndarray, accuracy_log: int) -> bytes:
    """FSE table description (RFC 8878 §4.1.1), exact inverse of
    :func:`read_norm_counts`: a 4-bit accuracy code then variable-width
    probability fields whose width shrinks as the remaining probability
    mass drops, with 2-bit repeat flags after zeros."""
    out = bytearray()
    bits_buf = 0
    bits_n = 0

    def push(value: int, nbits: int):
        nonlocal bits_buf, bits_n
        bits_buf |= (value & ((1 << nbits) - 1)) << bits_n
        bits_n += nbits
        while bits_n >= 8:
            out.append(bits_buf & 0xFF)
            bits_buf >>= 8
            bits_n -= 8

    push(accuracy_log - 5, 4)
    norm = np.asarray(norm, dtype=np.int64)
    n_sym = int(np.nonzero(norm != 0)[0][-1]) + 1
    remaining = (1 << accuracy_log) + 1
    threshold = 1 << accuracy_log
    nb_bits = accuracy_log + 1
    s_i = 0
    while remaining > 1 and s_i < n_sym:
        proba = int(norm[s_i])
        value = proba + 1
        vmax = 2 * threshold - 1 - remaining
        if value < vmax:
            push(value, nb_bits - 1)
        elif value < threshold:
            push(value, nb_bits)
        else:
            push(value + vmax, nb_bits)
        remaining -= -proba if proba < 0 else proba
        while remaining < threshold:
            threshold >>= 1
            nb_bits -= 1
        s_i += 1
        if proba == 0:
            run = 0
            while s_i + run < n_sym and norm[s_i + run] == 0:
                run += 1
            r = run
            while True:
                push(min(r, 3), 2)
                if r < 3:
                    break
                r -= 3
            s_i += run
    if bits_n:
        out.append(bits_buf & 0xFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# Encoder tables
# ---------------------------------------------------------------------------


def spread_symbols(norm: np.ndarray, accuracy_log: int) -> np.ndarray:
    """Canonical zstd symbol spread (§4.1.2): -1 symbols one cell each from
    the table end; others step-scattered skipping the reserved tail."""
    table_size = 1 << accuracy_log
    table = np.zeros(table_size, dtype=np.int32)
    high = table_size - 1
    for s in np.nonzero(norm == -1)[0]:
        table[high] = s
        high -= 1
    step = (table_size >> 1) + (table_size >> 3) + 3
    mask = table_size - 1
    pos = 0
    for s in np.nonzero(norm > 0)[0]:
        for _ in range(int(norm[s])):
            table[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    assert pos == 0
    return table


class CTable:
    """Encoder tables per symbol: deltaNbBits, deltaFindState + state map."""

    def __init__(self, norm: np.ndarray, accuracy_log: int):
        norm = np.asarray(norm, dtype=np.int64)
        self.accuracy_log = accuracy_log
        table_size = 1 << accuracy_log
        spread = spread_symbols(norm, accuracy_log)
        eff = np.where(norm == -1, 1, norm).astype(np.int64)
        cumul = np.concatenate([[0], np.cumsum(eff)])
        # Vectorized fill: destinations cumul[s] + rank-within-symbol cover
        # [cumul[s], cumul[s+1]) per symbol, so the stable sort of spread
        # by symbol maps onto destinations 0..table_size-1 sequentially.
        order = np.argsort(spread, kind="stable")
        self.state_table = np.zeros(table_size, dtype=np.int64)
        self.state_table[:] = table_size + order
        nsym = norm.shape[0]
        c = eff
        single = (norm == -1) | (c == 1)
        present = c > 0
        with np.errstate(divide="ignore"):
            hb = np.zeros(nsym, dtype=np.int64)
            nzm = present & ~single
            if nzm.any():
                hb[nzm] = np.frexp((c[nzm] - 1).astype(
                    np.float64))[1] - 1  # highbit(c-1), exact (c < 2^53)
        max_bits_out = accuracy_log - hb
        self.delta_nb_bits = np.where(
            single, (accuracy_log << 16) - (1 << accuracy_log),
            (max_bits_out << 16) - (c << max_bits_out)) * present
        self.delta_find_state = np.where(
            single, cumul[:-1] - 1, cumul[:-1] - c) * present


class BitWriter:
    """LSB-first forward bit accumulation (stream is read backwards)."""

    def __init__(self):
        self.bits = []

    def add(self, value: int, nbits: int):
        if nbits:
            self.bits.append((value & ((1 << nbits) - 1), nbits))

    def close(self) -> bytes:
        buf = 0
        pos = 0
        for v, n in self.bits:
            buf |= v << pos
            pos += n
        buf |= 1 << pos  # sentinel
        pos += 1
        nbytes = (pos + 7) // 8
        return buf.to_bytes(nbytes, "little")


class EncState:
    def __init__(self, ct: CTable):
        self.ct = ct
        self.state = 0
        self.started = False

    def init(self, symbol: int):
        ct = self.ct
        nbits = (int(ct.delta_nb_bits[symbol]) + (1 << 15)) >> 16
        sub = (nbits << 16) - int(ct.delta_nb_bits[symbol])
        self.state = int(ct.state_table[
            (sub >> nbits) + int(ct.delta_find_state[symbol])])
        self.started = True

    def encode(self, symbol: int, bw: BitWriter):
        if not self.started:
            self.init(symbol)
            return
        ct = self.ct
        nbits = (self.state + int(ct.delta_nb_bits[symbol])) >> 16
        bw.add(self.state, nbits)
        self.state = int(ct.state_table[
            (self.state >> nbits) + int(ct.delta_find_state[symbol])])

    def flush(self, bw: BitWriter):
        bw.add(self.state, self.ct.accuracy_log)


# ---------------------------------------------------------------------------
# Reference decoder (spec-faithful; used to debug/validate the encoder)
# ---------------------------------------------------------------------------


class _BitReaderLSB:
    """Forward LSB-first reader for the table description."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read(self, n: int) -> int:
        v = 0
        for i in range(n):
            byte = self.data[(self.pos + i) >> 3]
            v |= ((byte >> ((self.pos + i) & 7)) & 1) << i
        self.pos += n
        return v


def read_norm_counts(data: bytes):
    """Decode an FSE table description (RFC 8878 §4.1.1). Returns
    (norm_counts list, accuracy_log, bytes_consumed)."""
    br = _BitReaderLSB(data)
    al = br.read(4) + 5
    remaining = (1 << al) + 1
    threshold = 1 << al
    nb_bits = al + 1
    norm = []
    while remaining > 1:
        vmax = 2 * threshold - 1 - remaining
        low = br.read(nb_bits - 1)
        if low < vmax:
            value = low
        else:
            msb = br.read(1)
            full = low | (msb << (nb_bits - 1))
            value = full if full < threshold else full - vmax
        proba = value - 1
        norm.append(proba)
        remaining -= -proba if proba < 0 else proba
        while remaining < threshold and threshold > 1:
            threshold >>= 1
            nb_bits -= 1
        if proba == 0:
            while True:
                rep = br.read(2)
                norm.extend([0] * rep)
                if rep < 3:
                    break
    consumed = (br.pos + 7) >> 3
    return norm, al, consumed


class _BitReaderBack:
    """Backward reader: starts after the final 1-sentinel at the stream end,
    reads fields MSB-side-first (zstd bitstream convention)."""

    def __init__(self, data: bytes):
        self.data = data
        total = len(data) * 8
        last = data[-1]
        assert last != 0, "missing sentinel"
        self.pos = total - (8 - last.bit_length()) - 1  # skip sentinel bit

    def read(self, n: int) -> int:
        self.pos -= n
        v = 0
        for i in range(n):
            p = self.pos + i
            if p < 0:
                continue  # zero-fill past the start
            v |= ((self.data[p >> 3] >> (p & 7)) & 1) << i
        return v


def build_dtable(norm, al):
    """Decoding table (spec §4.1.3): per state cell — symbol, nbits,
    baseline — via the canonical per-symbol counter construction."""
    norm = np.asarray(norm, dtype=np.int64)
    table_size = 1 << al
    spread = spread_symbols(norm, al)
    eff = np.where(norm == -1, 1, np.maximum(norm, 0))
    counter = eff.copy()
    nbits = np.zeros(table_size, dtype=np.int64)
    baseline = np.zeros(table_size, dtype=np.int64)
    for i in range(table_size):
        sym = int(spread[i])
        x = int(counter[sym])
        counter[sym] += 1
        nb = al - (x.bit_length() - 1)
        nbits[i] = nb
        baseline[i] = (x << nb) - table_size
    return spread, nbits, baseline


def decompress_weights(payload: bytes):
    """Decode an FSE-compressed Huffman weight payload (two interleaved
    states, spec §4.2.1.2). Returns the weight list."""
    norm, al, consumed = read_norm_counts(payload)
    spread, nbits, baseline = build_dtable(norm, al)
    stream = payload[consumed:]
    br = _BitReaderBack(stream)
    s1 = br.read(al)
    s2 = br.read(al)
    out = []
    while True:
        out.append(int(spread[s1]))
        s1 = int(baseline[s1]) + br.read(int(nbits[s1]))
        if br.pos < 0:
            out.append(int(spread[s2]))
            break
        out.append(int(spread[s2]))
        s2 = int(baseline[s2]) + br.read(int(nbits[s2]))
        if br.pos < 0:
            out.append(int(spread[s1]))
            break
    return out


# ---------------------------------------------------------------------------
# Huffman weight compression (§4.2.1.2: two interleaved states)
# ---------------------------------------------------------------------------


def compress_weights(weights: np.ndarray) -> bytes | None:
    """FSE-compress a Huffman weight sequence (two interleaved states,
    mirroring the libzstd encoder structure). Returns the payload
    (table description + backward bitstream) or None when not profitable."""
    w = np.asarray(weights, dtype=np.int64)
    n = int(w.size)
    if n < 2:
        return None
    freqs = np.bincount(w, minlength=int(w.max()) + 1)
    if int((freqs > 0).sum()) < 2:
        return None
    al = min(6, max(5, (n.bit_length() - 2)))
    norm = normalize_counts(freqs, al)
    desc = write_norm_counts(norm, al)
    ct = CTable(norm, al)
    bw = BitWriter()

    c1 = EncState(ct)
    c2 = EncState(ct)
    # Decoder: state1 emits even indices, state2 odd. Encoder processes in
    # reverse; the first symbol each state *inits* with is its last-decoded.
    if n & 1:
        c1.init(int(w[n - 1]))
        c2.init(int(w[n - 2]))
        ip = n - 3
        # parity fix: one extra encode into c1
        if ip >= 0:
            c1.encode(int(w[ip]), bw)
            ip -= 1
    else:
        c2.init(int(w[n - 1]))
        c1.init(int(w[n - 2]))
        ip = n - 3
    while ip >= 0:
        c2.encode(int(w[ip]), bw)
        ip -= 1
        if ip >= 0:
            c1.encode(int(w[ip]), bw)
            ip -= 1
    c2.flush(bw)
    c1.flush(bw)
    payload = desc + bw.close()
    if len(payload) >= 128 or len(payload) >= n:
        return None
    # Self-verify: weight streams carry no explicit count — the decoder stops
    # on bitstream exhaustion, which is ambiguous for tables containing
    # zero-bit states. Only emit payloads that decode back exactly.
    try:
        if decompress_weights(payload) != w.tolist():
            return None
    except Exception:
        return None
    return payload
