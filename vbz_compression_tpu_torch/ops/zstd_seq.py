"""zstd sequences section — LZ77 match finding + FSE-coded sequences.

Stage two of the from-scratch zstd encoder (SURVEY.md §7 step 3b; roadmap
"zstd sequences section"): greedy single-probe hash matching (the shape of
zstd's *fast* strategy) plus an RFC 8878 §3.1.1.3.2 sequences section with
per-channel Predefined / RLE / FSE_Compressed table modes. Combined with the
Huffman literals stage (:mod:`.zstd_huff`), this produces complete
Compressed_Blocks with matches that any stock zstd decoder reads — the
reference pipeline consumes them through ``ZSTD_decompress``
(``vbz/vbz.cpp:263-273``).

The match finder is NumPy-vectorized (hash of every 4-byte window, last
previous occurrence via a stable lexsort, greedy scan that only visits
verified candidate positions); ``matcher="device"`` takes the candidates
from the bounded-offset scan of :mod:`.zstd_match` instead (kernel M on a
CUDA device).

The port's copy of ``vbz_compression_tpu.ops.zstd_seq``, native branches
included. Where ``libvbz_native.so`` builds (:mod:`..native_backend`),
``_native_lz`` returns it and the C code takes over: the hash index
(``vbz_lz_match_index``), the greedy scan (``vbz_lz_sequences``, also over
the device matcher's candidates), the sequences' FSE bitstream
(``vbz_zstd_seq_bitstream``) and, for the host matcher, the whole frame
(``vbz_own_zstd_frame``); each call is counted in
``native_backend.CALLS``. Else, or with ``_native_lz`` patched to return
None, the NumPy paths here run, which give the same frames
(``tests/test_torch_native.py``). The greedy assembler, the table-mode
choice and the block assembly are the original's line for line;
``tests/test_torch_zstd.py`` holds the frames to the original's.
"""

from __future__ import annotations

import numpy as np

from . import fse, zstd_huff

# ---------------------------------------------------------------------------
# Code tables (RFC 8878 §3.1.1.3.2.1.1)
# ---------------------------------------------------------------------------

LL_BITS = np.array([0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10,
                               11, 12, 13, 14, 15, 16], dtype=np.int64)
LL_BASE = np.concatenate([[0], np.cumsum(1 << LL_BITS)[:-1]]).astype(np.int64)

ML_BITS = np.array([0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
                               11, 12, 13, 14, 15, 16], dtype=np.int64)
ML_BASE = (np.concatenate([[0], np.cumsum(1 << ML_BITS)[:-1]]) + 3).astype(
    np.int64)

# Predefined FSE distributions (§3.1.1.3.2.2).
LL_PREDEF = np.array(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
     2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], dtype=np.int64)
LL_PREDEF_LOG = 6
ML_PREDEF = np.array(
    [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, dtype=np.int64)
ML_PREDEF_LOG = 6
OF_PREDEF = np.array(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     -1, -1, -1, -1, -1], dtype=np.int64)
OF_PREDEF_LOG = 5

MAX_LOG = {"ll": 9, "of": 8, "ml": 9}  # FSE_Compressed accuracy limits


def _code_of(value: np.ndarray, base: np.ndarray) -> np.ndarray:
    return np.searchsorted(base, value, side="right") - 1


# ---------------------------------------------------------------------------
# Match finding
# ---------------------------------------------------------------------------

MIN_MATCH = 4
HASH_BITS = 17


def _native_lz():
    """The native matcher (vbz_native.cpp vbz_lz_*) when the lib is built;
    None otherwise. Same hash/chain/greedy semantics at C speed — the
    NumPy lexsort index alone was 61% of the encoder's time."""
    try:
        from .. import native_backend as nb

        lib = nb.lib()
        return lib if hasattr(lib, "vbz_lz_match_index") else None
    except Exception:
        return None


def build_match_index(buf: np.ndarray):
    """For every position i: the most recent previous position with the same
    4-byte hash (-1 if none), plus the 4-byte window values for verification.
    """
    n = buf.size
    if n < MIN_MATCH:
        return np.zeros(0, np.int64), np.zeros(0, np.uint32)
    lib = _native_lz()
    if lib is not None:
        import ctypes

        from .. import native_backend as nb

        src = np.ascontiguousarray(buf)
        prev32 = np.empty(n - 3, np.int32)
        m = nb.call("vbz_lz_match_index",
                    src.ctypes.data_as(ctypes.c_void_p), n,
                    prev32.ctypes.data_as(ctypes.c_void_p))
        if m != n - 3:
            raise RuntimeError(f"vbz_lz_match_index gave {m} of {n - 3}")
        # The native greedy scan re-verifies windows from buf itself; v4
        # is only needed by the NumPy scan path, so don't build it.
        return prev32, None
    b = buf.astype(np.uint32)
    v4 = b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)
    h = ((v4 * np.uint32(2654435761)) >> np.uint32(32 - HASH_BITS))
    order = np.lexsort((np.arange(h.size), h))  # stable: by hash, then pos
    prev = np.full(h.size, -1, np.int64)
    same = h[order][1:] == h[order][:-1]
    prev[order[1:][same]] = order[:-1][same]
    return prev, v4


def _match_len(buf: np.ndarray, a: int, b: int, limit: int) -> int:
    """Common-prefix length of buf[a:] and buf[b:], capped at ``limit``."""
    done, chunk = 0, 512
    while done < limit:
        k = min(chunk, limit - done)
        neq = np.nonzero(buf[a + done:a + done + k]
                         != buf[b + done:b + done + k])[0]
        if neq.size:
            return done + int(neq[0])
        done += k
        chunk *= 4
    return limit


def find_sequences(buf: np.ndarray, bstart: int, bend: int,
                   prev: np.ndarray, v4: np.ndarray):
    """Greedy matches inside ``[bstart, bend)`` (sources may reach anywhere
    earlier in ``buf``). Returns ``(seqs, literals)`` where ``seqs`` is a
    list of ``(lit_len, offset, match_len)`` and ``literals`` the
    concatenated literal bytes (incl. the trailing run)."""
    if prev.size == 0:
        return [], buf[bstart:bend]
    lib = _native_lz()
    if lib is not None:
        import ctypes

        from .. import native_backend as nb

        src = np.ascontiguousarray(buf)
        prev32 = np.ascontiguousarray(prev.astype(np.int32, copy=False))
        cap = (bend - bstart) // MIN_MATCH + 1
        tri = np.empty(3 * cap, np.int32)
        cnt = int(nb.call(
            "vbz_lz_sequences", src.ctypes.data_as(ctypes.c_void_p),
            buf.size, bstart, bend, prev32.ctypes.data_as(ctypes.c_void_p),
            tri.ctypes.data_as(ctypes.c_void_p)))
        tri = tri[:3 * cnt].reshape(-1, 3)
        if cnt == 0:
            return tri, buf[bstart:bend]
        # Vectorized literal gather: seq k's literals span
        # [start_k, start_k + ll_k) with start_k = bstart + cum(ll+ml).
        ll = tri[:, 0].astype(np.int64)
        ml = tri[:, 2].astype(np.int64)
        adv = np.cumsum(ll + ml)
        starts = bstart + np.concatenate([[0], adv[:-1]])
        pre_ll = np.concatenate([[0], np.cumsum(ll)[:-1]])
        idx = np.repeat(starts - pre_ll, ll) + np.arange(int(ll.sum()))
        lits = np.concatenate([buf[idx], buf[bstart + int(adv[-1]):bend]])
        return tri, lits
    hi = min(bend - MIN_MATCH, prev.size - 1)
    cand = np.nonzero((prev[bstart:hi + 1] >= 0)
                      & (v4[np.maximum(prev[bstart:hi + 1], 0)]
                         == v4[bstart:hi + 1]))[0] + bstart
    seqs = []
    lit_parts = []
    anchor = i = bstart
    while True:
        k = np.searchsorted(cand, i)
        if k >= cand.size:
            break
        i = int(cand[k])
        c = int(prev[i])
        ml = MIN_MATCH + _match_len(buf, c + MIN_MATCH, i + MIN_MATCH,
                                    min(bend - i, 131074) - MIN_MATCH)
        seqs.append((i - anchor, i - c, ml))
        lit_parts.append(buf[anchor:i])
        i += ml
        anchor = i
    lit_parts.append(buf[anchor:bend])
    return seqs, np.concatenate(lit_parts) if len(lit_parts) > 1 \
        else lit_parts[0]


# ---------------------------------------------------------------------------
# Sequences section encoding
# ---------------------------------------------------------------------------


def _nb_seq_header(n: int) -> bytes:
    if n < 128:
        return bytes([n])
    if n < 0x7F00:
        return bytes([(n >> 8) + 0x80, n & 0xFF])
    return bytes([0xFF]) + int(n - 0x7F00).to_bytes(2, "little")


def _ctable_c(ct):
    """ctypes view of an fse.CTable (int32-narrowed arrays cached on the
    table object — they must stay alive for the call's duration)."""
    import ctypes

    from .. import native_backend as nb

    if ct is None:
        return None, None
    c32 = getattr(ct, "_c32", None)
    if c32 is None:
        c32 = (np.ascontiguousarray(ct.state_table.astype(np.int32)),
               np.ascontiguousarray(ct.delta_nb_bits.astype(np.int32)),
               np.ascontiguousarray(ct.delta_find_state.astype(np.int32)))
        ct._c32 = c32
    st, dnb, dfs = c32
    rec = nb._CFseTable(
        st.ctypes.data_as(ctypes.c_void_p).value,
        dnb.ctypes.data_as(ctypes.c_void_p).value,
        dfs.ctypes.data_as(ctypes.c_void_p).value,
        int(ct.accuracy_log))
    return ctypes.pointer(rec), rec


def _seq_bitstream_native(n, llc, ll_extra, ll_bits, ofc, of_extra, of_bits,
                          mlc, ml_extra, ml_bits, ll_ct, of_ct,
                          ml_ct) -> bytes:
    """The interleaved FSE bitstream via vbz_zstd_seq_bitstream (identical
    bytes to the Python BitWriter walk — asserted by the parity tests)."""
    import ctypes

    from .. import native_backend as nb

    def c32(a):
        return np.ascontiguousarray(a.astype(np.int32, copy=False))

    arrs = [c32(a) for a in (llc, ll_extra, ll_bits, ofc, of_extra,
                             of_bits, mlc, ml_extra, ml_bits)]
    # Per-seq worst case: 3 state pushes (<= 9 bits each) + extras
    # (<= 16 + 16 + 31 bits) < 12 bytes, plus flush/sentinel slack.
    cap = 12 * n + 16
    outb = np.empty(cap, np.uint8)
    ptrs = [_ctable_c(ct) for ct in (ll_ct, of_ct, ml_ct)]
    m = int(nb.call(
        "vbz_zstd_seq_bitstream",
        n, *[a.ctypes.data_as(ctypes.c_void_p) for a in arrs],
        ptrs[0][0], ptrs[1][0], ptrs[2][0],
        outb.ctypes.data_as(ctypes.c_void_p), cap))
    if m <= 0:
        raise RuntimeError("sequence bitstream overflow")
    return outb[:m].tobytes()


def _channel_table(codes: np.ndarray, predef: np.ndarray, predef_log: int,
                   max_log: int):
    """Pick the cheapest table mode for one channel.

    Returns ``(mode, desc_bytes, CTable|None)``; mode 0=Predefined, 1=RLE,
    3=FSE_Compressed (RFC values: Predefined_Mode=0, RLE_Mode=1,
    FSE_Compressed_Mode=2 — we return the RFC field value)."""
    import math

    n = codes.size
    if np.all(codes == codes[0]):
        return 1, bytes([int(codes[0])]), None
    freqs = np.bincount(codes, minlength=predef.size)

    # Estimated cost (bits): cross-entropy vs each table's distribution.
    # Sequential libm-log2 sums ON PURPOSE: the native port
    # (vbz_own_zstd.cpp) replays this loop with the same IEEE double ops,
    # so both sides make the SAME table-mode decision bit for bit (numpy's
    # pairwise summation / SIMD log2 could differ in the last ulp).
    def cross_entropy_bits(dist: np.ndarray) -> float:
        p = [0.5 if v < 0 else float(v) for v in dist.tolist()]
        tot = 0.0
        for v in p:
            tot += v
        bits = 0.0
        for f, pv in zip(freqs.tolist(), p):
            if f > 0:
                bits -= f * math.log2(pv / tot)
        return bits

    al = min(max_log, max(5, n.bit_length()))
    norm = fse.normalize_counts(freqs, al)
    desc = fse.write_norm_counts(norm, al)
    own_bits = cross_entropy_bits(norm) + 8 * len(desc)
    if freqs.size > predef.size:
        # A code outside the predefined alphabet (huge offsets): the
        # predefined table cannot represent it — own table is mandatory.
        return 2, desc, fse.CTable(norm, al)
    pre_bits = cross_entropy_bits(predef)
    if own_bits + 4 < pre_bits:  # margin: prefer predefined on ties
        return 2, desc, fse.CTable(norm, al)
    return 0, b"", fse.CTable(predef, predef_log)


def encode_sequences(seqs) -> bytes:
    """Full Sequences_Section for ``seqs`` = [(lit_len, offset, match_len)].
    """
    n = len(seqs)
    if n == 0:
        return b"\x00"
    if isinstance(seqs, np.ndarray):
        ll = seqs[:, 0].astype(np.int64)
        of = seqs[:, 1].astype(np.int64)
        ml = seqs[:, 2].astype(np.int64)
    else:
        ll = np.array([s[0] for s in seqs], dtype=np.int64)
        of = np.array([s[1] for s in seqs], dtype=np.int64)
        ml = np.array([s[2] for s in seqs], dtype=np.int64)
    assert (ml >= 3).all() and (of >= 1).all()

    llc = _code_of(ll, LL_BASE)
    mlc = _code_of(ml, ML_BASE)
    ofv = of + 3                     # no repeat-offset usage
    # bit_length(v) - 1 == frexp exponent - 1 (exact for v < 2^53).
    ofc = (np.frexp(ofv.astype(np.float64))[1] - 1).astype(np.int64)

    ll_extra, ll_bits = ll - LL_BASE[llc], LL_BITS[llc]
    ml_extra, ml_bits = ml - ML_BASE[mlc], ML_BITS[mlc]
    of_extra, of_bits = ofv - (np.int64(1) << ofc), ofc

    ll_mode, ll_desc, ll_ct = _channel_table(llc, LL_PREDEF, LL_PREDEF_LOG,
                                             MAX_LOG["ll"])
    of_mode, of_desc, of_ct = _channel_table(ofc, OF_PREDEF, OF_PREDEF_LOG,
                                             MAX_LOG["of"])
    ml_mode, ml_desc, ml_ct = _channel_table(mlc, ML_PREDEF, ML_PREDEF_LOG,
                                             MAX_LOG["ml"])

    modes = (ll_mode << 6) | (of_mode << 4) | (ml_mode << 2)
    out = [_nb_seq_header(n), bytes([modes]), ll_desc if ll_mode == 2
           else b"", of_desc if of_mode == 2 else b"",
           ml_desc if ml_mode == 2 else b""]
    # RLE descriptions are 1 byte, placed in the same LL, OF, ML order.
    if ll_mode == 1:
        out[2] = ll_desc
    if of_mode == 1:
        out[3] = of_desc
    if ml_mode == 1:
        out[4] = ml_desc

    lib = _native_lz()
    if lib is not None and hasattr(lib, "vbz_zstd_seq_bitstream"):
        out.append(_seq_bitstream_native(
            n, llc, ll_extra, ll_bits, ofc, of_extra, of_bits,
            mlc, ml_extra, ml_bits, ll_ct, of_ct, ml_ct))
        return b"".join(out)

    bw = fse.BitWriter()
    ll_st = fse.EncState(ll_ct) if ll_ct is not None else None
    of_st = fse.EncState(of_ct) if of_ct is not None else None
    ml_st = fse.EncState(ml_ct) if ml_ct is not None else None
    # libzstd ZSTD_encodeSequences order: init on the LAST sequence's codes
    # (ML, OF, LL), push its extra bits (LL, ML, OF), then walk backwards.
    if ml_st:
        ml_st.init(int(mlc[n - 1]))
    if of_st:
        of_st.init(int(ofc[n - 1]))
    if ll_st:
        ll_st.init(int(llc[n - 1]))
    bw.add(int(ll_extra[n - 1]), int(ll_bits[n - 1]))
    bw.add(int(ml_extra[n - 1]), int(ml_bits[n - 1]))
    bw.add(int(of_extra[n - 1]), int(of_bits[n - 1]))
    for i in range(n - 2, -1, -1):
        if of_st:
            of_st.encode(int(ofc[i]), bw)
        if ml_st:
            ml_st.encode(int(mlc[i]), bw)
        if ll_st:
            ll_st.encode(int(llc[i]), bw)
        bw.add(int(ll_extra[i]), int(ll_bits[i]))
        bw.add(int(ml_extra[i]), int(ml_bits[i]))
        bw.add(int(of_extra[i]), int(of_bits[i]))
    if ml_st:
        ml_st.flush(bw)
    if of_st:
        of_st.flush(bw)
    if ll_st:
        ll_st.flush(bw)
    out.append(bw.close())
    return b"".join(out)


# ---------------------------------------------------------------------------
# Block + frame assembly
# ---------------------------------------------------------------------------


def _sequences_block(buf: np.ndarray, bstart: int, bend: int,
                     prev: np.ndarray, v4: np.ndarray) -> bytes | None:
    """Compressed_Block content using matches, or None when matches don't
    help this chunk."""
    seqs, lits = find_sequences(buf, bstart, bend, prev, v4)
    if not len(seqs):
        return None
    lit_sec = zstd_huff.literals_section(lits)
    seq_sec = encode_sequences(seqs)
    content = lit_sec + seq_sec
    if len(content) >= (bend - bstart) or len(content) >= (1 << 21):
        return None
    return content


def compress_frame(data: bytes, matcher: str = "host",
                   device=None) -> bytes:
    """Complete zstd frame with LZ77 matches + entropy-coded sequences;
    per block the cheapest of {sequences, Huffman-literals, RLE, raw} wins.

    ``matcher``: "host" = full hash index (NumPy); "device" = bounded-offset
    compare scan on ``device`` (:func:`.zstd_match.build_match_index_device`:
    kernel M on a CUDA device, its plain version on the CPU).
    """
    if matcher not in ("host", "device"):
        raise ValueError(f"unknown matcher {matcher!r} (want host or device)")
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    if n < 256:
        header = bytes([0x20, n])
    elif n < (1 << 16) + 256:
        header = bytes([0x60]) + int(n - 256).to_bytes(2, "little")
    else:
        header = bytes([0xA0]) + int(n).to_bytes(4, "little")
    out = [zstd_huff.ZSTD_MAGIC.to_bytes(4, "little"), header]
    if n == 0:
        out.append((1 | (0 << 1) | (0 << 3)).to_bytes(3, "little"))
        return b"".join(out)

    if matcher == "host":
        # Complete native frame encoder (vbz_own_zstd.cpp): byte-identical
        # frames at C speed; the NumPy path below is the parity oracle
        # (tests/test_torch_native.py).
        lib = _native_lz()
        if lib is not None and hasattr(lib, "vbz_own_zstd_frame"):
            import ctypes

            from .. import native_backend as nb

            src = np.ascontiguousarray(buf)
            cap = n + n // 8 + 256
            out_buf = np.empty(cap, np.uint8)
            m = int(nb.call(
                "vbz_own_zstd_frame", src.ctypes.data_as(ctypes.c_void_p), n,
                out_buf.ctypes.data_as(ctypes.c_void_p), cap))
            if m > 0:
                return out_buf[:m].tobytes()
            # m <= 0: capacity/invariant breach — fall through to NumPy.
    if matcher == "device":
        from . import zstd_match

        prev, v4 = zstd_match.build_match_index_device(buf, device=device)
        if _native_lz() is not None and prev.size < 2**31:
            # The type the native greedy scan takes, narrowed once here
            # rather than on every block (find_sequences).
            prev = prev.astype(np.int32)
    else:
        prev, v4 = build_match_index(buf)
    pos = 0
    while pos < n:
        bend = min(pos + zstd_huff.BLOCK_MAX, n)
        chunk = buf[pos:bend]
        # Constant runs: a 4-byte RLE block beats everything.
        if np.all(chunk == chunk[0]) and chunk.size >= 4:
            last = 1 if bend >= n else 0
            out.append(int(last | (1 << 1)
                           | (chunk.size << 3)).to_bytes(3, "little"))
            out.append(bytes([int(chunk[0])]))
            pos = bend
            continue
        candidates = []
        seq_content = _sequences_block(buf, pos, bend, prev, v4)
        if seq_content is not None:
            candidates.append(seq_content)
        huff_content = zstd_huff._huffman_block(chunk)
        if huff_content is not None:
            candidates.append(huff_content)
        last = 1 if bend >= n else 0
        if candidates:
            content = min(candidates, key=len)
            out.append(int(last | (2 << 1)
                           | (len(content) << 3)).to_bytes(3, "little"))
            out.append(content)
        else:
            out.append(int(last | (0 << 1)
                           | (chunk.size << 3)).to_bytes(3, "little"))
            out.append(chunk.tobytes())
        pos = bend
    return b"".join(out)
