"""The port's CUDA kernels on the card: E/D (W2), E4/D4 (W4) and V1E/V1D
(v1) against their plain PyTorch versions and, through the backend, against
the port's NumPy oracle; the copy kernel CP and the capability probe's
kernels against their plain versions. Exact.

Every test here is marked ``cuda`` and skips without a card. The file
imports nothing of the JAX package, so it also runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vbz_compression_tpu_torch import oracle, signals
from vbz_compression_tpu_torch.models.codec import TorchSvbBackend
from vbz_compression_tpu_torch.ops import probes, svb_v1, svb_w2, svb_w4
from vbz_compression_tpu_torch.tools import capability_probe
from vbz_compression_tpu_torch.utils import roofline

# flavor -> (row module, encode, plain encode, decode, plain decode, dtype)
_ROWS = {
    **{f: (svb_w2, svb_w2.encode_w2_rows, svb_w2.encode_w2_rows_plain,
           svb_w2.decode_w2_rows, svb_w2.decode_w2_rows_plain, dt)
       for f, dt in (("zz16", np.int16), ("zz8", np.int8))},
    **{f: (svb_w4, svb_w4.encode_w4_rows, svb_w4.encode_w4_rows_plain,
           svb_w4.decode_w4_rows, svb_w4.decode_w4_rows_plain, dt)
       for f, dt in (("zz32", np.int32), ("none32", np.int32),
                     ("none16", np.int16), ("none8", np.int8))},
    **{"v1_" + f: (svb_v1, svb_v1.encode_v1_rows, svb_v1.encode_v1_rows_plain,
                   svb_v1.decode_v1_rows, svb_v1.decode_v1_rows_plain,
                   np.int8)
       for f in ("zz8", "none8")},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _launches(mod):
    return mod.ENCODE_LAUNCHES, mod.DECODE_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_ROWS))
def test_kernels_match_plain_on_card(cuda_device, name):
    mod, enc, enc_plain, dec, dec_plain, dtype = _ROWS[name]
    flavor = name.removeprefix("v1_")
    rng = np.random.default_rng(23)
    lens = np.array([5, 4097, 70000, 0, 65536], np.int32)
    rows = signals.uniform(rng, lens.size * 70000, dtype).reshape(-1, 70000)
    rows[::2] = np.cumsum(rng.integers(-9, 9, (3, 70000)), axis=1).astype(dtype)
    if dtype == np.int8:
        rows[1, :2048] = signals.v1_odd_nibbles()
    x = torch.from_numpy(rows).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    before = _launches(mod)
    k1, d1, l1 = enc(x, n, flavor)
    k0, d0, l0 = enc_plain(x, n, flavor)
    assert torch.equal(k1, k0) and torch.equal(l1, l0)
    written = torch.arange(d0.shape[1], device=cuda_device)[None] < l0[:, None]
    assert torch.equal(torch.where(written, d1, 0), torch.where(written, d0, 0))
    o1 = dec(k1, d1, n, flavor)
    assert torch.equal(o1, dec_plain(k1, d1, n, flavor))
    valid = torch.arange(x.shape[1], device=cuda_device)[None] < n[:, None]
    assert torch.equal(o1, torch.where(valid, x, 0))
    assert _launches(mod) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("size,zigzag,version", [
    (2, True, 0), (1, True, 0), (4, True, 0), (4, False, 0), (2, False, 0),
    (1, False, 0), (1, True, 1), (1, False, 1)])
def test_backend_batch_matches_oracle_on_card(cuda_device, size, zigzag,
                                              version):
    """One batch call of ragged chunks: one launch sequence per direction,
    every stream the oracle's, every chunk back."""
    rng = np.random.default_rng(31)
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[size]
    chunks = [np.cumsum(rng.integers(-200, 200, n)).astype(dtype)
              for n in (1, 3, 4, 4097, 16385, 200003)]
    chunks.append(np.zeros(0, dtype))
    chunks.append(signals.uniform(rng, 5000, dtype))
    mod = svb_v1 if version == 1 and size == 1 else (
        svb_w2 if zigzag and size < 4 else svb_w4)
    backend = TorchSvbBackend(cuda_device)
    before = _launches(mod)
    streams = backend.svb_compress_batch(chunks, size, zigzag, version)
    outs = backend.svb_decompress_batch(streams, [c.size for c in chunks],
                                        size, zigzag, version)
    assert _launches(mod) == (before[0] + 1, before[1] + 1)
    for c, s, o in zip(chunks, streams, outs):
        assert s == oracle.svb_compress(c, size, zigzag, version), c.size
        assert o.dtype == dtype
        np.testing.assert_array_equal(o, c)


@pytest.mark.cuda
@pytest.mark.parametrize("R,rows", [
    (1 << 16, 8192), (3000, 600), (1000, 1),
    # 4 GiB + 4 KiB: more int4 vectors than one grid of copy.cu covers.
    ((1 << 23) + 8, 8)])
def test_copy_matches_plain_on_card(cuda_device, R, rows):
    gen = torch.Generator(device=cuda_device).manual_seed(R)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (R, 128), dtype=torch.int32,
                      device=cuda_device, generator=gen)
    before = roofline.COPY_LAUNCHES
    assert torch.equal(roofline.copy_blocked(x, rows),
                       roofline.copy_blocked_plain(x))
    assert roofline.COPY_LAUNCHES == before + 1


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card(cuda_device):
    before = dict(probes.LAUNCHES)
    cases = capability_probe.cases(cuda_device)
    for case in cases:
        assert capability_probe.max_abs_err(case.kernel(), case.plain()) == 0
    torch.cuda.synchronize()
    for key in before:
        assert probes.LAUNCHES[key] == before[key] + sum(
            c.key == key for c in cases)
