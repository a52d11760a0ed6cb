"""The port's CUDA kernels E and D on the card: against their plain PyTorch
versions and, through the backend, against the NumPy oracle. Exact.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vbz_compression_tpu.ops import scalar
from vbz_compression_tpu_torch.models.codec import TorchSvbBackend
from vbz_compression_tpu_torch.ops import svb_w2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the W2 kernels have no CPU mode")
    return torch.device("cuda")


def _launches():
    return svb_w2.ENCODE_LAUNCHES, svb_w2.DECODE_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["zz16", "zz8"])
def test_kernels_match_plain_on_card(cuda_device, flavor):
    rng = np.random.default_rng(23)
    lens = np.array([5, 4097, 70000, 0, 65536], np.int32)
    dtype = np.int16 if flavor == "zz16" else np.int8
    info = np.iinfo(dtype)
    rows = rng.integers(info.min, info.max + 1, (lens.size, 70000)).astype(dtype)
    rows[::2] = np.cumsum(rng.integers(-9, 9, (3, 70000)), axis=1).astype(dtype)
    x = torch.from_numpy(rows).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    before = _launches()
    k1, d1, l1 = svb_w2.encode_w2_rows(x, n, flavor)
    k0, d0, l0 = svb_w2.encode_w2_rows_plain(x, n, flavor)
    assert torch.equal(k1, k0) and torch.equal(l1, l0)
    written = torch.arange(d0.shape[1], device=cuda_device)[None] < l0[:, None]
    assert torch.equal(torch.where(written, d1, 0), torch.where(written, d0, 0))
    o1 = svb_w2.decode_w2_rows(k1, d1, n, flavor)
    assert torch.equal(o1, svb_w2.decode_w2_rows_plain(k1, d1, n, flavor))
    valid = torch.arange(x.shape[1], device=cuda_device)[None] < n[:, None]
    assert torch.equal(o1, torch.where(valid, x, 0))
    assert _launches() == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,size", [(np.int16, 2), (np.int8, 1)])
def test_backend_batch_matches_oracle_on_card(cuda_device, dtype, size):
    """One batch call of ragged chunks: one launch sequence per direction,
    every stream the oracle's, every chunk back."""
    rng = np.random.default_rng(31)
    info = np.iinfo(dtype)
    chunks = [np.cumsum(rng.integers(-200, 200, n)).astype(dtype)
              for n in (1, 3, 4, 4097, 16385, 200003)]
    chunks.append(np.zeros(0, dtype))
    chunks.append(rng.integers(info.min, info.max + 1, 5000).astype(dtype))
    backend = TorchSvbBackend(cuda_device)
    before = _launches()
    streams = backend.svb_compress_batch(chunks, size, True, 0)
    outs = backend.svb_decompress_batch(streams, [c.size for c in chunks],
                                        size, True, 0)
    assert _launches() == (before[0] + 1, before[1] + 1)
    for c, s, o in zip(chunks, streams, outs):
        assert s == scalar.svb_compress(c, size, True, 0), c.size
        assert o.dtype == dtype
        np.testing.assert_array_equal(o, c)
