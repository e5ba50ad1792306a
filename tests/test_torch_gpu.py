"""The CUDA kernels K1 and K2 against their plain PyTorch versions on the
card. Marked ``gpu``: they skip where no CUDA device is present, and run
with ``python -m pytest tests/test_torch_gpu.py`` on a machine with one.

Tolerance: exact equality (bytes, sizes, pixels, error codes)."""

import numpy as np
import pytest
import torch

from myyuv_tpu_torch.engine import device_stream, pipeline
from myyuv_tpu_torch.entropy import decode, encode
from myyuv_tpu_torch.kernels import probe

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frame(rng, h, w):
    y = probe.with_probe_blocks(rng.integers(0, 256, (h, w), np.uint8),
                                probe.contraction_probe_blocks())
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = np.full((h // 2, w // 2), 77, np.uint8)
    return y, u, v


@pytest.mark.parametrize("q", [1, 50, 90, 100])
def test_k1_and_k2_match_plain(rng, cuda, q):
    h, w = 64, 128
    planes = [torch.from_numpy(p).to(cuda) for p in _frame(rng, h, w)]
    dct, qt = pipeline.codec_params([q] * 3, cuda)
    got = encode.dct_encode_blocks(*planes, qt, dct)
    want = encode.dct_encode_blocks_plain(*planes, qt, dct)
    for g, p in zip(got, want):
        assert g.is_cuda and torch.equal(g, p)
    sizes, content = device_stream.compress_frame(*planes, qt, dct)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    got = decode.decode_idct_blocks(content, sizes, offsets, qt, dct, h, w)
    want = decode.decode_idct_blocks_plain(content, sizes, offsets, qt, dct,
                                           h, w)
    for g, p in zip(got, want):
        assert g.is_cuda and torch.equal(g, p)
    assert not got[3].any()


@pytest.mark.parametrize("shape", [(16, 16), (736, 992)])
@pytest.mark.parametrize("q", [1, 10, 35, 75, 100])
def test_content_kinds_sweep(rng, cuda, shape, q):
    """Five content kinds per quality; 16x16 has 6 blocks (no multiple of
    8 or of the thread-block size)."""
    h, w = shape
    dct, qt = pipeline.codec_params([q] * 3, cuda)
    for kind in probe.KINDS:
        planes = [torch.from_numpy(probe.content_kind(rng, kind, s)).to(cuda)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        got = encode.dct_encode_blocks(*planes, qt, dct)
        want = encode.dct_encode_blocks_plain(*planes, qt, dct)
        for g, p in zip(got, want):
            assert torch.equal(g, p), kind
        sizes, content = device_stream.compress_frame(*planes, qt, dct)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        got = decode.decode_idct_blocks(content, sizes, offsets, qt, dct,
                                        h, w)
        want = decode.decode_idct_blocks_plain(content, sizes, offsets, qt,
                                               dct, h, w)
        for g, p in zip(got, want):
            assert torch.equal(g, p), kind
        assert not got[3].any()


def test_k2_flags_corrupt_chunks_like_plain(rng, cuda):
    h, w = 32, 64
    planes = [torch.from_numpy(p).to(cuda) for p in _frame(rng, h, w)]
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    sizes, content = device_stream.compress_frame(*planes, qt, dct)
    content = content.clone()
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    for b, flip in ((0, 2), (5, 0), (9, 3)):  # tree size, enc bits, tree
        content[offsets[b] + flip] ^= 0x5A
    sizes = sizes.clone()
    sizes[20] = 2
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    offsets[30] = content.numel() - 2      # runs off the end of content
    offsets[31] = content.numel() + 100    # wholly outside it
    got = decode.decode_idct_blocks(content, sizes, offsets, qt, dct, h, w)
    want = decode.decode_idct_blocks_plain(content, sizes, offsets, qt, dct,
                                           h, w)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    assert got[3][20] == 1 and got[3][0] != 0


def test_cuda_and_cpu_files_identical(rng, cuda):
    from myyuv_tpu_torch.formats import yuv
    planes = _frame(rng, 48, 96)
    img = yuv.YUVImage.from_planes(yuv.FourccFormats.IYUV, planes, 96, 48)
    a = pipeline.compress_dct(img, bytes([75] * 3), device="cuda")
    b = pipeline.compress_dct(img, bytes([75] * 3), device="cpu")
    assert a.to_bytes() == b.to_bytes()
    assert (pipeline.decompress_dct(a, "cuda").to_bytes()
            == pipeline.decompress_dct(b, "cpu").to_bytes())
