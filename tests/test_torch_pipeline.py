"""The port's codec round trip as a whole, on the CPU (plain versions of the
two kernels), against the JAX package's ``--backend device`` path, the
scalar oracle and Pallas K2 in interpret mode.

Tolerance: exact equality everywhere except the Pallas-interpret pixels,
held within +-1: the production Pallas kernels carry no FMA guard and CPU
XLA contracts their interpret-mode IDCT chains (the reason stated at
tests/test_pallas_decode8.py:159-164); ``ok`` must agree exactly there and
``kernels/scalar.py`` stays the exact pixel oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myyuv_tpu import native
from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import device_stream as jax_ds
from myyuv_tpu.engine import pipeline as jax_pipeline
from myyuv_tpu.engine import word_frame as jax_wf
from myyuv_tpu.entropy import pallas_decode8
from myyuv_tpu.formats import yuv as jax_yuv
from myyuv_tpu.kernels import scalar
from myyuv_tpu.runtime.errors import BitstreamError as JaxBitstreamError
from myyuv_tpu_torch.engine import pipeline
from myyuv_tpu_torch.formats import bmp as tbmp
from myyuv_tpu_torch.formats import dct_stream
from myyuv_tpu_torch.formats import yuv
from myyuv_tpu_torch.runtime.errors import BitstreamError, MyYUVError


def _planes(rng, h, w):
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 200
    y = (base + rng.integers(0, 40, (h, w))).astype(np.uint8)
    u = rng.integers(90, 170, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return y, u, v


def _images(rng, h, w):
    planes = _planes(rng, h, w)
    return (planes,
            yuv.YUVImage.from_planes(yuv.FourccFormats.IYUV, planes, w, h),
            jax_yuv.YUVImage.from_planes(jax_yuv.FourccFormats.IYUV, planes,
                                         w, h))


def _scalar_roundtrip(planes, q):
    out = []
    for i, p in enumerate(planes):
        qt = scalar.plane_qtable(i, q)
        co = scalar.dct_quantize_blocks(scalar.plane_to_blocks(p), qt)
        out.append(scalar.blocks_to_plane(
            scalar.dequantize_idct_blocks(co, qt), *p.shape))
    return out


@pytest.mark.parametrize("h,w,q", [(32, 64, 50), (32, 64, 90),
                                   (48, 96, 50)])
def test_compress_file_bytes_match_jax_device_backend(rng, h, w, q):
    _, img, jimg = _images(rng, h, w)
    got = pipeline.compress_dct(img, bytes([q] * 3), device="cpu")
    want = jax_pipeline.compress_dct(jimg, bytes([q] * 3),
                                     entropy_backend="device")
    assert got.to_bytes() == want.to_bytes()


@pytest.mark.parametrize("q", [50, 90])
def test_decompress_pixels_match_jax_and_scalar(rng, q):
    planes, img, jimg = _images(rng, 32, 64)
    comp = pipeline.compress_dct(img, bytes([q] * 3), device="cpu")
    got = pipeline.decompress_dct(comp, device="cpu")
    jcomp = jax_yuv.YUVImage.from_bytes(comp.to_bytes())
    want = jax_pipeline.decompress_dct(jcomp, entropy_backend="device")
    assert got.to_bytes() == want.to_bytes()
    for g, s in zip(got.planes(), _scalar_roundtrip(planes, q)):
        np.testing.assert_array_equal(g, s)


def test_decompress_matches_pallas_k2_interpret(rng):
    """Pallas K2 in interpret mode on the port's streams (32x64, q50):
    per-block ok identical, pixels within +-1 (see module docstring)."""
    h, w = 32, 64
    planes, img, _ = _images(rng, h, w)
    comp = pipeline.compress_dct(img, bytes([50] * 3), device="cpu")
    got = pipeline.decompress_dct(comp, device="cpu")
    st = dct_stream.DCTStream.parse(comp.data)
    sizes = np.concatenate([p.chunk_sizes.astype(np.int32)
                            for p in st.planes])
    content = np.concatenate([p.content for p in st.planes])
    cont = next(t for t in jax_ds.CONT_LADDER
                if sizes.max() <= 4 * (8 + t))
    a_np, b_np = native.expand_split(content, sizes)
    c_np = jax_ds._dense_c_np(b_np, sizes, cont)
    qtx, pids = jax_wf._qtx_pids(*jax_batch.plane_qtables([50] * 3), h, w,
                                 tile=8)
    pixw, ok = pallas_decode8.decode_idct_words8_split_fused(
        jnp.asarray(a_np), jnp.asarray(c_np), qtx, pids, interpret=True,
        tile=8)
    n = sizes.size
    ok_blocks = np.asarray(ok).T.reshape(-1)[:n] != 0
    np.testing.assert_array_equal(ok_blocks, np.ones(n, bool))
    ry, ru, rv = jax_wf.unpack_frame(pixw, h, w)
    for g, k, s in zip(got.planes(), (ry, ru, rv),
                       _scalar_roundtrip(planes, 50)):
        np.testing.assert_array_equal(g, s)
        assert np.abs(np.asarray(k).astype(int) - g.astype(int)).max() <= 1


def test_corrupt_file_rejected_like_jax(rng):
    _, img, _ = _images(rng, 32, 64)
    comp = pipeline.compress_dct(img, bytes([50] * 3), device="cpu")
    raw = bytearray(comp.to_bytes())
    # the first Y chunk's tree_size byte: 12 payload-header bytes, then
    # u32 block count, u32 content size and the 32 Y chunk sizes
    raw[yuv.HEADER_SIZE + 3 + 12 + 8 + 32 + 2] = 255
    with pytest.raises(BitstreamError, match="block 0 .code 2"):
        pipeline.decompress_dct(yuv.YUVImage.from_bytes(bytes(raw)), "cpu")
    with pytest.raises(JaxBitstreamError):
        jax_pipeline.decompress_dct(
            jax_yuv.YUVImage.from_bytes(bytes(raw)), entropy_backend="device")


def test_short_content_rejected(rng):
    """Chunk sizes adding up past a plane's content are refused before
    any decoding, as the host decoder refuses them."""
    _, img, _ = _images(rng, 32, 64)
    comp = pipeline.compress_dct(img, bytes([50] * 3), device="cpu")
    st = dct_stream.DCTStream.parse(comp.data)
    st.planes[1].content = st.planes[1].content[:-1]
    comp.data = st.serialize()
    with pytest.raises(BitstreamError, match="shorter"):
        pipeline.decompress_dct(comp, "cpu")


def test_entry_checks(rng):
    _, img, _ = _images(rng, 32, 64)
    with pytest.raises(MyYUVError):
        pipeline.compress_dct(img, bytes([0, 50, 50]), device="cpu")
    with pytest.raises(MyYUVError):
        pipeline.compress_dct(img, bytes([50, 50]), device="cpu")
    odd = yuv.YUVImage.from_planes(
        yuv.FourccFormats.IYUV,
        [np.zeros((8, 24), np.uint8), np.zeros((4, 12), np.uint8),
         np.zeros((4, 12), np.uint8)], 24, 8)
    with pytest.raises(MyYUVError):
        pipeline.compress_dct(odd, bytes([50] * 3), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(MyYUVError, match="cuda"):
            pipeline.compress_dct(img, bytes([50] * 3), device="cuda")


def test_decompress_of_uncompressed_returns_a_copy(rng):
    _, img, _ = _images(rng, 32, 64)
    out = img.decompress()
    assert out is not img and out.data is not img.data
    assert out.to_bytes() == img.to_bytes()


def test_bmp_to_iyuv_matches_jax(rng):
    from myyuv_tpu.formats import bmp as jbmp
    px = rng.integers(0, 256, (48, 96, 4), np.uint8)
    px[..., 3] = 255
    got = pipeline.bmp_to_iyuv(tbmp.BMPImage.from_pixels(px), device="cpu")
    want = jax_pipeline.bmp_to_iyuv(jbmp.BMPImage.from_pixels(px))
    assert got.to_bytes() == want.to_bytes()
    bgrx = pipeline.iyuv_to_bgrx(got, device="cpu")
    np.testing.assert_array_equal(bgrx, jax_pipeline.iyuv_to_bgrx(want))


@pytest.mark.parametrize("h,w", [(7, 9), (5, 5), (4, 3), (3, 4), (9, 8)])
def test_bmp_to_iyuv_refuses_odd_sizes(rng, tmp_path, capsys, h, w):
    """An odd width or height raises MyYUVError, as the exact scalar
    oracle refuses it, and the CLI reports the error (its BMP loader takes
    widths that are multiples of 4, so there the odd size is a height)."""
    from myyuv_tpu_torch import cli
    px = rng.integers(0, 256, (h, w, 4), np.uint8)
    image = tbmp.BMPImage.from_pixels(px)
    with pytest.raises(MyYUVError, match="even"):
        pipeline.bmp_to_iyuv(image, device="cpu")
    with pytest.raises(AssertionError):
        scalar.bgrx_to_iyuv(px)
    if w % 4:
        return
    src = tmp_path / "odd.bmp"
    image.dump(src)
    assert cli.main([str(src), "-to_yuv", "IYUV", "-o",
                     str(tmp_path / "a.myyuv"), "--device", "cpu"]) == 1
    assert "even width and height" in capsys.readouterr().err
    assert not (tmp_path / "a.myyuv").exists()
