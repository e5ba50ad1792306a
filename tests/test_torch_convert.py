"""The colour conversions X1 (BGRX -> IYUV) and X2 (IYUV -> BGRX) of the
port on the CPU: the plain versions (``kernels/device.py``) and the
wrappers (``kernels/convert.py``) against the scalar oracle and the JAX
package over their whole input domains, and the capture and playback steps
(``device_stream.ingest_frame`` / ``preview_frame``) against the JAX
package's frame API.

Tolerance: exact equality everywhere (planes, pixels, bytes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myyuv_tpu import native
from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import device_stream as jax_ds
from myyuv_tpu.engine import pipeline as jax_pipeline
from myyuv_tpu.formats import yuv as jax_yuv
from myyuv_tpu.kernels import device as jax_device
from myyuv_tpu.kernels import scalar
from myyuv_tpu_torch.engine import device_stream, pipeline
from myyuv_tpu_torch.formats import yuv
from myyuv_tpu_torch.kernels import convert, probe
from myyuv_tpu_torch.kernels import device as kdev
from myyuv_tpu_torch.runtime.errors import BitstreamError

BAND = 512  # pixel rows a comparison step holds (the frames are 4096 rows)

# JAX's conversions run op by op, as the JAX package's own tests run them:
# under jax.jit, CPU XLA contracts the luma chain of bgrx_to_iyuv into FMAs
# and 125 of the first band's 2^21 Y values differ from the scalar oracle
_jax_fwd = jax_device.bgrx_to_iyuv
_jax_inv = jax_device.iyuv_to_bgrx


def _equal(*arrays):
    for a in arrays[1:]:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(arrays[0]))


def test_x1_and_x2_on_every_colour(rng):
    """X1 on a 4096x4096 frame holding each 24-bit colour once, and X2 on
    its planes: the plain versions and the wrappers equal the scalar
    oracle and JAX's conversions."""
    px = probe.every_colour_bgrx(rng)
    for r in range(0, px.shape[0], BAND):
        band = px[r:r + BAND]
        want = scalar.bgrx_to_iyuv(band)
        t = torch.from_numpy(band)
        got = kdev.bgrx_to_iyuv(t)
        for w, p, c, j in zip(want, got, convert.bgrx_to_iyuv(t),
                              _jax_fwd(jnp.asarray(band))):
            _equal(w, p.numpy(), c.numpy(), j)
        want2 = scalar.iyuv_to_bgrx(*want)
        _equal(want2, kdev.iyuv_to_bgrx(*got).numpy(),
               convert.iyuv_to_bgrx(*got).numpy(),
               _jax_inv(*(jnp.asarray(p) for p in want)))


def test_x2_on_every_yuv_triple():
    """X2 on planes whose 2^24 pixels hold each (Y, U, V) triple once."""
    y, u, v = probe.every_yuv_triple()
    for r in range(0, y.shape[0], BAND):
        planes = (y[r:r + BAND], u[r // 2:(r + BAND) // 2],
                  v[r // 2:(r + BAND) // 2])
        t = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]
        _equal(scalar.iyuv_to_bgrx(*planes), kdev.iyuv_to_bgrx(*t).numpy(),
               convert.iyuv_to_bgrx(*t).numpy(),
               _jax_inv(*(jnp.asarray(p) for p in planes)))


@pytest.mark.parametrize("lead,h,w", [
    ((3,), 16, 32), ((), 15, 17), ((2,), 15, 17), ((2,), 16, 17),
    ((2, 2), 15, 16), ((), 1, 1), ((4,), 3, 6)])
def test_x2_batched_and_odd_sizes_match_jax(rng, lead, h, w):
    """X2 on [..., H, W] planes with [..., ceil(H/2), ceil(W/2)] chroma:
    each frame's chroma upsampled on the last two axes and cropped, as
    JAX's ``iyuv_to_bgrx`` does; 2-D frames also equal the scalar
    oracle."""
    hc, wc = (h + 1) // 2, (w + 1) // 2
    planes = [rng.integers(0, 256, (*lead, *s), np.uint8)
              for s in ((h, w), (hc, wc), (hc, wc))]
    t = [torch.from_numpy(p) for p in planes]
    got = kdev.iyuv_to_bgrx(*t)
    assert tuple(got.shape) == (*lead, h, w, 4)
    want = jax_device.iyuv_to_bgrx(*(jnp.asarray(p) for p in planes))
    _equal(want, got.numpy(), convert.iyuv_to_bgrx(*t).numpy())
    if not lead:
        _equal(scalar.iyuv_to_bgrx(*planes), got.numpy())


def test_convert_checks_its_inputs():
    """The wrappers refuse what the kernels do not take, on the CPU as on
    the card, and a device with no kernel."""
    px = torch.zeros((4, 8, 4), dtype=torch.uint8)
    for bad in (torch.zeros((3, 8, 4), dtype=torch.uint8),
                torch.zeros((4, 6, 3), dtype=torch.uint8),
                torch.zeros((4, 8, 4), dtype=torch.int32),
                torch.zeros((8, 4, 4), dtype=torch.uint8).transpose(0, 1),
                torch.zeros((4, 4), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            convert.bgrx_to_iyuv(bad)
    y = torch.zeros((5, 7), dtype=torch.uint8)
    c = torch.zeros((3, 4), dtype=torch.uint8)
    convert.iyuv_to_bgrx(y, c, c)
    for bad_c in (torch.zeros((2, 4), dtype=torch.uint8),
                  torch.zeros((3, 4), dtype=torch.int16),
                  torch.zeros((4, 3), dtype=torch.uint8).t()):
        with pytest.raises(ValueError):
            convert.iyuv_to_bgrx(y, bad_c, c)
    with pytest.raises(ValueError, match="device"):
        convert.bgrx_to_iyuv(px.to("meta"))
    with pytest.raises(ValueError, match="device"):
        convert.iyuv_to_bgrx(y.to("meta"), c.to("meta"), c.to("meta"))


def test_x1_into_given_planes(rng):
    """``bgrx_to_iyuv(out=...)`` writes the planes it would return into the
    given ones and returns them; it refuses planes of another shape or
    dtype."""
    px = torch.from_numpy(rng.integers(0, 256, (2, 16, 24, 4), np.uint8))
    out = [torch.empty(s, dtype=torch.uint8)
           for s in ((2, 16, 24), (2, 8, 12), (2, 8, 12))]
    got = convert.bgrx_to_iyuv(px, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, want in zip(got, kdev.bgrx_to_iyuv(px)):
        _equal(want, g)
    for bad in ((2, 16, 24), (2, 8, 12), (2, 12, 8)), ((16, 24), (8, 12),
                                                       (8, 12)):
        with pytest.raises(ValueError):
            convert.bgrx_to_iyuv(px, out=[torch.empty(s, dtype=torch.uint8)
                                          for s in bad])
    with pytest.raises(ValueError):
        convert.bgrx_to_iyuv(px, out=[o.to(torch.int16) for o in out])


def _jax_tables(q):
    return [np.asarray(t) for t in jax_batch.plane_qtables([q] * 3)]


@pytest.fixture(scope="module")
def _native():
    if not native.available():
        pytest.skip("native entropy library unavailable")


@pytest.mark.parametrize("q", [50, 90])
def test_ingest_frame_matches_jax(rng, _native, q):
    """X1 then K1 (plain versions): the chunk stream in ``content[:total]``
    equals JAX's ``bgrx_to_iyuv`` then ``compress_frame_to_streams`` byte
    for byte; ``total`` and ``ok`` are tensors."""
    h, w = 64, 128
    px = probe.smooth_picture(rng, h, w)
    dct, qt = pipeline.codec_params([q] * 3, "cpu")
    sizes, content, total, ok = device_stream.ingest_frame(
        torch.from_numpy(px), qt, dct)
    assert isinstance(total, torch.Tensor) and bool(ok)
    assert content.numel() >= int(total) == int(sizes.sum())
    got = device_stream.split_planes(sizes.numpy(),
                                     content[:int(total)].numpy(), h, w)
    jplanes = [np.asarray(p) for p in jax_device.bgrx_to_iyuv(
        jnp.asarray(px))]
    want = jax_ds.compress_frame_to_streams(jplanes, _jax_tables(q))
    for (gs, gc), (ws, wc) in zip(got, want):
        _equal(ws, gs)
        _equal(wc, gc)


def test_ingest_frame_of_a_batch_matches_jax(rng, _native):
    """A [B, H, W, 4] batch is coded as one frame of B*H rows: its streams
    are JAX's ``compress_batch_to_streams`` of the converted frames."""
    b, h, w = 2, 32, 64
    px = rng.integers(0, 256, (b, h, w, 4), np.uint8)
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    sizes, content, total, ok = device_stream.ingest_frame(
        torch.from_numpy(px), qt, dct)
    assert bool(ok)
    ny, nc, _ = kdev.plane_block_counts(h, w)
    got = device_stream.batch_streams_split(
        sizes.numpy(), content[:int(total)].numpy(), b, ny, nc)
    jplanes = [np.asarray(p) for p in jax_device.bgrx_to_iyuv(
        jnp.asarray(px))]
    want = jax_ds.compress_batch_to_streams(jplanes, _jax_tables(50))
    for f in range(b):
        for (gs, gc), (ws, wc) in zip(got[f], want[f]):
            _equal(ws, gs)
            _equal(wc, gc)


def _compressed(rng, h, w, q):
    planes = [probe.content_kind(rng, k, s) for k, s in
              (("gradient", (h, w)), ("noise", (h // 2, w // 2)),
               ("banded", (h // 2, w // 2)))]
    img = yuv.YUVImage.from_planes(yuv.FourccFormats.IYUV, planes, w, h)
    return pipeline.compress_dct(img, bytes([q] * 3), device="cpu")


@pytest.mark.parametrize("q", [50, 90])
def test_preview_frame_matches_jax(rng, _native, q):
    """K2 then X2 (plain versions) on a compressed image's stream: the BGRX
    equals JAX's ``pipeline.iyuv_to_bgrx`` of the same file, and so does
    the port's ``pipeline.iyuv_to_bgrx``."""
    h, w = 48, 96
    comp = _compressed(rng, h, w, q)
    want = jax_pipeline.iyuv_to_bgrx(jax_yuv.YUVImage.from_bytes(
        comp.to_bytes()))
    streams, dct, qt = pipeline._dct_streams(comp, "cpu")
    content, sizes = device_stream.streams_to_device(streams, "cpu")
    bgrx, ok = device_stream.preview_frame(content, sizes, qt, dct, h, w)
    assert isinstance(ok, torch.Tensor) and bool(ok)
    _equal(want, bgrx.numpy(), pipeline.iyuv_to_bgrx(comp, "cpu"))


def test_preview_of_a_corrupt_stream(rng):
    """A bad chunk clears ``ok`` in preview_frame; the pipeline's preview
    raises, as its decompress does."""
    h, w = 32, 64
    comp = _compressed(rng, h, w, 50)
    streams, dct, qt = pipeline._dct_streams(comp, "cpu")
    content, sizes = device_stream.streams_to_device(streams, "cpu")
    content = content.clone()
    content[2] ^= 0x5A                      # block 0's tree size
    _, ok = device_stream.preview_frame(content, sizes, qt, dct, h, w)
    assert not bool(ok)
    raw = bytearray(comp.to_bytes())
    # the first Y chunk's tree_size byte: 12 payload-header bytes, then
    # u32 block count, u32 content size and the 32 Y chunk sizes
    raw[yuv.HEADER_SIZE + 3 + 12 + 8 + 32 + 2] = 255
    bad = yuv.YUVImage.from_bytes(bytes(raw))
    for preview in (pipeline.decompress_dct, pipeline.iyuv_to_bgrx):
        with pytest.raises(BitstreamError, match="block 0 .code 2"):
            preview(bad, "cpu")
