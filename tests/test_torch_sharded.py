"""The port's multi-device path on a mesh of 8 ``torch.device("cpu")``
entries, shaped (4, 2) and (8, 1), against the JAX package's on the 8
virtual CPU devices of tests/conftest.py: the sharded frame codec
(``compress_frame_sharded``, ``decompress_frame_sharded``), the sharded
batch (``compress_batch_sharded``), the sharded round trip step
(``make_sharded_roundtrip``), the single-file assembly
(``streams_to_compressed``), ``make_mesh`` and ``entry.dryrun_multichip``.
Frames include heavy padding (48x64: chroma of 3 block rows over 8 shards)
and a width that is a multiple of 128 but not of 512 (384).

Tolerance: byte and pixel equality, and equal histograms; the round trip's
float32 SSE sums to rtol 1e-6 (the shards' sums are added in another order
than one sum over the batch)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from myyuv_tpu.engine import batch as jbatch
from myyuv_tpu.engine import pipeline as jpipeline
from myyuv_tpu.engine import sharded_stream as jss
from myyuv_tpu.formats import yuv as jyuv
from myyuv_tpu.kernels import scalar
from myyuv_tpu.parallel import mesh as jmesh
from myyuv_tpu_torch import entry
from myyuv_tpu_torch.engine import batch as tbatch
from myyuv_tpu_torch.engine import device_stream as ds
from myyuv_tpu_torch.engine import pipeline as tpipeline
from myyuv_tpu_torch.engine import sharded_stream as tss
from myyuv_tpu_torch.formats import yuv as tyuv
from myyuv_tpu_torch.parallel import mesh as meshlib
from myyuv_tpu_torch.runtime.errors import BitstreamError

SHAPES = [(4, 2), (8, 1)]
FRAMES = [(64, 128), (48, 64), (32, 384)]


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh((4, 2))


def _mesh(shape):
    return meshlib.make_mesh(shape, [torch.device("cpu")] * 8)


def _plane(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
    return (base + rng.integers(0, 24, (h, w), np.uint8)).astype(np.uint8)


def _frame(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [_plane(rng, h, w), _plane(rng, h // 2, w // 2),
            _plane(rng, h // 2, w // 2)]


def _qts(q):
    return [np.asarray(scalar.plane_qtable(i, q), np.float32)
            for i in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_streams(h, w, q):
    mesh = jmesh.make_mesh((4, 2))
    return jss.compress_frame_sharded(mesh, _frame(h, w), _qts(q))


def _assert_streams_equal(got, want):
    assert len(got) == len(want) == 3
    for (gs, gc), (ws, wc) in zip(got, want):
        assert gs.dtype == np.uint8 and gc.dtype == np.uint8
        np.testing.assert_array_equal(gs.astype(np.int64),
                                      ws.astype(np.int64))
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h,w", FRAMES)
def test_compress_frame_sharded_matches_jax(jax_mesh, shape, h, w):
    planes = _frame(h, w)
    got = tss.compress_frame_sharded(_mesh(shape), planes, _qts(50))
    _assert_streams_equal(got, _jax_streams(h, w, 50))
    dct, qt = tpipeline.codec_params([50] * 3, "cpu")
    _assert_streams_equal(got, ds.compress_frame_to_streams(planes, qt, dct))


@pytest.mark.parametrize("h,w", FRAMES)
def test_decompress_frame_sharded_matches_jax(jax_mesh, h, w):
    planes = _frame(h, w)
    qts = _qts(70)
    streams = _jax_streams(h, w, 70)
    want = jss.decompress_frame_sharded(jax_mesh, streams, qts, h, w)
    for shape in SHAPES:
        got = tss.decompress_frame_sharded(_mesh(shape), streams, qts, h, w)
        for g, wnt, p in zip(got, want, planes):
            assert g.shape == p.shape
            np.testing.assert_array_equal(g, np.asarray(wnt))


def test_compress_batch_sharded_matches_jax(jax_mesh):
    rng = np.random.default_rng(3)
    h, w, b = 32, 64, 3
    planes = (np.stack([_plane(rng, h, w) for _ in range(b)]),
              np.stack([_plane(rng, h // 2, w // 2) for _ in range(b)]),
              np.stack([_plane(rng, h // 2, w // 2) for _ in range(b)]))
    want = jss.compress_batch_sharded(jax_mesh, planes, _qts(50))
    for shape in SHAPES:
        got = tss.compress_batch_sharded(_mesh(shape), planes, _qts(50))
        assert len(got) == len(want) == b
        for g, wnt in zip(got, want):
            _assert_streams_equal(g, wnt)


@pytest.mark.parametrize("qualities", [(50, 60, 70), (90, 90, 90)])
def test_sharded_roundtrip_matches_jax(jax_mesh, qualities):
    rng = np.random.default_rng(4)
    b, h, w = 4, 32, 64
    y, u, v = (rng.integers(0, 256, (b, h, w), np.uint8),
               rng.integers(0, 256, (b, h // 2, w // 2), np.uint8),
               rng.integers(0, 256, (b, h // 2, w // 2), np.uint8))
    fn = jbatch.make_sharded_roundtrip(jax_mesh)
    with jax_mesh:
        want, wm = fn(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                      *jbatch.plane_qtables(list(qualities)))
    step = tbatch.make_sharded_roundtrip(_mesh((4, 2)))
    got, m = step(*(torch.from_numpy(p) for p in (y, u, v)),
                  *tbatch.plane_qtables(qualities, "cpu"))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    np.testing.assert_array_equal(m["symbol_hist"].numpy(),
                                  np.asarray(wm["symbol_hist"]))
    assert m["symbol_hist"].dtype == torch.int32
    assert int(m["symbol_hist"].sum()) == y.size + u.size + v.size
    for k in ("sse_y", "sse_u", "sse_v", "entropy_bits_per_symbol"):
        np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=1e-6)
    # and the port's unsharded step
    _, um = tbatch.roundtrip_step(*(torch.from_numpy(p) for p in (y, u, v)),
                                  *tbatch.plane_qtables(qualities, "cpu"))
    assert torch.equal(um["symbol_hist"], m["symbol_hist"])
    for k in ("sse_y", "sse_u", "sse_v"):
        np.testing.assert_allclose(float(m[k]), float(um[k]), rtol=1e-6)


def test_sharded_roundtrip_refuses_uneven_shards():
    step = tbatch.make_sharded_roundtrip(_mesh((4, 2)))
    qts = tbatch.plane_qtables([50] * 3, "cpu")

    def planes(b, h, w):
        return (torch.zeros((b, h, w), dtype=torch.uint8),
                torch.zeros((b, h // 2, w // 2), dtype=torch.uint8),
                torch.zeros((b, h // 2, w // 2), dtype=torch.uint8))

    with pytest.raises(ValueError):
        step(*planes(3, 32, 64), *qts)     # 3 frames over 4 data rows
    with pytest.raises(ValueError):
        step(*planes(4, 16, 64), *qts)     # 16 rows over 2 block columns


def test_streams_to_compressed_file_matches_jax(jax_mesh, tmp_path):
    h, w = 48, 64
    planes = _frame(h, w, seed=5)
    params = bytes([50, 50, 50])
    streams = tss.compress_frame_sharded(_mesh((8, 1)), planes, _qts(50))
    timg = tyuv.YUVImage.from_planes(tyuv.FourccFormats.IYUV, planes, w, h)
    got = tpipeline.streams_to_compressed(timg, params, streams)
    jimg = jyuv.YUVImage.from_planes(jyuv.FourccFormats.IYUV, planes, w, h)
    want = jpipeline.streams_to_compressed(
        jimg, params, jss.compress_frame_sharded(jax_mesh, planes,
                                                 _qts(50)))
    single = tpipeline.compress_dct(timg, params, device="cpu")
    paths = [tmp_path / f"{k}.myyuv" for k in ("port", "jax", "single")]
    for img, p in zip((got, want, single), paths):
        img.dump(p)
    assert paths[0].read_bytes() == paths[1].read_bytes() \
        == paths[2].read_bytes()


def test_sharded_decompress_rejects_bad_streams():
    h, w = 32, 64
    mesh = _mesh((4, 2))
    qts = _qts(50)
    streams = tss.compress_frame_sharded(mesh, _frame(h, w), qts)
    short = [streams[0], (streams[1][0][:-1], streams[1][1]), streams[2]]
    with pytest.raises(ValueError):
        tss.decompress_frame_sharded(mesh, short, qts, h, w)
    cut = [streams[0], (streams[1][0], streams[1][1][:-1]), streams[2]]
    with pytest.raises(BitstreamError):
        tss.decompress_frame_sharded(mesh, cut, qts, h, w)
    sizes = streams[0][0].copy()
    sizes[5] = 2                               # a chunk under 3 bytes
    bad = [(sizes, streams[0][1]), streams[1], streams[2]]
    with pytest.raises(BitstreamError):
        tss.decompress_frame_sharded(mesh, bad, qts, h, w)
    with pytest.raises(ValueError):
        tss.compress_frame_sharded(mesh, _frame(40, 64), qts)


def test_zero_block_chunk_matches_jax():
    np.testing.assert_array_equal(tss.zero_block_chunk(),
                                  jss._zero_block_chunk())


def test_make_mesh(monkeypatch):
    m = meshlib.make_mesh((2, 4), ["cpu"] * 8)
    assert m.axis_names == (meshlib.DATA_AXIS, meshlib.BLOCK_AXIS)
    assert m.shape == (2, 4) and m.size == 8
    assert m.flat == (torch.device("cpu"),) * 8
    assert meshlib.make_mesh(devices=["cpu"] * 3).shape == (3, 1)
    for shape in ((3, 5), (8, 0), (0, 8), (4, 4)):
        with pytest.raises(ValueError):
            meshlib.make_mesh(shape, ["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        meshlib.make_mesh()
    with pytest.raises(RuntimeError):
        meshlib.make_mesh((1, 1))


@pytest.mark.parametrize("n", [8, 6])
def test_dryrun_multichip_cpu(n):
    out = entry.dryrun_multichip(n, "cpu")
    assert out["mesh"] == {8: (4, 2), 6: (3, 2)}[n]
    assert out["q95_largest_chunk"] > 64
