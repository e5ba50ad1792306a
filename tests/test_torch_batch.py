"""The port's batched frame API (``engine/device_stream.py``) and RD
statistics step (``engine/batch.py``) against the JAX package on the CPU.

Tolerance: exact equality, except ``sse_*`` and
``entropy_bits_per_symbol`` of ``roundtrip_step``, held to rtol 1e-6: they
are float32 sums taken in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myyuv_tpu import native
from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import device_stream as jax_ds
from myyuv_tpu_torch.engine import batch, device_stream, pipeline

BATCHES = [(2, 32, 64, 50), (3, 48, 96, 90)]
# JAX's roundtrip_batch runs its encoder at the default 64-byte chunk tier
# with no retry, so it reports ok=False (and wrong pixels) once a chunk is
# longer: the q90 batch has such chunks, the q75 one does not
ROUNDTRIP_BATCHES = [(2, 32, 64, 50), (3, 48, 96, 75)]


@pytest.fixture(scope="module", autouse=True)
def _native():
    if not native.available():
        pytest.skip("native entropy library unavailable")


def _batch(rng, b, h, w):
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 200
    y = (base + rng.integers(0, 40, (b, h, w))).astype(np.uint8)
    u = rng.integers(90, 170, (b, h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (b, h // 2, w // 2)).astype(np.uint8)
    return y, u, v


def _jax_tables(q):
    return [np.asarray(t) for t in jax_batch.plane_qtables([q] * 3)]


@pytest.mark.parametrize("b,h,w,q", BATCHES)
def test_compress_batch_to_streams_matches_jax_and_frames(rng, b, h, w, q):
    planes = _batch(rng, b, h, w)
    dct, qt = pipeline.codec_params([q] * 3, "cpu")
    got = device_stream.compress_batch_to_streams(planes, qt, dct)
    want = jax_ds.compress_batch_to_streams(planes, _jax_tables(q))
    assert len(got) == b
    for f in range(b):
        frame = [p[f] for p in planes]
        one = device_stream.compress_frame_to_streams(frame, qt, dct)
        for (gs, gc), (ws, wc), (os_, oc) in zip(got[f], want[f], one):
            for s, c in ((ws, wc), (os_, oc)):
                np.testing.assert_array_equal(gs, s)
                np.testing.assert_array_equal(gc, c)


@pytest.mark.parametrize("b,h,w,q", ROUNDTRIP_BATCHES)
def test_roundtrip_batch_matches_jax(rng, b, h, w, q):
    planes = _batch(rng, b, h, w)
    dct, qt = pipeline.codec_params([q] * 3, "cpu")
    (ry, ru, rv), total, ok = device_stream.roundtrip_batch(
        *(torch.from_numpy(p) for p in planes), qt, dct)
    (jy, ju, jv), jtotal, jok = jax_ds.roundtrip_batch(
        *(jnp.asarray(p) for p in planes),
        [jnp.asarray(t) for t in _jax_tables(q)])
    assert bool(ok) and bool(jok) and int(total) == int(jtotal)
    for g, j in zip((ry, ru, rv), (jy, ju, jv)):
        assert g.shape == j.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_batch_streams_decode_with_decompress_batch(rng):
    b, h, w = 2, 32, 64
    planes = _batch(rng, b, h, w)
    dct, qt = pipeline.codec_params([75] * 3, "cpu")
    t = [torch.from_numpy(p) for p in planes]
    sizes, content = device_stream.compress_batch(*t, qt, dct)
    rec = device_stream.decompress_batch(content, sizes, qt, dct, b, h, w)
    (ry, ru, rv), total, _ = device_stream.roundtrip_batch(*t, qt, dct)
    assert int(sizes.sum()) == int(total) == content.numel()
    for g, r in zip(rec, (ry, ru, rv)):
        assert torch.equal(g, r)
    ry1, ru1, rv1, total1, ok1 = device_stream.roundtrip_frame(
        t[0][1].contiguous(), t[1][1].contiguous(), t[2][1].contiguous(),
        qt, dct)
    assert bool(ok1)
    for g, r in zip((ry1, ru1, rv1), (ry, ru, rv)):
        assert torch.equal(g, r[1])


@pytest.mark.parametrize("q", [1, 50, 100])
def test_roundtrip_step_matches_jax(rng, q):
    """[B, H, W] batch with all-0 and all-255 blocks in every plane: at
    q100 (table entries 1) their DC hits -1024 and 1016, the ends of what
    a DCT can produce."""
    b, h, w = 2, 32, 64
    y, u, v = _batch(rng, b, h, w)
    for p in (y, u, v):
        p[:, :8, :8] = 0
        p[:, :8, 8:16] = 255
    qts = batch.plane_qtables([q] * 3, "cpu")
    (ry, ru, rv), m = batch.roundtrip_step(
        *(torch.from_numpy(p) for p in (y, u, v)), *qts)
    (jy, ju, jv), jm = jax_batch.roundtrip_step_jit(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
        *jax_batch.plane_qtables([q] * 3))
    for g, j in zip((ry, ru, rv), (jy, ju, jv)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    np.testing.assert_array_equal(m["symbol_hist"].numpy(),
                                  np.asarray(jm["symbol_hist"]))
    assert m["symbol_hist"].dtype == torch.int32
    for k in ("sse_y", "sse_u", "sse_v", "entropy_bits_per_symbol"):
        assert m[k].dtype == torch.float32
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-6)
    if q == 100:
        cy = batch.encode_planes(*(torch.from_numpy(p) for p in (y, u, v)),
                                 *qts)[0]
        assert int(cy[0, 0, 0, 0]) == -1024 and int(cy[0, 1, 0, 0]) == 1016


def test_encode_and_decode_planes_match_jax(rng):
    y, u, v = _batch(rng, 3, 32, 64)
    qts = batch.plane_qtables([60, 70, 80], "cpu")
    jqts = jax_batch.plane_qtables([60, 70, 80])
    for g, j in zip(qts, jqts):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    got = batch.encode_planes(*(torch.from_numpy(p) for p in (y, u, v)),
                              *qts)
    want = jax_batch.encode_planes(jnp.asarray(y), jnp.asarray(u),
                                   jnp.asarray(v), *jqts)
    for g, j in zip(got, want):
        assert g.shape == j.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    rec = batch.decode_planes(*got, *qts, 32, 64)
    jrec = jax_batch.decode_planes(*want, *jqts, 32, 64)
    for g, j in zip(rec, jrec):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    frame = batch.encode_planes(*(torch.from_numpy(p[0]) for p in (y, u, v)),
                                *qts)
    for g, f in zip(frame, got):
        assert torch.equal(g, f[0])


def test_symbol_histogram_counts_the_alphabet_only():
    c = torch.tensor([[-1024, 1023, 0, 0, 5, -2000, 3000]], dtype=torch.int16)
    h = batch.symbol_histogram(c)
    assert h.shape == (batch.NUM_SYMBOLS,) and h.dtype == torch.int32
    assert h[0] == 1 and h[2047] == 1 and h[1024] == 2 and h[1029] == 1
    assert int(h.sum()) == 5


def test_batch_api_rejects_what_it_does_not_take():
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    y = torch.zeros((2, 32, 64), dtype=torch.uint8)
    u = torch.zeros((2, 16, 32), dtype=torch.uint8)
    ut = torch.zeros((2, 32, 16), dtype=torch.uint8).transpose(1, 2)
    for args in [(y, u[:1], u), (y, ut, u), (y, u, u[..., :16]),
                 (y.transpose(1, 2).contiguous().transpose(1, 2), u, u)]:
        with pytest.raises(ValueError):
            device_stream.compress_batch(*args, qt, dct)
        with pytest.raises(ValueError):
            device_stream.roundtrip_batch(*args, qt, dct)
    qts = batch.plane_qtables([50] * 3, "cpu")
    with pytest.raises(ValueError):
        batch.roundtrip_step(y, ut, u, *qts)


def test_batch_of_frames_off_16_rows_refused_like_jax(rng):
    """[2, 8, 16] frames: B*H = 16 would pass a one-frame check, but each
    frame's chroma blocks would straddle two frames. Every batch entry
    refuses it, as the JAX package's ``roundtrip_batch`` does."""
    y, u, v = _batch(rng, 2, 16, 32)
    y, u, v = y[:, :8, :16].copy(), u[:, :4, :8].copy(), v[:, :4, :8].copy()
    t = [torch.from_numpy(p) for p in (y, u, v)]
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    qts = batch.plane_qtables([50] * 3, "cpu")
    for call in (lambda: device_stream.compress_batch(*t, qt, dct),
                 lambda: device_stream.roundtrip_batch(*t, qt, dct),
                 lambda: device_stream.compress_batch_to_streams(
                     (y, u, v), qt, dct),
                 lambda: batch.encode_planes(*t, *qts),
                 lambda: batch.roundtrip_step(*t, *qts)):
        with pytest.raises(ValueError, match="multiples of 16"):
            call()
    with pytest.raises(TypeError):
        jax_ds.roundtrip_batch(*(jnp.asarray(p) for p in (y, u, v)),
                               [jnp.asarray(q) for q in _jax_tables(50)])
