"""``precision="fast"`` in the port against the JAX package's fast path on
the CPU: the plain versions of F1 (``transform.fast_dct_quantize_blocks``)
and F2 (``fast_dequantize_idct_blocks``) against
``myyuv_tpu.kernels.device.dct_quantize`` / ``dequantize_idct`` with
``precision="fast"``, and the entry points that take ``precision`` against
their JAX counterparts.

The port's fast transforms are float32 FMA chains over k ascending (the
kernels' ``__fmaf_rn``; on the CPU ``kernels/device.py::_fma``, which
rounds once, as ``test_fma_emulation_rounds_once`` checks).

Tolerances. No two float32 formulations of the 8x8 products round alike
everywhere: the JAX package's einsums, the port's FMA chains and the exact
sequential chains differ where a value lies within a few ulps of a
rounding tie. Measured on 20,000 uniform-noise blocks (luma table, JAX
0.9.0 on the CPU), fast differed from exact in 2.3e-5 (q10), 8.4e-5 (q50)
and 3.6e-4 (q90) of the coefficients and in under 1e-5 of the pixels, by
1 at most. So: coefficients within +-1, in at most COEF_SHARE of them;
pixels within +-1, in at most PIXEL_SHARE; PSNR within PSNR_DB. With
``precision="exact"`` everything is byte for byte what the call without
the argument gives."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myyuv_tpu import native
from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import device_stream as jax_ds
from myyuv_tpu.engine import pipeline as jax_pipeline
from myyuv_tpu.engine import sweep as jax_sweep
from myyuv_tpu.formats import yuv as jax_yuv
from myyuv_tpu.kernels import device as jax_kdev
from myyuv_tpu_torch.engine import (batch, device_stream, pipeline,
                                    sharded_stream, streaming, sweep)
from myyuv_tpu_torch.entropy import decode
from myyuv_tpu_torch.formats import yuv
from myyuv_tpu_torch.kernels import build, transform
from myyuv_tpu_torch.kernels import device as kdev
from myyuv_tpu_torch.parallel import mesh as meshlib

QUALITIES = (10, 50, 90)
COEF_SHARE = 1e-3
PIXEL_SHARE = 1e-4
PSNR_DB = 0.05


@pytest.fixture(scope="module", autouse=True)
def _native():
    if not native.available():
        pytest.skip("native entropy library unavailable")


def _within(got, want, share: float) -> float:
    """Assert |got - want| <= 1 everywhere and differing in at most
    ``share`` of the values; return the share."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1
    frac = float((d != 0).mean())
    assert frac <= share, frac
    return frac


def test_fma_emulation_rounds_once():
    """``_fma`` gives a * b + c rounded once to float32: against exact
    rational arithmetic on random triples and on triples whose sum lies
    just off a float32 tie, where rounding to float64 first and then to
    float32 rounds twice and misses."""
    from fractions import Fraction
    rng = np.random.default_rng(4)
    n = 500
    a, b, c = ((rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n))
               .astype(np.float32) for _ in range(3))
    e = np.float32(2.0 ** -23)
    near_tie = [(np.float32(0.25) * (1 + e), np.float32(0.25) * (1 - e),
                 np.float32(2.0 ** 20 + 0.125))]
    near_tie += [(-x, y, -z) for x, y, z in near_tie]
    a, b, c = (np.concatenate([v, np.array([t[i] for t in near_tie],
                                           np.float32)])
               for i, v in enumerate((a, b, c)))
    got = kdev._fma(*(torch.from_numpy(v) for v in (c, a, b))).numpy()

    def rounded(x: Fraction) -> np.float32:
        f = np.float32(float(x))
        near = [np.nextafter(f, np.float32(-np.inf)), f,
                np.nextafter(f, np.float32(np.inf))]
        return min(near, key=lambda v: (abs(Fraction(float(v)) - x),
                                        int(v.view(np.int32)) & 1))

    want = np.array([rounded(Fraction(float(x)) * Fraction(float(y))
                             + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice[n:] != want[n:]).all()


def _noise_planes(seed, h, w):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s).astype(np.uint8)
            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


def _smooth_planes(seed, h, w):
    """A gradient with texture in Y, flat-ish U, noisy V."""
    rng = np.random.default_rng(seed)
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 200
    y = (base + rng.integers(0, 40, (h, w))).astype(np.uint8)
    u = rng.integers(90, 170, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return [y, u, v]


def _jax_tables(q):
    return [np.asarray(t) for t in jax_batch.plane_qtables([q] * 3)]


def _jax_plane_coeffs(planes, q):
    """JAX's fast forward transform, plane by plane -> [N, 64] int16."""
    return np.concatenate([np.asarray(jax_kdev.dct_quantize(
        jax_kdev.plane_to_blocks(jnp.asarray(p)), jnp.asarray(t),
        precision="fast")).reshape(-1, 64)
        for p, t in zip(planes, _jax_tables(q))])


@pytest.mark.parametrize("q", QUALITIES)
def test_plain_f1_and_f2_match_jax_fast(q):
    """(a) F1's plain version against JAX's fast ``dct_quantize`` on 6,144
    noise blocks (a 512x512 frame: 4,096 luma, 2,048 chroma); (b) F2's
    plain version against JAX's fast ``dequantize_idct`` on the same
    coefficients."""
    h = w = 512
    planes = _noise_planes(q, h, w)
    dct, qt = pipeline.codec_params([q] * 3, "cpu")
    got = transform.fast_dct_quantize_blocks_plain(
        *(torch.from_numpy(p) for p in planes), qt, dct)
    want = _jax_plane_coeffs(planes, q)
    assert got.dtype == torch.int16 and got.shape == want.shape == (6144, 64)
    c_share = _within(got.numpy(), want, COEF_SHARE)
    pixels = transform.fast_dequantize_idct_blocks_plain(
        torch.from_numpy(want), qt, dct, h, w)
    counts = kdev.plane_block_counts(h, w)
    lo = 0
    p_share = []
    for p, n, t, shape in zip(pixels, counts, _jax_tables(q),
                              ((h, w), (h // 2, w // 2), (h // 2, w // 2))):
        jpx = jax_kdev.blocks_to_plane(jax_kdev.dequantize_idct(
            jnp.asarray(want[lo:lo + n].reshape(-1, 8, 8)), jnp.asarray(t),
            precision="fast"), *shape)
        assert p.dtype == torch.uint8 and p.shape == shape
        p_share.append(_within(p.numpy(), np.asarray(jpx), PIXEL_SHARE))
        lo += n
    print(f"q{q}: F1 plain vs JAX fast, {c_share:.3g} of the coefficients "
          f"differ; F2 plain vs JAX fast, {max(p_share):.3g} of a plane's "
          f"pixels")


@pytest.mark.parametrize("q", QUALITIES)
def test_fast_within_one_of_exact(q):
    """(c) The port's fast transforms against its exact ones, as the JAX
    package's ``test_fast_precision_close`` holds its fast path."""
    h, w = 128, 128
    planes = [torch.from_numpy(p) for p in _noise_planes(100 + q, h, w)]
    dct, qt = pipeline.codec_params([q] * 3, "cpu")
    exact = transform.dct_quantize_blocks(*planes, qt, dct)
    fast = transform.dct_quantize_blocks(*planes, qt, dct, "fast")
    _within(fast.numpy(), exact.numpy(), COEF_SHARE)
    for f, e in zip(transform.dequantize_idct_blocks(exact, qt, dct, h, w,
                                                     "fast"),
                    transform.dequantize_idct_blocks(exact, qt, dct, h, w)):
        _within(f.numpy(), e.numpy(), PIXEL_SHARE)
    blocks = planes[0].reshape(16, 8, 16, 8).transpose(1, 2).reshape(-1, 8,
                                                                     8)
    _within(kdev.dct_quantize(blocks, qt[0], precision="fast").numpy(),
            kdev.dct_quantize(blocks, qt[0]).numpy(), COEF_SHARE)


def test_fast_wrappers_run_the_plain_versions_on_the_cpu_only():
    """On CPU tensors F1's and F2's wrappers run their plain versions and
    launch nothing; on any other device but CUDA they raise."""
    h, w = 32, 32
    planes = [torch.from_numpy(p) for p in _noise_planes(3, h, w)]
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    before = dict(build.launches)
    coeffs = transform.fast_dct_quantize_blocks(*planes, qt, dct)
    assert torch.equal(coeffs, transform.fast_dct_quantize_blocks_plain(
        *planes, qt, dct))
    for g, p in zip(transform.fast_dequantize_idct_blocks(coeffs, qt, dct,
                                                          h, w),
                    transform.fast_dequantize_idct_blocks_plain(
                        coeffs, qt, dct, h, w)):
        assert torch.equal(g, p)
    assert build.launches == before
    meta = [p.to("meta") for p in planes]
    with pytest.raises(ValueError, match="fast_dct_quantize"):
        transform.fast_dct_quantize_blocks(*meta, qt.to("meta"),
                                           dct.to("meta"))


def _stream_coeffs(streams):
    """Per-plane (sizes, content) -> [N, 64] coefficients by the port's
    exact plain Huffman decoder."""
    content, sizes = device_stream.streams_to_device(streams,
                                                     torch.device("cpu"))
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    coeffs, err = decode.decode_blocks(content, sizes, offsets)
    assert not err.any()
    return coeffs.numpy()


def _file_coeffs(img) -> np.ndarray:
    """A compressed image's coefficients, decoded by the plain coder."""
    streams, _, _ = pipeline._dct_streams(img, "cpu")
    return _stream_coeffs(streams)


@pytest.mark.parametrize("q", [50, 90])
def test_frame_streams_and_planes_match_jax_fast(q):
    """(d) 64x48 frame: the port's fast streams decode to coefficients
    within +-1 of JAX's fast streams'; the port's fast decode of JAX's
    streams gives pixels within +-1 of JAX's fast decode."""
    h, w = 48, 64
    planes = _noise_planes(7 + q, h, w)
    dct, qt = pipeline.codec_params([q] * 3, "cpu")
    got = device_stream.compress_frame_to_streams(planes, qt, dct,
                                                  precision="fast")
    want = jax_ds.compress_frame_to_streams(planes, _jax_tables(q),
                                            precision="fast")
    _within(_stream_coeffs(got), _stream_coeffs(want), COEF_SHARE)
    rec = device_stream.decompress_streams_to_frame(want, qt, dct, h, w,
                                                    precision="fast")
    jrec = jax_ds.decompress_streams_to_frame(want, _jax_tables(q), h, w,
                                              precision="fast")
    for g, j in zip(rec, jrec):
        _within(g, np.asarray(j), PIXEL_SHARE)


def test_fast_file_decodes_with_both_precisions():
    """(e) ``compress_dct`` -> ``decompress_dct`` of a fast file: an
    ordinary DCT file, which the port decodes exactly as the JAX package
    does and, fast, within +-1 of that."""
    h, w = 48, 64
    planes = _smooth_planes(5, h, w)
    img = yuv.YUVImage.from_planes(yuv.FourccFormats.IYUV, planes, w, h)
    params = bytes([50, 60, 70])
    comp = pipeline.compress_dct(img, params, device="cpu", precision="fast")
    exact_file = pipeline.compress_dct(img, params, device="cpu")
    a, b = (_file_coeffs(c) for c in (comp, exact_file))
    _within(a, b, COEF_SHARE)
    exact = pipeline.decompress_dct(comp, device="cpu")
    fast = pipeline.decompress_dct(comp, device="cpu", precision="fast")
    jcomp = jax_yuv.YUVImage.from_bytes(comp.to_bytes())
    assert exact.to_bytes() == jax_pipeline.decompress_dct(
        jcomp, entropy_backend="device").to_bytes()
    jfast = jax_pipeline.decompress_dct(jcomp, precision="fast")
    for f, e, j in zip(fast.planes(), exact.planes(), jfast.planes()):
        _within(f, e, PIXEL_SHARE)
        _within(f, j, PIXEL_SHARE)


@pytest.mark.parametrize("q", [10, 90])
def test_roundtrip_step_matches_jax_fast(q):
    """(f) ``roundtrip_step`` with precision="fast" against JAX's: PSNR
    within PSNR_DB, and the symbol histograms apart by no more than
    COEF_SHARE of the coefficients moving one bin. The planes are not held
    pixel by pixel: a coefficient off by 1 moves its whole block by up to
    a quarter of its table entry (20 at q10)."""
    b, h, w = 2, 32, 64
    y, u, v = (np.stack(x) for x in zip(*[_noise_planes(30 + i, h, w)
                                           for i in range(b)]))
    qts = batch.plane_qtables([q] * 3, "cpu")
    (ry, ru, rv), m = batch.roundtrip_step(
        *(torch.from_numpy(p) for p in (y, u, v)), *qts, precision="fast")
    (jy, ju, jv), jm = jax_batch.roundtrip_step_jit(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
        *jax_batch.plane_qtables([q] * 3), precision="fast")
    for g, p, k in zip((ry, ru, rv), (y, u, v), ("sse_y", "sse_u", "sse_v")):
        assert g.shape == p.shape and g.dtype == torch.uint8
        psnr = [10 * np.log10(255.0 ** 2 * p.size / float(s))
                for s in (m[k], jm[k])]
        assert abs(psnr[0] - psnr[1]) <= PSNR_DB, (k, psnr)
    hist, jhist = m["symbol_hist"].numpy(), np.asarray(jm["symbol_hist"])
    moved = np.abs(hist.astype(np.int64) - jhist).sum() // 2
    assert hist.sum() == jhist.sum()
    assert moved <= COEF_SHARE * hist.sum(), moved


@pytest.mark.parametrize("backend", [None, "device"])
def test_quality_sweep_matches_jax_fast(backend):
    """(f) ``quality_sweep(precision="fast")`` against JAX's: the same
    keys and qualities, PSNR within PSNR_DB."""
    planes = _smooth_planes(9, 32, 64)
    got = sweep.quality_sweep(planes, (10, 90), backend, device="cpu",
                              precision="fast")
    want = jax_sweep.quality_sweep(planes, (10, 90), entropy_backend=backend,
                                   precision="fast")
    for g, j in zip(got, want):
        assert g.keys() == j.keys() and g["quality"] == j["quality"]
        for k in ("psnr_y_db", "psnr_u_db", "psnr_v_db"):
            assert abs(g[k] - j[k]) <= PSNR_DB, (k, g[k], j[k])


def _tiny():
    h, w = 32, 32
    planes = _noise_planes(1, h, w)
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    t = [torch.from_numpy(p) for p in planes]
    streams = device_stream.compress_frame_to_streams(planes, qt, dct)
    content, sizes = device_stream.streams_to_device(streams,
                                                     torch.device("cpu"))
    return h, w, planes, t, dct, qt, streams, content, sizes


def _entry_calls(precision):
    """Every entry point of the port that takes ``precision``, called at
    32x32 with it (None: without the argument); each returns something
    comparable."""
    h, w, planes, t, dct, qt, streams, content, sizes = _tiny()
    img = yuv.YUVImage.from_planes(yuv.FourccFormats.IYUV, planes, w, h)
    comp = pipeline.compress_dct(img, bytes([50] * 3), device="cpu")
    stack = [p[None] for p in t]
    mesh = meshlib.make_mesh((1, 2), ["cpu", "cpu"])
    qts = list(qt.numpy())
    coeffs = transform.dct_quantize_blocks(*t, qt, dct)
    p = {} if precision is None else {"precision": precision}
    px = torch.from_numpy(np.full((h, w, 4), 90, np.uint8))
    return {
        "kdev.dct_quantize": lambda: kdev.dct_quantize(
            kdev.plane_to_blocks(t[0]), qt[0], **p),
        "kdev.dequantize_idct": lambda: kdev.dequantize_idct(
            coeffs.reshape(-1, 8, 8)[:16], qt[0], **p),
        "dct_quantize_blocks": lambda: transform.dct_quantize_blocks(
            *t, qt, dct, **p),
        "dequantize_idct_blocks": lambda: transform.dequantize_idct_blocks(
            coeffs, qt, dct, h, w, **p),
        "compress_frame": lambda: device_stream.compress_frame(
            *t, qt, dct, **p),
        "decompress_frame": lambda: device_stream.decompress_frame(
            content, sizes, qt, dct, h, w, **p),
        "compress_frame_to_streams":
            lambda: device_stream.compress_frame_to_streams(
                planes, qt, dct, **p),
        "decompress_streams_to_frame":
            lambda: device_stream.decompress_streams_to_frame(
                streams, qt, dct, h, w, **p),
        "compress_batch": lambda: device_stream.compress_batch(
            *stack, qt, dct, **p),
        "decompress_batch": lambda: device_stream.decompress_batch(
            content, sizes, qt, dct, 1, h, w, **p),
        "roundtrip_frame": lambda: device_stream.roundtrip_frame(
            *t, qt, dct, **p),
        "roundtrip_scan": lambda: device_stream.roundtrip_scan(
            *stack, qt, dct, **p),
        "roundtrip_batch": lambda: device_stream.roundtrip_batch(
            *stack, qt, dct, **p),
        "compress_batch_to_streams":
            lambda: device_stream.compress_batch_to_streams(
                [x[None] for x in planes], qt, dct, **p),
        "compress_dct": lambda: pipeline.compress_dct(
            img, bytes([50] * 3), device="cpu", **p).to_bytes(),
        "decompress_dct": lambda: pipeline.decompress_dct(
            comp, device="cpu", **p).to_bytes(),
        "encode_planes": lambda: batch.encode_planes(*t, *qt, dct, **p),
        "decode_planes": lambda: batch.decode_planes(
            *(c.reshape(-1, 8, 8) for c in coeffs.split(
                kdev.plane_block_counts(h, w))), *qt, h, w, dct, **p),
        "roundtrip_step": lambda: batch.roundtrip_step(*stack, *qt, dct,
                                                       **p),
        "make_sharded_roundtrip": lambda: batch.make_sharded_roundtrip(
            mesh, **p)(*stack, *qt, dct),
        "roundtrip_stream": lambda: streaming.roundtrip_stream(
            [t], qt, dct, **p)[:2],
        "ingest_stream": lambda: streaming.ingest_stream(
            [px], qt, dct, **p)[:2],
        "preview_stream": lambda: streaming.preview_stream(
            (content, sizes), qt, dct, h, w, 2, **p)[:1],
        "roundtrip_scan_stream": lambda: streaming.roundtrip_scan_stream(
            [stack], qt, dct, **p)[:2],
        "sustained_roundtrip_fps": lambda: streaming.sustained_roundtrip_fps(
            planes, qt, dct, 2, 1, **p)[1:3],
        "sustained_scan_fps": lambda: streaming.sustained_scan_fps(
            planes, qt, dct, 2, 2, **p)[1:],
        "sustained_pipeline_fps": lambda: streaming.sustained_pipeline_fps(
            planes, qt, dct, 2, **p)[2:],
        "compress_stream": lambda: list(streaming.compress_stream(
            [t], qt, dct, **p)),
        "quality_sweep": lambda: sweep.quality_sweep(
            planes, (50,), None, device="cpu", **p),
        "compress_frame_sharded":
            lambda: sharded_stream.compress_frame_sharded(mesh, planes, qts,
                                                          **p),
        "decompress_frame_sharded":
            lambda: sharded_stream.decompress_frame_sharded(
                mesh, streams, qts, h, w, **p),
        "compress_batch_sharded":
            lambda: sharded_stream.compress_batch_sharded(
                mesh, [x[None] for x in planes], qts, **p),
    }


ENTRIES = sorted(_entry_calls("exact"))


def _flat(x):
    """Nested tuples, lists and dicts of tensors, arrays and scalars ->
    a list of numpy arrays and plain values."""
    if isinstance(x, dict):
        return sorted(x) + _flat([x[k] for k in sorted(x)])
    if isinstance(x, (list, tuple)):
        return [a for item in x for a in _flat(item)]
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    return [np.asarray(x)]


@pytest.mark.parametrize("entry", ENTRIES)
def test_unknown_precision_raises(entry):
    """(g) Only "exact" and "fast": any other value raises ValueError (the
    JAX package reads every string but "exact" as fast)."""
    with pytest.raises(ValueError, match="precision"):
        _flat(_entry_calls("highest")[entry]())


@pytest.mark.parametrize("entry", ENTRIES)
def test_exact_precision_is_the_default(entry):
    """(h) precision="exact" gives exactly what the call without the
    argument gives; "fast" runs on the same inputs."""
    got = _flat(_entry_calls("exact")[entry]())
    want = _flat(_entry_calls(None)[entry]())
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)
    _flat(_entry_calls("fast")[entry]())
