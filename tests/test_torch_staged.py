"""The port's staged codec route against the JAX package on the CPU: the
plain versions of K3 (DCT + quantize), K4 (dequantize + IDCT), K5 (Huffman
encode) and K6 (Huffman decode), and the staged frame route composed
from their wrappers against the frame route and the JAX package's.

The Pallas kernels run in interpret mode at small sizes (<= 256 blocks,
``tile=32``). Tolerance: exact equality everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myyuv_tpu import native
from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import device_stream as jax_ds
from myyuv_tpu.entropy import pallas_decode8, pallas_encode8
from myyuv_tpu.kernels import pallas_dct, scalar
from myyuv_tpu_torch.engine import device_stream, pipeline
from myyuv_tpu_torch.entropy import decode, encode
from myyuv_tpu_torch.kernels import probe, transform
from test_torch_entropy import CORRUPT, _corrupt

QUALITIES = [1, 50, 90, 100]
I16 = np.iinfo(np.int16)


@pytest.fixture(scope="module", autouse=True)
def _native():
    if not native.available():
        pytest.skip("native entropy library unavailable")


def _planes(rng, h, w):
    """Textured Y with the contraction-probe blocks, flat-ish U, noisy V."""
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 200
    y = (base + rng.integers(0, 40, (h, w))).astype(np.uint8)
    y = probe.with_probe_blocks(y, probe.contraction_probe_blocks())
    u = rng.integers(90, 170, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    return y, u, v


def _params(q):
    dct, qt = pipeline.codec_params([q] * 3, "cpu")
    return dct, qt, [scalar.plane_qtable(i, q) for i in range(3)]


def _staged_streams(planes, qt, dct):
    """The staged compress route from the public wrappers: K3, K5, then
    the compaction and the split into plane streams."""
    lanes, sizes, err = encode.encode_blocks(transform.dct_quantize_blocks(
        *device_stream.to_device(planes, qt.device), qt, dct))
    assert not err.any()
    return device_stream.split_planes(
        device_stream.to_host(sizes),
        device_stream.to_host(device_stream.compact_chunks(lanes, sizes)),
        *planes[0].shape)


def _staged_planes(streams, qt, dct, h, w):
    """The staged decompress route from the public wrappers: K6, then
    K4."""
    content, sizes = device_stream.streams_to_device(streams, qt.device)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    coeffs, err = decode.decode_blocks(content, sizes, offsets)
    assert not err.any()
    return [device_stream.to_host(p) for p in
            transform.dequantize_idct_blocks(coeffs, qt, dct, h, w)]


@pytest.mark.parametrize("q", QUALITIES)
def test_plain_k3_matches_pallas_rows_and_scalar(rng, q):
    h, w = 32, 64
    planes = _planes(rng, h, w)
    dct, qt, qts = _params(q)
    got = transform.dct_quantize_blocks(
        *(torch.from_numpy(p) for p in planes), qt, dct).numpy()
    blocks = [scalar.plane_to_blocks(p) for p in planes]
    want = np.concatenate([scalar.dct_quantize_blocks(b, t).reshape(-1, 64)
                           for b, t in zip(blocks, qts)])
    pallas = np.concatenate([np.asarray(pallas_dct.dct_quantize_rows(
        jnp.asarray(b.reshape(-1, 64)), jnp.asarray(t), interpret=True))
        for b, t in zip(blocks, qts)])
    assert got.dtype == np.int16 and got.shape == (48, 64)
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", QUALITIES)
def test_plain_k4_matches_pallas_rows_and_scalar(rng, q):
    h, w = 32, 64
    dct, qt, qts = _params(q)
    coeffs = rng.integers(-1024, 1024, (48, 64)).astype(np.int16)
    got = transform.dequantize_idct_blocks(torch.from_numpy(coeffs), qt,
                                           dct, h, w)
    lo = 0
    for p, t, shape in zip(got, qts, ((h, w), (h // 2, w // 2),
                                      (h // 2, w // 2))):
        n = (shape[0] // 8) * (shape[1] // 8)
        c = coeffs[lo:lo + n]
        lo += n
        want = scalar.blocks_to_plane(
            scalar.dequantize_idct_blocks(c.reshape(-1, 8, 8), t), *shape)
        pallas = np.asarray(pallas_dct.dequantize_idct_rows(
            jnp.asarray(c), jnp.asarray(t), interpret=True))
        np.testing.assert_array_equal(
            scalar.blocks_to_plane(pallas.reshape(-1, 8, 8), *shape), want)
        np.testing.assert_array_equal(p.numpy(), want)


def _symbols(rng, n=64):
    """Coefficient rows in 11 bits: sparse random, the alphabet's ends,
    64 distinct symbols, small alphabets with many ties."""
    c = rng.integers(-1024, 1024, (n, 64))
    c = (c * (rng.random((n, 64)) < rng.random((n, 1)))).astype(np.int16)
    c[0] = 0
    c[1] = -1024
    c[2] = 1023
    c[3, ::2], c[3, 1::2] = -1024, 1023
    c[4] = np.arange(64) * 31 - 1000          # 64 distinct symbols
    c[5:20] = rng.integers(-3, 4, (15, 64))
    return c


def _k5_plain(coeffs):
    lanes, sizes, err = encode.encode_blocks(torch.from_numpy(coeffs))
    sizes = sizes.numpy()
    mask = np.arange(256)[None, :] < sizes[:, None]
    return sizes, lanes.numpy()[mask], err.numpy()


def test_plain_k5_matches_native_and_pallas_encoder(rng):
    coeffs = _symbols(rng)
    sizes, content, err = _k5_plain(coeffs)
    assert not err.any()
    want_sizes, want = native.encode_blocks(coeffs)
    np.testing.assert_array_equal(sizes, want_sizes.astype(np.int32))
    np.testing.assert_array_equal(content, want)
    lanes8, sizes8, ok8 = pallas_encode8.encode_lanes8(
        jnp.asarray(coeffs), interpret=True, tile=32)
    assert bool(np.all(np.asarray(ok8)))
    np.testing.assert_array_equal(np.asarray(sizes8), sizes)
    lanes8 = np.asarray(lanes8)
    mask = np.arange(256)[None, :] < sizes[:, None]
    np.testing.assert_array_equal(lanes8[mask], content)


def test_plain_k5_on_int16_extremes_matches_native(rng):
    """Coefficients no DCT produces: distinct symbols are the full int16
    values, stored as their low 11 bits (native's & 0x7FF). Even 64
    distinct symbols stay far below the 255-byte chunk limit, so no int16
    input sets ``err``."""
    c = rng.integers(I16.min, I16.max + 1, (40, 64)).astype(np.int16)
    c[0] = I16.max
    c[1] = I16.min
    c[2, :4] = [I16.max, I16.min, -4096, 4096]
    c[3] = np.arange(64) * 1021 - 32000       # 64 distinct, aliasing mod 2048
    c[4, ::2], c[4, 1::2] = I16.min, I16.max
    c[5, :3] = [2048 + 5, 5, -2048 + 5]       # three symbols, one 11-bit code
    sizes, content, err = _k5_plain(c)
    want_sizes, want = native.encode_blocks(c)
    np.testing.assert_array_equal(sizes, want_sizes.astype(np.int32))
    np.testing.assert_array_equal(content, want)
    assert not err.any() and sizes.max() <= 255


def _tree_group_lengths(lane):
    """The code length of each tree group of one chunk, in stored order."""
    pos, lens = 3, []
    while pos - 3 < lane[2]:
        info = int(lane[pos])
        lens.append((info >> 5) + 1)
        pos += 1 + (((info & 31) + 1) * 11 + 7) // 8
    return lens


@pytest.mark.parametrize("family", probe.ENCODER_FAMILIES)
def test_plain_k5_matches_native_on_encoder_families(rng, family):
    """The block families that stress K1's and K5's lane-group encoder
    (``probe.encoder_families``): the plain encoder's bytes equal
    native's, and each family has the shape it claims."""
    families = probe.encoder_families(rng)
    assert tuple(families) == probe.ENCODER_FAMILIES
    c = families[family]
    sizes, content, err = _k5_plain(c)
    want_sizes, want = native.encode_blocks(c)
    np.testing.assert_array_equal(sizes, want_sizes.astype(np.int32))
    np.testing.assert_array_equal(content, want)
    assert not err.any()
    if family.startswith("n_sym_"):
        for row in c:
            assert np.unique(row).size == int(family[6:])
    if family in ("long_run", "n_sym_64"):  # one length, two tree groups
        lanes = encode.encode_blocks(torch.from_numpy(c))[0].numpy()
        for lane in lanes:
            lens = _tree_group_lengths(lane)
            assert any(a == b for a, b in zip(lens, lens[1:])), lens


def _k6_plain(sizes, content, offsets=None):
    s = torch.from_numpy(np.asarray(sizes, np.int32))
    if offsets is None:
        offsets = torch.cumsum(s, 0, dtype=torch.int64) - s
    coeffs, err = decode.decode_blocks(torch.from_numpy(content), s, offsets)
    return coeffs.numpy(), err.numpy()


def test_plain_k6_matches_native_and_pallas_decoder(rng):
    coeffs_in = _symbols(rng)
    sizes, content = native.encode_blocks(coeffs_in)
    coeffs, err = _k6_plain(sizes, content)
    assert not err.any() and coeffs.dtype == np.int16
    np.testing.assert_array_equal(coeffs,
                                  native.decode_blocks(sizes, content))
    np.testing.assert_array_equal(coeffs, coeffs_in)
    lanes, _, _ = encode.encode_blocks(torch.from_numpy(coeffs))
    got8, ok8 = pallas_decode8.decode_lanes8(jnp.asarray(lanes.numpy()),
                                             interpret=True, tile=32)
    assert bool(np.all(np.asarray(ok8)))
    np.testing.assert_array_equal(np.asarray(got8), coeffs)


@pytest.mark.parametrize("kind", sorted(CORRUPT))
def test_plain_k6_codes_equal_k2_on_corrupt_chunks(rng, kind):
    """A 32x64 frame's stream with one corrupt chunk, one chunk running off
    the end of the content and one wholly outside it: K6's codes equal
    K2's, and a bad block's coefficients are 0."""
    h, w = 32, 64
    dct, qt, _ = _params(50)
    streams = device_stream.compress_frame_to_streams(_planes(rng, h, w),
                                                      qt, dct)
    sizes = np.concatenate([s for s, _ in streams]).astype(np.int32)
    offs = np.cumsum(sizes.astype(np.int64)) - sizes
    content = np.concatenate([c for _, c in streams])
    chunks = [content[o:o + s] for o, s in zip(offs, sizes)]
    chunks[3] = _corrupt(kind, rng)
    sizes[3] = chunks[3].size
    content = np.concatenate(chunks)
    s = torch.from_numpy(sizes)
    offsets = torch.cumsum(s, 0, dtype=torch.int64) - s
    offsets[40] = content.size - 2
    offsets[41] = content.size + 100
    coeffs, err = _k6_plain(sizes, content, offsets)
    k2 = decode.decode_idct_blocks(torch.from_numpy(content), s, offsets,
                                   qt, dct, h, w)
    np.testing.assert_array_equal(err, k2[3].numpy())
    assert err[3] == CORRUPT[kind] and np.count_nonzero(err[:40]) == 1
    assert not coeffs[err != 0].any()


@pytest.mark.parametrize("h,w,q", [(32, 64, 50), (48, 96, 90)])
def test_staged_compress_equals_fused_and_jax(rng, h, w, q):
    planes = _planes(rng, h, w)
    dct, qt, qts = _params(q)
    staged = _staged_streams(planes, qt, dct)
    fused = device_stream.compress_frame_to_streams(planes, qt, dct)
    want = jax_ds.compress_frame_to_streams(
        planes, [np.asarray(t) for t in jax_batch.plane_qtables([q] * 3)])
    for (gs, gc), (fs, fc), (ws, wc) in zip(staged, fused, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(fs, ws)
        np.testing.assert_array_equal(fc, wc)


@pytest.mark.parametrize("h,w,q", [(32, 64, 50), (48, 96, 90)])
def test_staged_decompress_equals_fused_and_jax(rng, h, w, q):
    planes = _planes(rng, h, w)
    dct, qt, qts = _params(q)
    streams = device_stream.compress_frame_to_streams(planes, qt, dct)
    staged = _staged_planes(streams, qt, dct, h, w)
    fused = device_stream.decompress_streams_to_frame(streams, qt, dct, h, w)
    want = jax_ds.decompress_streams_to_frame(
        streams, [np.asarray(t) for t in jax_batch.plane_qtables([q] * 3)],
        h, w, fused=False)
    for g, f, j, p, t in zip(staged, fused, want, planes, qts):
        rec = scalar.blocks_to_plane(scalar.dequantize_idct_blocks(
            scalar.dct_quantize_blocks(scalar.plane_to_blocks(p), t), t),
            *p.shape)
        np.testing.assert_array_equal(np.asarray(j), rec)
        np.testing.assert_array_equal(g, rec)
        np.testing.assert_array_equal(f, rec)


def test_staged_wrappers_reject_what_the_kernels_do_not_take():
    dct, qt, _ = _params(50)
    y = torch.zeros((16, 32), dtype=torch.uint8)
    u = torch.zeros((8, 16), dtype=torch.uint8)
    for args in [(y.to(torch.int32), u, u, qt, dct),
                 (y[:, :16], u, u, qt, dct),
                 (torch.zeros((32, 16), dtype=torch.uint8).t(), u, u, qt,
                  dct),
                 (y.to("meta"), u.to("meta"), u.to("meta"), qt.to("meta"),
                  dct.to("meta"))]:
        with pytest.raises(ValueError):
            transform.dct_quantize_blocks(*args)
    n = 8 + 2 * 2
    coeffs = torch.zeros((n, 64), dtype=torch.int16)
    # contiguous, but 2 bytes off the 16-byte boundary the kernels load on
    shifted = torch.zeros(n * 64 + 1, dtype=torch.int16)[1:].view(n, 64)
    for args in [(coeffs, qt, dct, 16, 24),
                 (coeffs[:-1], qt, dct, 16, 32),
                 (coeffs.to(torch.int32), qt, dct, 16, 32),
                 (coeffs.t().contiguous().t(), qt, dct, 16, 32),
                 (shifted, qt, dct, 16, 32)]:
        with pytest.raises(ValueError):
            transform.dequantize_idct_blocks(*args)
    for bad in (coeffs.to(torch.int32), coeffs.reshape(-1, 32, 2)[..., 0],
                coeffs.reshape(n, 8, 8), coeffs.to("meta"), shifted):
        with pytest.raises(ValueError):
            encode.encode_blocks(bad)
    sizes = torch.full((n,), 3, dtype=torch.int32)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    content = torch.zeros(3 * n, dtype=torch.uint8)
    for args in [(content, sizes.to(torch.int64), offsets),
                 (content, sizes, offsets[:-1]),
                 (content, sizes, offsets.to(torch.int32)),
                 (content.to("meta"), sizes.to("meta"), offsets.to("meta"))]:
        with pytest.raises(ValueError):
            decode.decode_blocks(*args)
