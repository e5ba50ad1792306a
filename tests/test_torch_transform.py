"""The port's plain transforms (myyuv_tpu_torch.kernels.device) against the
JAX package's exact path (jitted on the CPU) and the scalar oracle.

Tolerance: exact equality everywhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import pipeline as jax_pipeline
from myyuv_tpu.kernels import constants as jax_constants
from myyuv_tpu.kernels import device as jax_device
from myyuv_tpu.kernels import scalar
from myyuv_tpu_torch.engine import pipeline
from myyuv_tpu_torch.kernels import device as kdev
from myyuv_tpu_torch.kernels import probe

QUALITIES = [1, 10, 50, 90, 100]
_jax_fwd = jax.jit(jax_device.dct_quantize)
_jax_inv = jax.jit(jax_device.dequantize_idct)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("plane", [0, 1])
def test_dct_quantize_matches_jax_and_scalar(rng, quality, plane):
    blocks = rng.integers(0, 256, (257, 8, 8), np.uint8)
    qt = scalar.plane_qtable(plane, quality)
    want = scalar.dct_quantize_blocks(blocks, qt)
    jax_got = np.asarray(_jax_fwd(jnp.asarray(blocks), jnp.asarray(qt)))
    got = kdev.dct_quantize(torch.from_numpy(blocks),
                            torch.from_numpy(qt)).numpy()
    np.testing.assert_array_equal(jax_got, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", QUALITIES)
def test_dequantize_idct_matches_jax_and_scalar(rng, quality):
    coeffs = rng.integers(-1024, 1024, (257, 8, 8)).astype(np.int16)
    qt = scalar.plane_qtable(0, quality)
    want = scalar.dequantize_idct_blocks(coeffs, qt)
    jax_got = np.asarray(_jax_inv(jnp.asarray(coeffs), jnp.asarray(qt)))
    got = kdev.dequantize_idct(torch.from_numpy(coeffs),
                               torch.from_numpy(qt)).numpy()
    np.testing.assert_array_equal(jax_got, want)
    np.testing.assert_array_equal(got, want)


def test_contraction_probe_content_exact():
    """Blocks whose FMA-contracted coefficients provably differ from the
    double-rounded ones (tools/check_tpu_bitexact.py:105-152 recipe)."""
    blocks = probe.contraction_probe_blocks()
    assert blocks.shape[0] > 0
    qt = scalar.plane_qtable(0, 50)
    want = scalar.dct_quantize_blocks(blocks, qt)
    assert (probe.fma_quantize(blocks, qt) != want).any(axis=(1, 2)).all()
    got = kdev.dct_quantize(torch.from_numpy(blocks),
                            torch.from_numpy(qt)).numpy()
    jax_got = np.asarray(_jax_fwd(jnp.asarray(blocks), jnp.asarray(qt)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax_got, want)
    rec_want = scalar.dequantize_idct_blocks(want, qt)
    rec = kdev.dequantize_idct(torch.from_numpy(want),
                               torch.from_numpy(qt)).numpy()
    np.testing.assert_array_equal(rec, rec_want)


def test_round_half_away_edge_cases():
    # 0.5 - 2^-25 rounds to 0 (the floor(x + 0.5) trap); halves go away
    xs = np.array([0.5 - 2.0 ** -25, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5,
                   0.0, -0.0, 100.49999, -100.5], np.float32)
    want = np.array([0, 1, -1, 2, -2, 3, -3, 0, 0, 100, -101], np.float32)
    got = kdev.round_half_away(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_plane_blocks_match_jax_layout(rng):
    plane = rng.integers(0, 256, (16, 48), np.uint8)
    blocks = kdev.plane_to_blocks(torch.from_numpy(plane)).numpy()
    np.testing.assert_array_equal(
        blocks, np.asarray(jax_device.plane_to_blocks(jnp.asarray(plane))))
    back = kdev.blocks_to_plane(torch.from_numpy(blocks), 16, 48).numpy()
    np.testing.assert_array_equal(back, plane)


def test_bgrx_to_iyuv_matches_jax_and_scalar(rng):
    px = rng.integers(0, 256, (48, 96, 4), np.uint8)
    want = scalar.bgrx_to_iyuv(px)
    jax_got = jax_device.bgrx_to_iyuv(jnp.asarray(px))
    got = kdev.bgrx_to_iyuv(torch.from_numpy(px))
    for g, j, w in zip(got, jax_got, want):
        np.testing.assert_array_equal(np.asarray(j), w)
        np.testing.assert_array_equal(g.numpy(), w)


def test_bgrx_to_iyuv_batch_matches_jax(rng):
    """A [B, H, W, 4] batch takes its 2x2 chroma quads on the last two
    pixel axes, as the JAX package's [..., H, W, 4] contract says; an odd
    H or W raises."""
    px = rng.integers(0, 256, (4, 8, 16, 4), np.uint8)
    got = kdev.bgrx_to_iyuv(torch.from_numpy(px))
    jax_got = jax_device.bgrx_to_iyuv(jnp.asarray(px))
    for g, j, shape in zip(got, jax_got, ((4, 8, 16), (4, 4, 8), (4, 4, 8))):
        assert tuple(g.shape) == shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    for f in range(4):
        for g, w in zip(got, scalar.bgrx_to_iyuv(px[f])):
            np.testing.assert_array_equal(g[f].numpy(), w)
    for shape in ((7, 9, 4), (3, 4, 4), (2, 4, 5, 4)):
        with pytest.raises(ValueError, match="even"):
            kdev.bgrx_to_iyuv(torch.zeros(shape, dtype=torch.uint8))


def test_iyuv_to_bgrx_matches_jax_and_scalar(rng):
    y = rng.integers(0, 256, (32, 64), np.uint8)
    u = rng.integers(0, 256, (16, 32), np.uint8)
    v = rng.integers(0, 256, (16, 32), np.uint8)
    want = scalar.iyuv_to_bgrx(y, u, v)
    jax_got = np.asarray(jax_device.iyuv_to_bgrx(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)))
    got = kdev.iyuv_to_bgrx(*(torch.from_numpy(p) for p in (y, u, v)))
    np.testing.assert_array_equal(jax_got, want)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quality", QUALITIES)
def test_codec_params_from_jax_bit_identical(quality):
    """The JAX package's weights, carried over, equal the port's own bit
    for bit."""
    q = np.array([quality] * 3)
    jax_tables = [np.asarray(t) for t in jax_pipeline._qtables(q)]
    batch_tables = [np.asarray(t) for t in jax_batch.plane_qtables(q)]
    dct_j, qt_j = pipeline.codec_params_from_jax(
        np.asarray(jax_constants.DCT_MATRIX8), jax_tables, "cpu")
    dct_b, qt_b = pipeline.codec_params_from_jax(
        np.asarray(jax_constants.DCT_MATRIX8), batch_tables, "cpu")
    dct, qt = pipeline.codec_params(q, "cpu")
    for a in (dct_j, dct_b):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy().view(np.uint32),
                              dct.numpy().view(np.uint32))
    for a in (qt_j, qt_b):
        assert a.dtype == torch.float32 and a.shape == (3, 8, 8)
        assert np.array_equal(a.numpy().view(np.uint32),
                              qt.numpy().view(np.uint32))


def test_library_path_follows_the_source_tree(tmp_path):
    """A kernel's library is named by the flags and by the contents of its
    source and of every header of its tree: a copy of ``csrc/`` maps to the
    same library, a copy with an edited header to another."""
    import shutil

    from myyuv_tpu_torch.kernels import build

    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    for name in build.SIGNATURES:
        assert build.library_path(name, copy) == build.library_path(name)
    hdr = copy / "block_huffman.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert (build.library_path("huffman_encode", copy)
            != build.library_path("huffman_encode"))
