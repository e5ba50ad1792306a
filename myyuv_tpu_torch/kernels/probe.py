"""Adversarial content for holding the kernels against their plain versions.

* ``contraction_probe_blocks``: the recipe of the production-kernel
  contraction probe in ``tools/check_tpu_bitexact.py`` (:105-152) — random
  8x8 blocks whose quantized coefficients differ between the reference's
  double-rounded chains (a multiply, then an add, each rounded) and the
  same chains with every step fused into one FMA, emulated in float64. A
  kernel whose compiler contracted the DCT chains disagrees with the plain
  version on these blocks.
* ``content_kind``: the plane content kinds of ``tools/fuzz_tpu_frame.py``
  (:35): noise, gradient, flat, impulse, banded.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import DCT_MATRIX8, PLANE_Q50, quality_scaled_qtable
from .device import blocks_to_plane, dct_quantize, plane_to_blocks

KINDS = ("noise", "gradient", "flat", "impulse", "banded")


def fma_quantize(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """[n, 8, 8] u8 -> int16 coefficients with every chain step fused."""
    c = DCT_MATRIX8
    x = blocks.astype(np.float32) - np.float32(128)

    def fma_mm(a, b):  # acc = fma(a_k, b_k, acc): one rounding per step
        acc = np.float32(np.float64(a[:, 0:1]) * np.float64(b[:, 0:1, :]))
        for k in range(1, 8):
            acc = np.float32(np.float64(a[:, k:k + 1])
                             * np.float64(b[:, k:k + 1, :])
                             + np.float64(acc))
        return acc

    t = fma_mm(c, x)
    coef = np.transpose(fma_mm(c, np.transpose(t, (0, 2, 1))), (0, 2, 1))
    qv = np.float32(coef / qtable[None])
    r = np.trunc(qv)
    bump = np.where(np.abs(qv - r) >= np.float32(0.5), np.sign(qv), 0)
    return (r + bump).astype(np.int16)


def contraction_probe_blocks(limit: int = 1024, seed: int = 11
                             ) -> np.ndarray:
    """Up to ``limit`` u8 [8, 8] blocks whose exact luma q50 coefficients
    differ from the contracted ones."""
    qt = quality_scaled_qtable(PLANE_Q50[0], 50)
    rng = np.random.default_rng(seed)
    for _ in range(8):
        cand = rng.integers(0, 256, (8192, 8, 8), np.uint8)
        exact = dct_quantize(torch.from_numpy(cand),
                             torch.from_numpy(qt)).numpy()
        diff = (exact != fma_quantize(cand, qt)).any(axis=(1, 2))
        if diff.any():
            return cand[diff][:limit]
    return np.zeros((0, 8, 8), np.uint8)


def with_probe_blocks(plane: np.ndarray, blocks: np.ndarray,
                      limit: int = 1024) -> np.ndarray:
    """A copy of ``plane`` whose first ``limit`` raster 8x8 blocks are the
    probe blocks, repeated."""
    h, w = plane.shape
    tiles = plane_to_blocks(torch.from_numpy(plane)).clone()
    n = min(limit, tiles.shape[0])
    tiles[:n] = torch.from_numpy(np.resize(blocks, (n, 8, 8)))
    return blocks_to_plane(tiles, h, w).numpy()


def content_kind(rng: np.random.Generator, kind: str, shape) -> np.ndarray:
    """One u8 plane of content kind ``kind`` (one of ``KINDS``)."""
    h, w = shape
    if kind == "noise":
        return rng.integers(0, 256, shape, np.uint8)
    if kind == "gradient":
        yy, xx = np.mgrid[0:h, 0:w]
        return ((xx * 255 // max(w - 1, 1) + yy // 7) % 256).astype(np.uint8)
    if kind == "flat":
        return np.full(shape, int(rng.integers(0, 256)), np.uint8)
    if kind == "impulse":
        p = np.full(shape, 128, np.uint8)
        n = int(rng.integers(10, 2000))
        p[rng.integers(0, h, n), rng.integers(0, w, n)] = \
            rng.integers(0, 256, n)
        return p
    if kind == "banded":  # alternating 0/255 rows at a random period
        per = int(rng.integers(1, 17))
        yy = np.arange(h)[:, None] // per % 2
        band = np.broadcast_to((yy * 255).astype(np.uint8), shape)
        return band ^ np.uint8(int(rng.integers(0, 2)) * 255)
    raise ValueError(f"unknown content kind {kind!r}")
