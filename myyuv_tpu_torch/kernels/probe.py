"""Content and a timer for holding the kernels against their plain versions.

* ``contraction_probe_blocks``: the recipe of the production-kernel
  contraction probe in ``tools/check_tpu_bitexact.py`` (:105-152) — random
  8x8 blocks whose quantized coefficients differ between the reference's
  double-rounded chains (a multiply, then an add, each rounded) and the
  same chains with every step fused into one FMA, emulated in float64. A
  kernel whose compiler contracted the DCT chains disagrees with the plain
  version on these blocks.
* ``content_kind``: the plane content kinds of ``tools/fuzz_tpu_frame.py``
  (:35): noise, gradient, flat, impulse, banded.
* ``encoder_families``: coefficient rows that stress the lane-group
  Huffman encoder of K1 and K5 (``csrc/block_huffman.cuh``), family by
  family (``ENCODER_FAMILIES``).
* ``smooth_picture``: the smooth XRGB8888 picture of ``chip_smoke.py``'s
  CLI phase, the frame on which it and ``tools/encoder_ab.py`` time the
  kernels.
* ``cuda_ms``: the device time of a call, by CUDA events.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from ..entropy.device import ZIGZAG
from .constants import DCT_MATRIX8, PLANE_Q50, quality_scaled_qtable
from .device import blocks_to_plane, dct_quantize, plane_to_blocks

KINDS = ("noise", "gradient", "flat", "impulse", "banded")
ENCODER_FAMILIES = (
    "all_zero", "first_only", "last_only", "one_symbol", "n_sym_2",
    "n_sym_31", "n_sym_32", "n_sym_33", "n_sym_64", "long_run",
    "merge_ties", "word_crossing", "int16_extremes", "alias_11_bits",
    "ragged_count")


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


def encoder_families(rng: np.random.Generator) -> dict:
    """``ENCODER_FAMILIES`` name -> int16 [k, 64] row-major coefficient rows
    (k = 5, except ``ragged_count``'s 53 rows, which are no multiple of the
    32 blocks a CTA of K1 or K5 codes):

    * all_zero; first_only / last_only: one nonzero symbol at zigzag
      position 0 / 63;
    * one_symbol, n_sym_2 .. n_sym_64: exactly that many distinct symbols
      over a full 64-symbol message;
    * long_run: 48 symbols of weight 1 and one of weight 16, so 48 codes of
      length 6 split over two tree groups;
    * merge_ties: weights 1, 1, 2, 2, 4, 4, 8, 8, so merge steps tie a leaf
      with an internal node;
    * word_crossing: dense random 11-bit symbols, whose tree fields and
      codes cross 32-bit words;
    * int16_extremes: the int16 range's ends and random int16 values;
    * alias_11_bits: 5, 2053 and -2043, which share their low 11 bits;
    * ragged_count: sparse random rows.
    """
    per = 5

    def from_messages(msgs):
        msgs = np.asarray(msgs, np.int64)
        rows = np.zeros((msgs.shape[0], 64), np.int64)
        rows[:, ZIGZAG[:msgs.shape[1]]] = msgs
        return rows.astype(np.int16)

    nonzero = np.concatenate([np.arange(-1024, 0), np.arange(1, 1024)])

    def n_distinct(n):
        msgs = []
        for _ in range(per):
            vals = rng.choice(nonzero, n, replace=False)
            msgs.append(rng.permutation(np.concatenate(
                [vals, rng.choice(vals, 64 - n)])))
        return from_messages(msgs)

    i16 = np.iinfo(np.int16)
    ext = rng.integers(i16.min, i16.max + 1, (per, 64))
    ext[0], ext[1] = i16.max, i16.min
    ext[2, ::2], ext[2, 1::2] = i16.min, i16.max
    return {
        "all_zero": np.zeros((per, 64), np.int16),
        "first_only": from_messages(rng.choice(nonzero, (per, 1))),
        "last_only": from_messages(np.pad(rng.choice(nonzero, (per, 1)),
                                          ((0, 0), (63, 0)))),
        "one_symbol": from_messages(
            np.repeat(rng.choice(nonzero, (per, 1)), 64, axis=1)),
        **{f"n_sym_{n}": n_distinct(n) for n in (2, 31, 32, 33, 64)},
        "long_run": from_messages([rng.permutation(np.concatenate(
            [rng.choice(np.arange(1, 500), 48, replace=False),
             np.full(16, -777)])) for _ in range(per)]),
        "merge_ties": from_messages([rng.permutation(np.repeat(
            rng.choice(nonzero, 8, replace=False), [1, 1, 2, 2, 4, 4, 8, 8]))
            for _ in range(per)]),
        "word_crossing": (rng.integers(-1024, 1024, (per, 64))
                          * (rng.random((per, 64)) < 0.6)).astype(np.int16),
        "int16_extremes": ext.astype(np.int16),
        "alias_11_bits": from_messages(rng.choice([5, 2053, -2043],
                                                  (per, 20))),
        "ragged_count": (rng.integers(-300, 300, (53, 64))
                         * (rng.random((53, 64)) < rng.random((53, 1)))
                         ).astype(np.int16),
    }


def smooth_picture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth XRGB8888 picture with a little noise, u8 [h, w, 4]."""
    yy, xx = np.mgrid[0:h, 0:w]
    px = np.empty((h, w, 4), np.uint8)
    noise = rng.integers(-6, 7, (3, h, w))
    for c, (fy, fx) in enumerate(((0.11, 0.07), (0.05, 0.13), (0.09, 0.03))):
        base = 128 + 100 * np.sin(yy * fy / 7) * np.cos(xx * fx / 9)
        px[..., c] = np.clip(base + noise[c], 0, 255).astype(np.uint8)
    px[..., 3] = 255
    return px


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device time of fn() in ms over ``reps`` readings, after two
    warm-up calls: CUDA events around one call each. The reading starts
    before fn's host work, so it also counts whatever of that work the
    idle card waits for."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
