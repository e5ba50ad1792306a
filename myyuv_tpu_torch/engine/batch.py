"""Batched transform round trip with RD statistics.

Port of ``myyuv_tpu/engine/batch.py`` (``plane_qtables``,
``symbol_histogram``, ``encode_planes``, ``decode_planes``,
``roundtrip_step``). Frames are batched on a leading axis; the forward and
inverse transforms are K3 (``kernels/transform.dct_quantize_blocks``) and K4
(``dequantize_idct_blocks``), or F1 and F2 with ``precision="fast"``, over
the batch seen as one frame of B*H rows, on the card for CUDA tensors and
their plain versions for CPU tensors. The
statistics (per-plane squared-error sums, the global 2048-bin symbol
histogram, the entropy estimate) are PyTorch reductions.
``make_sharded_roundtrip`` runs the step over a (data, block) device mesh.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..kernels import constants, transform
from ..kernels import device as kdev
from ..parallel import distributed
from ..parallel.mesh import Mesh
from ..runtime import trace
from .device_stream import as_one_frame
from .pipeline import resolve_device

# 11-bit symbol alphabet of the entropy stage (coefficients in [-1024, 1023])
NUM_SYMBOLS = 2048

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def plane_qtables(qualities, device="cuda") -> Planes:
    """The three [8, 8] float32 quality-scaled tables (Y, U, V) on
    ``device``."""
    dev = resolve_device(device)
    return tuple(
        torch.from_numpy(constants.quality_scaled_qtable(
            constants.PLANE_Q50[i], int(qualities[i]))).to(dev)
        for i in range(3))


def symbol_histogram(coeffs: torch.Tensor) -> torch.Tensor:
    """Global [NUM_SYMBOLS] int32 histogram of quantized coefficients (bin
    c + 1024); values outside the 11-bit alphabet are not counted.

    A sort and a count (``torch.unique``), not ``torch.bincount``: most
    coefficients are 0, and bincount's atomic adds on the card serialise
    on that one bin.
    """
    idx = coeffs.reshape(-1).to(torch.int32) + 1024
    idx = torch.where((idx >= 0) & (idx < NUM_SYMBOLS), idx, NUM_SYMBOLS)
    with trace.span("wait.size"):
        vals, counts = torch.unique(idx, return_counts=True)
    hist = torch.zeros(NUM_SYMBOLS + 1, dtype=torch.int64, device=idx.device)
    hist.index_put_((vals.long(),), counts)
    return hist[:NUM_SYMBOLS].to(torch.int32)


def _forward(y, u, v, qts, dct, precision: str = "exact"):
    """K3 (F1 when fast) over the batch as one frame -> (coefficients
    [N, 64], per-plane views [..., n, 8, 8])."""
    lead = y.shape[:-2]
    ys, us, vs = as_one_frame(y, u, v)
    c = kdev.dct_matrix(y.device) if dct is None else dct
    coeffs = transform.dct_quantize_blocks(ys, us, vs, torch.stack(qts), c,
                                           precision)
    n = kdev.plane_block_counts(*ys.shape)
    return coeffs, tuple(p.view(*lead, -1, 8, 8) for p in coeffs.split(n))


def _inverse(coeffs, qts, dct, lead, h, w, precision: str = "exact"
             ) -> Planes:
    """K4 (F2 when fast) of [N, 64] coefficients over the batch as one
    frame -> planes [..., H, W] (+ chroma)."""
    c = kdev.dct_matrix(coeffs.device) if dct is None else dct
    y, u, v = transform.dequantize_idct_blocks(
        coeffs, torch.stack(qts), c, math.prod(lead) * h, w, precision)
    return (y.view(*lead, h, w), u.view(*lead, h // 2, w // 2),
            v.view(*lead, h // 2, w // 2))


def encode_planes(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  qt_y: torch.Tensor, qt_u: torch.Tensor, qt_v: torch.Tensor,
                  dct: torch.Tensor | None = None,
                  precision: str = "exact") -> Planes:
    """[B, H, W] (or [H, W]) + chroma uint8 -> per-plane quantized
    coefficients [B, n, 8, 8] int16 (raster blocks per frame), via K3 (F1
    with ``precision="fast"``)."""
    return _forward(y, u, v, (qt_y, qt_u, qt_v), dct, precision)[1]


def decode_planes(cy: torch.Tensor, cu: torch.Tensor, cv: torch.Tensor,
                  qt_y: torch.Tensor, qt_u: torch.Tensor, qt_v: torch.Tensor,
                  h: int, w: int, dct: torch.Tensor | None = None,
                  precision: str = "exact") -> Planes:
    """Per-plane coefficients [B, n, 8, 8] (or [n, 8, 8]) -> [B, H, W]
    (+ chroma) uint8 planes, via K4 (F2 with ``precision="fast"``)."""
    coeffs = torch.cat([p.reshape(-1, 64) for p in (cy, cu, cv)])
    return _inverse(coeffs, (qt_y, qt_u, qt_v), dct, cy.shape[:-3], h, w,
                    precision)


def roundtrip_step(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   qt_y: torch.Tensor, qt_u: torch.Tensor, qt_v: torch.Tensor,
                   dct: torch.Tensor | None = None, precision: str = "exact"
                   ) -> Tuple[Planes, Dict[str, torch.Tensor]]:
    """Transform round trip (DCT -> quantize -> reconstruct) + metrics.

    Returns the reconstructed planes and the JAX package's metrics dict:
    per-plane float32 squared-error sums ``sse_y/u/v`` (for PSNR), the
    global ``symbol_hist`` and ``entropy_bits_per_symbol``, all on the
    planes' device. ``precision="fast"`` runs F1 and F2 in place of K3
    and K4; any value but "exact" and "fast" raises ValueError.
    """
    h, w = y.shape[-2:]
    qts = (qt_y, qt_u, qt_v)
    coeffs, _ = _forward(y, u, v, qts, dct, precision)
    ry, ru, rv = _inverse(coeffs, qts, dct, y.shape[:-2], h, w, precision)

    def sq_err(a, b):
        d = a.to(torch.float32) - b.to(torch.float32)
        return torch.sum(d * d)

    hist = symbol_histogram(coeffs)  # the sum of the three planes'
    metrics = {
        "sse_y": sq_err(y, ry),
        "sse_u": sq_err(u, ru),
        "sse_v": sq_err(v, rv),
        "symbol_hist": hist,
        "entropy_bits_per_symbol": entropy_bits(hist),
    }
    return (ry, ru, rv), metrics


def entropy_bits(hist: torch.Tensor) -> torch.Tensor:
    """Shannon entropy, in bits a symbol, of a symbol histogram."""
    p = hist.to(torch.float32) / torch.clamp(hist.sum(), min=1)
    return -torch.sum(
        torch.where(p > 0, p * torch.log2(p), torch.zeros_like(p)))


def make_sharded_roundtrip(mesh: Mesh, precision: str = "exact"):
    """The round trip step over ``mesh``: ``step(y, u, v, qt_y, qt_u, qt_v,
    dct=None)`` takes [B, H, W] (+ 2x [B, H/2, W/2]) uint8 planes, as
    ``roundtrip_step`` does, and returns its planes and metrics; each shard
    runs ``roundtrip_step`` at ``precision`` (F1 + F2 on a CUDA device when
    "fast"; any value but "exact" and "fast" raises ValueError).

    Frames split over the ``data`` axis (``distributed.shard_batch``) and
    each frame's block rows over ``block``; each shard runs
    ``roundtrip_step`` (K3 + K4 on a CUDA device) on its device. The
    planes come back in batch order on ``y``'s device. The metrics are the
    whole batch's, on ``y``'s device too: ``sse_*`` and ``symbol_hist``
    summed over the shards on the host and then over the processes (gloo),
    ``entropy_bits_per_symbol`` from the global histogram. The float32 SSE
    sums are taken shard by shard, so they match the unsharded step's to
    float32 rounding; planes and histogram are exact.

    The step raises ValueError unless B divides over ``data`` and H is a
    multiple of 16 times ``block`` (as the JAX package's jit refuses an
    uneven sharding).
    """
    rows, cols = mesh.shape

    def step(y, u, v, qt_y, qt_u, qt_v, dct=None):
        b, h, w = y.shape
        if b % rows or h % (16 * cols):
            raise ValueError(f"[{b}, {h}, {w}] planes do not shard over a "
                             f"({rows}, {cols}) mesh: B must divide over "
                             f"data, H be a multiple of {16 * cols}")
        hs = h // cols
        parts = [distributed.shard_batch(p, mesh) for p in (y, u, v)]
        planes, metrics = [], []
        for i, row in enumerate(mesh.devices):
            for j, dev in enumerate(row):
                shard = [p[i][:, j * r:(j + 1) * r].contiguous().to(dev)
                         for p, r in zip(parts, (hs, hs // 2, hs // 2))]
                qts = [q.to(dev) for q in (qt_y, qt_u, qt_v)]
                out, m = roundtrip_step(*shard, *qts,
                                        None if dct is None else dct.to(dev),
                                        precision)
                planes.append([p.to(y.device) for p in out])
                metrics.append(m)
        out = tuple(torch.cat([torch.cat([planes[i * cols + j][k]
                                          for j in range(cols)], 1)
                               for i in range(rows)])
                    for k in range(3))
        sse = distributed.allreduce_sum(torch.stack(
            [torch.stack([m[k] for k in ("sse_y", "sse_u", "sse_v")]).cpu()
             for m in metrics]).sum(0))
        hist = distributed.allreduce_sum(torch.stack(
            [m["symbol_hist"].cpu() for m in metrics]).sum(0)).to(torch.int32)
        sse, hist = sse.to(y.device), hist.to(y.device)
        return out, {"sse_y": sse[0], "sse_u": sse[1], "sse_v": sse[2],
                     "symbol_hist": hist,
                     "entropy_bits_per_symbol": entropy_bits(hist)}

    return step
