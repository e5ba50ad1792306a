"""K3 and K4 wrappers: the whole-frame DCT + quantize and dequantize + IDCT.

``dct_quantize_blocks`` launches ``csrc/dct_quantize.cu`` (the port of
``myyuv_tpu/kernels/pallas_dct8.py::_dct_quantize_kernel8p``, and of its
entry points ``pallas_dct8._dct_quantize_kernel8`` and
``pallas_dct.py::_dct_quantize_kernel``); ``dequantize_idct_blocks``
launches ``csrc/dequantize_idct.cu`` (the port of
``_dequantize_idct_kernel8p``, ``_dequantize_idct_kernel8`` and
``pallas_dct.py::_dequantize_idct_kernel``).
Both run on tensors on a CUDA device and run their plain PyTorch versions
on tensors on the CPU. There is no fallback: a CUDA tensor launches the
kernel or raises.

Coefficients cross the interface as [N, 64] int16 rows in natural
row-major 8x8 order, blocks Y, then U, then V raster (the JAX flat route's
``[n, 64] i16``, ``myyuv_tpu/engine/device_stream.py:158-172``); zigzag
order lives inside the entropy coder. A batch of B frames passes as one
frame of B*H rows: its blocks come out plane-major (all Y, then all U, then
all V, frames contiguous in each).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from . import device as kdev

U8, I16, F32 = torch.uint8, torch.int16, torch.float32


def check_frame(y, u, v, qtables, dct) -> Tuple[int, int]:
    """Raise ValueError unless (y [H, W], u, v [H/2, W/2] u8, qtables
    [3, 8, 8], dct [8, 8] f32) are contiguous on one device with H and W
    multiples of 16; return (H, W)."""
    if y.dim() != 2:
        raise ValueError("y must be [H, W]")
    h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError("frame height and width must be multiples of 16")
    build.check_tensors(y.device, ("y", y, (h, w), U8),
                        ("u", u, (h // 2, w // 2), U8),
                        ("v", v, (h // 2, w // 2), U8),
                        ("qtables", qtables, (3, 8, 8), F32),
                        ("dct", dct, (8, 8), F32))
    return h, w


def frame_blocks(h: int, w: int) -> int:
    """Checked block count of an h x w frame (positive multiples of 16)."""
    if h % 16 or w % 16 or h <= 0 or w <= 0:
        raise ValueError("frame height and width must be positive "
                         "multiples of 16")
    return sum(kdev.plane_block_counts(h, w))


def dct_quantize_blocks_plain(y, u, v, qtables, dct) -> torch.Tensor:
    """The plain PyTorch version of K3 (same contract)."""
    return torch.cat([
        kdev.dct_quantize(kdev.plane_to_blocks(p), qtables[i], dct)
        .reshape(-1, 64) for i, p in enumerate((y, u, v))])


def dct_quantize_blocks(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        qtables: torch.Tensor, dct: torch.Tensor
                        ) -> torch.Tensor:
    """Frame -> quantized coefficients.

    ``y`` [H, W], ``u``/``v`` [H/2, W/2] uint8 (H, W multiples of 16);
    ``qtables`` [3, 8, 8] float32 (Y, U, V); ``dct`` [8, 8] float32.
    Returns int16 [N, 64] row-major coefficient rows over the N = Y, then
    U, then V raster blocks.
    """
    h, w = check_frame(y, u, v, qtables, dct)
    if build.on_cpu(y.device, "dct_quantize"):
        return dct_quantize_blocks_plain(y, u, v, qtables, dct)
    coeffs = torch.empty((frame_blocks(h, w), 64), dtype=I16, device=y.device)
    build.launch("dct_quantize", y.device, y.data_ptr(), u.data_ptr(),
                 v.data_ptr(), h, w, qtables.data_ptr(), dct.data_ptr(),
                 coeffs.data_ptr())
    return coeffs


def dequantize_idct_pixels_plain(coeffs, qtables, dct, h, w) -> torch.Tensor:
    """[N, 64] coefficient rows -> [N, 8, 8] uint8 pixel blocks (plain)."""
    return torch.cat([
        kdev.dequantize_idct(c.reshape(-1, 8, 8), qtables[i], dct)
        for i, c in enumerate(coeffs.split(kdev.plane_block_counts(h, w)))])


def blocks_to_planes(px: torch.Tensor, h: int, w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, 8, 8] blocks (Y, then U, then V raster) -> (y, u, v) planes."""
    y, u, v = px.split(kdev.plane_block_counts(h, w))
    return (kdev.blocks_to_plane(y, h, w),
            kdev.blocks_to_plane(u, h // 2, w // 2),
            kdev.blocks_to_plane(v, h // 2, w // 2))


def dequantize_idct_blocks_plain(coeffs, qtables, dct, h, w):
    """The plain PyTorch version of K4 (same contract)."""
    return blocks_to_planes(
        dequantize_idct_pixels_plain(coeffs, qtables, dct, h, w), h, w)


def dequantize_idct_blocks(coeffs: torch.Tensor, qtables: torch.Tensor,
                           dct: torch.Tensor, h: int, w: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Coefficients -> frame.

    ``coeffs`` int16 [N, 64] row-major rows over the Y, then U, then V
    raster blocks of an h x w frame (multiples of 16); ``qtables``
    [3, 8, 8] and ``dct`` [8, 8] float32. Returns (y [H, W], u, v
    [H/2, W/2]) uint8.
    """
    n = frame_blocks(h, w)
    dev = coeffs.device
    build.check_tensors(dev, ("coeffs", coeffs, (n, 64), I16),
                        ("qtables", qtables, (3, 8, 8), F32),
                        ("dct", dct, (8, 8), F32))
    build.check_aligned("coeffs", coeffs)
    if build.on_cpu(dev, "dequantize_idct"):
        return dequantize_idct_blocks_plain(coeffs, qtables, dct, h, w)
    y = torch.empty((h, w), dtype=U8, device=dev)
    u = torch.empty((h // 2, w // 2), dtype=U8, device=dev)
    v = torch.empty((h // 2, w // 2), dtype=U8, device=dev)
    build.launch("dequantize_idct", dev, coeffs.data_ptr(), h, w,
                 qtables.data_ptr(), dct.data_ptr(), y.data_ptr(),
                 u.data_ptr(), v.data_ptr())
    return y, u, v
