"""K3, K4, F1 and F2 wrappers: the whole-frame DCT + quantize and dequantize
+ IDCT, exact and fast.

``dct_quantize_blocks`` launches ``csrc/dct_quantize.cu`` (the port of
``myyuv_tpu/kernels/pallas_dct8.py::_dct_quantize_kernel8p``, and of its
entry points ``pallas_dct8._dct_quantize_kernel8`` and
``pallas_dct.py::_dct_quantize_kernel``); ``dequantize_idct_blocks``
launches ``csrc/dequantize_idct.cu`` (the port of
``_dequantize_idct_kernel8p``, ``_dequantize_idct_kernel8`` and
``pallas_dct.py::_dequantize_idct_kernel``).
``precision="fast"`` (the JAX package's ``kernels/device.py``
``_mxu_transform`` products, :158-209, which no Pallas kernel computes)
launches F1 ``csrc/fast_dct_quantize.cu`` and F2
``csrc/fast_dequantize_idct.cu`` instead: the same group transforms with
FMA-contracted float32 chains, coefficients and pixels within +-1 of
exact. All four run on tensors on a CUDA device and run their plain
PyTorch versions on tensors on the CPU. There is no fallback: a CUDA
tensor launches the kernel or raises.

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


def dct_quantize_blocks_plain(y, u, v, qtables, dct,
                              precision: str = "exact") -> torch.Tensor:
    """The plain PyTorch version of K3 (same contract); of F1 with
    ``precision="fast"``."""
    return torch.cat([
        kdev.dct_quantize(kdev.plane_to_blocks(p), qtables[i], dct,
                          precision).reshape(-1, 64)
        for i, p in enumerate((y, u, v))])


def fast_dct_quantize_blocks_plain(y, u, v, qtables, dct) -> torch.Tensor:
    """The plain PyTorch version of F1: ``kernels/device.py``'s fast
    transform, F1's float32 FMA chains (broadcast products and sums, no
    matmul, so no TF32 flag governs them), then
    ``round_half_away(coef / q)``: F1's coefficients bit for bit."""
    return dct_quantize_blocks_plain(y, u, v, qtables, dct, "fast")


def dct_quantize_blocks(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        qtables: torch.Tensor, dct: torch.Tensor,
                        precision: str = "exact") -> torch.Tensor:
    """Frame -> quantized coefficients.

    ``y`` [H, W], ``u``/``v`` [H/2, W/2] uint8 (H, W multiples of 16);
    ``qtables`` [3, 8, 8] float32 (Y, U, V); ``dct`` [8, 8] float32.
    Returns int16 [N, 64] row-major coefficient rows over the N = Y, then
    U, then V raster blocks. K3, or F1 with ``precision="fast"``; any
    other precision raises ValueError.
    """
    if kdev.is_fast(precision):
        return fast_dct_quantize_blocks(y, u, v, qtables, dct)
    return _forward("dct_quantize", dct_quantize_blocks_plain, y, u, v,
                    qtables, dct)


def fast_dct_quantize_blocks(y: torch.Tensor, u: torch.Tensor,
                             v: torch.Tensor, qtables: torch.Tensor,
                             dct: torch.Tensor) -> torch.Tensor:
    """F1: ``dct_quantize_blocks``'s contract, precision="fast"."""
    return _forward("fast_dct_quantize", fast_dct_quantize_blocks_plain, y,
                    u, v, qtables, dct)


def _forward(name, plain, y, u, v, qtables, dct) -> torch.Tensor:
    """Checks, then kernel ``name`` on a CUDA frame or ``plain`` on a CPU
    one."""
    h, w = check_frame(y, u, v, qtables, dct)
    if build.on_cpu(y.device, name):
        return plain(y, u, v, qtables, dct)
    coeffs = torch.empty((frame_blocks(h, w), 64), dtype=I16, device=y.device)
    build.launch(name, y.device, y.data_ptr(), u.data_ptr(), v.data_ptr(),
                 h, w, qtables.data_ptr(), dct.data_ptr(), coeffs.data_ptr())
    return coeffs


def dequantize_idct_pixels_plain(coeffs, qtables, dct, h, w,
                                 precision: str = "exact") -> torch.Tensor:
    """[N, 64] coefficient rows -> [N, 8, 8] uint8 pixel blocks (plain)."""
    return torch.cat([
        kdev.dequantize_idct(c.reshape(-1, 8, 8), qtables[i], dct, precision)
        for i, c in enumerate(coeffs.split(kdev.plane_block_counts(h, w)))])


def blocks_to_planes(px: torch.Tensor, h: int, w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, 8, 8] blocks (Y, then U, then V raster) -> (y, u, v) planes."""
    y, u, v = px.split(kdev.plane_block_counts(h, w))
    return (kdev.blocks_to_plane(y, h, w),
            kdev.blocks_to_plane(u, h // 2, w // 2),
            kdev.blocks_to_plane(v, h // 2, w // 2))


def dequantize_idct_blocks_plain(coeffs, qtables, dct, h, w,
                                 precision: str = "exact"):
    """The plain PyTorch version of K4 (same contract); of F2 with
    ``precision="fast"``."""
    return blocks_to_planes(dequantize_idct_pixels_plain(
        coeffs, qtables, dct, h, w, precision), h, w)


def fast_dequantize_idct_blocks_plain(coeffs, qtables, dct, h, w):
    """The plain PyTorch version of F2: ``kernels/device.py``'s fast
    inverse, F2's float32 FMA chains (no matmul): F2's pixels bit for
    bit."""
    return dequantize_idct_blocks_plain(coeffs, qtables, dct, h, w, "fast")


def dequantize_idct_blocks(coeffs: torch.Tensor, qtables: torch.Tensor,
                           dct: torch.Tensor, h: int, w: int,
                           precision: str = "exact"
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Coefficients -> frame.

    ``coeffs`` int16 [N, 64] row-major rows over the Y, then U, then V
    raster blocks of an h x w frame (multiples of 16); ``qtables``
    [3, 8, 8] and ``dct`` [8, 8] float32. Returns (y [H, W], u, v
    [H/2, W/2]) uint8. K4, or F2 with ``precision="fast"``; any other
    precision raises ValueError.
    """
    if kdev.is_fast(precision):
        return fast_dequantize_idct_blocks(coeffs, qtables, dct, h, w)
    return _inverse("dequantize_idct", dequantize_idct_blocks_plain, coeffs,
                    qtables, dct, h, w)


def fast_dequantize_idct_blocks(coeffs: torch.Tensor, qtables: torch.Tensor,
                                dct: torch.Tensor, h: int, w: int
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """F2: ``dequantize_idct_blocks``'s contract, precision="fast"."""
    return _inverse("fast_dequantize_idct", fast_dequantize_idct_blocks_plain,
                    coeffs, qtables, dct, h, w)


def _inverse(name, plain, coeffs, qtables, dct, h, w):
    """Checks, then kernel ``name`` on CUDA coefficients or ``plain`` on CPU
    ones."""
    n = frame_blocks(h, w)
    dev = coeffs.device
    build.check_tensors(dev, ("coeffs", coeffs, (n, 64), I16),
                        ("qtables", qtables, (3, 8, 8), F32),
                        ("dct", dct, (8, 8), F32))
    build.check_aligned("coeffs", coeffs)
    if build.on_cpu(dev, name):
        return plain(coeffs, qtables, dct, h, w)
    y = torch.empty((h, w), dtype=U8, device=dev)
    u = torch.empty((h // 2, w // 2), dtype=U8, device=dev)
    v = torch.empty((h // 2, w // 2), dtype=U8, device=dev)
    build.launch(name, dev, coeffs.data_ptr(), h, w, qtables.data_ptr(),
                 dct.data_ptr(), y.data_ptr(), u.data_ptr(), v.data_ptr())
    return y, u, v
