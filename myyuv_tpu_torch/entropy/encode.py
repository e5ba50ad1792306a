"""K1 wrapper: fused DCT + quantize + Huffman encode of a whole frame.

``dct_encode_blocks`` launches ``csrc/dct_encode.cu`` (the port of
``myyuv_tpu/entropy/pallas_encode8.py::_dct_encode_kernel8``) for tensors
on a CUDA device, and runs the plain PyTorch version for tensors on the
CPU. There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from ..kernels import device as kdev
from . import device as edev

# kernel launches made through dct_encode_blocks (reset it to count a run)
launches = 0


def _check(y, u, v, qtables, dct):
    if y.dim() != 2:
        raise ValueError("y must be [H, W]")
    h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError("frame height and width must be multiples of 16")
    for name, t, shape, dtype in (
            ("y", y, (h, w), torch.uint8),
            ("u", u, (h // 2, w // 2), torch.uint8),
            ("v", v, (h // 2, w // 2), torch.uint8),
            ("qtables", qtables, (3, 8, 8), torch.float32),
            ("dct", dct, (8, 8), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return h, w


def dct_encode_blocks_plain(y, u, v, qtables, dct):
    """The plain PyTorch version of K1 (same contract)."""
    coeffs = torch.cat([
        kdev.dct_quantize(kdev.plane_to_blocks(p), qtables[i], dct)
        .reshape(-1, 64) for i, p in enumerate((y, u, v))])
    return edev.encode_lanes(coeffs)


def dct_encode_blocks(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      qtables: torch.Tensor, dct: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Frame -> per-block Huffman chunks.

    ``y`` [H, W], ``u``/``v`` [H/2, W/2] uint8 (H, W multiples of 16);
    ``qtables`` [3, 8, 8] float32 (Y, U, V); ``dct`` [8, 8] float32.
    Returns (lanes u8 [N, 256], sizes i32 [N], err i32 [N]) over the
    N = Y, then U, then V raster blocks: lane b holds chunk b's on-disk
    bytes, zero past ``sizes[b]``; ``err[b]`` is 1 only for a chunk the
    u8 size field cannot hold.
    """
    h, w = _check(y, u, v, qtables, dct)
    if y.device.type == "cpu":
        return dct_encode_blocks_plain(y, u, v, qtables, dct)
    if y.device.type != "cuda":
        raise ValueError(f"no dct_encode kernel for device {y.device}")
    fn = build.load("dct_encode")
    n = sum(kdev.plane_block_counts(h, w))
    lanes = torch.empty((n, edev.LANE), dtype=torch.uint8, device=y.device)
    sizes = torch.empty(n, dtype=torch.int32, device=y.device)
    err = torch.empty(n, dtype=torch.int32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    rc = fn(y.data_ptr(), u.data_ptr(), v.data_ptr(), h, w, qtables.data_ptr(),
            dct.data_ptr(), lanes.data_ptr(), sizes.data_ptr(), err.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"dct_encode kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return lanes, sizes, err
