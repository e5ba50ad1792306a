"""K2 wrapper: fused Huffman decode + dequantize + IDCT of a whole frame.

``decode_idct_blocks`` launches ``csrc/decode_idct.cu`` (the port of
``myyuv_tpu/entropy/pallas_decode8.py::_fused_decode_idct_kernel8``) for
tensors on a CUDA device, and runs the plain PyTorch version for tensors on
the CPU. There is no fallback: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from ..kernels import device as kdev
from . import device as edev

# kernel launches made through decode_idct_blocks (reset it to count a run)
launches = 0


def _check(content, sizes, offsets, qtables, dct, h, w):
    if h % 16 or w % 16 or h <= 0 or w <= 0:
        raise ValueError("frame height and width must be positive "
                         "multiples of 16")
    n = sum(kdev.plane_block_counts(h, w))
    for name, t, shape, dtype in (
            ("content", content, (content.numel(),), torch.uint8),
            ("sizes", sizes, (n,), torch.int32),
            ("offsets", offsets, (n,), torch.int64),
            ("qtables", qtables, (3, 8, 8), torch.float32),
            ("dct", dct, (8, 8), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != content.device:
            raise ValueError(f"{name} is on {t.device}, content on "
                             f"{content.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return n


def decode_idct_blocks_plain(content, sizes, offsets, qtables, dct, h, w):
    """The plain PyTorch version of K2 (same contract)."""
    lanes = edev.gather_lanes(content, sizes, offsets)
    coeffs, err = edev.decode_lanes(lanes, sizes)
    px = torch.cat([
        kdev.dequantize_idct(c.reshape(-1, 8, 8), qtables[i], dct)
        for i, c in enumerate(coeffs.split(kdev.plane_block_counts(h, w)))])
    px = torch.where(err[:, None, None] != 0, 0, px).to(torch.uint8)
    y, u, v = px.split(kdev.plane_block_counts(h, w))
    return (kdev.blocks_to_plane(y, h, w),
            kdev.blocks_to_plane(u, h // 2, w // 2),
            kdev.blocks_to_plane(v, h // 2, w // 2), err)


def decode_idct_blocks(content: torch.Tensor, sizes: torch.Tensor,
                       offsets: torch.Tensor, qtables: torch.Tensor,
                       dct: torch.Tensor, h: int, w: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Chunk stream -> frame.

    ``content`` u8 [T] holds the chunks back to back as the file does,
    ``sizes`` i32 [N] (0..255) their byte counts and ``offsets`` i64 [N]
    their exclusive prefix sum (bytes outside ``content`` read as 0);
    blocks are ordered Y, then U, then V raster. ``qtables`` [3, 8, 8] and
    ``dct`` [8, 8] are float32. Returns (y [H, W], u, v [H/2, W/2] uint8,
    err i32 [N]): ``err[b]`` is native ``decode_block``'s code 1..8 for a bad
    chunk (whose pixels are 0), else 0.
    """
    n = _check(content, sizes, offsets, qtables, dct, h, w)
    if content.device.type == "cpu":
        return decode_idct_blocks_plain(content, sizes, offsets, qtables,
                                        dct, h, w)
    if content.device.type != "cuda":
        raise ValueError(f"no decode_idct kernel for device {content.device}")
    fn = build.load("decode_idct")
    dev = content.device
    y = torch.empty((h, w), dtype=torch.uint8, device=dev)
    u = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev)
    v = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev)
    err = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(content.data_ptr(), content.numel(), sizes.data_ptr(),
            offsets.data_ptr(), h, w,
            qtables.data_ptr(), dct.data_ptr(), y.data_ptr(), u.data_ptr(),
            v.data_ptr(), err.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_idct kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return y, u, v, err
