"""K2 and K6 wrappers: the fused frame decode and the coefficient decode.

``decode_idct_blocks`` launches ``csrc/decode_idct.cu`` (the port of
``myyuv_tpu/entropy/pallas_decode8.py::_fused_decode_idct_kernel8``);
``decode_blocks`` launches ``csrc/huffman_decode.cu`` (the port of
``pallas_decode8.py::_tree_kernel8`` + ``_payload_kernel8`` and of their
entry point ``entropy/pallas_decode.py::_tree_kernel`` +
``_payload_kernel``). Both run on tensors on a CUDA device and run their
plain PyTorch versions on tensors on the CPU. There is no fallback: a CUDA
tensor launches the kernel or raises.

Input contract of both: ``content`` u8 [T] holds the chunks back to back
as the file does, ``sizes`` i32 [N] (0..255) their byte counts and
``offsets`` i64 [N] their exclusive prefix sum; bytes outside ``content``
read as 0. ``err[b]`` is native ``decode_block``'s code 1..8 for a bad
chunk, else 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from ..kernels import transform
from . import device as edev


def _check_stream(content, sizes, offsets, n: int) -> None:
    build.check_tensors(content.device,
                        ("content", content, (content.numel(),), torch.uint8),
                        ("sizes", sizes, (n,), torch.int32),
                        ("offsets", offsets, (n,), torch.int64))


def decode_blocks_plain(content, sizes, offsets
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K6 (same contract)."""
    return edev.decode_lanes(edev.gather_lanes(content, sizes, offsets),
                             sizes)


def decode_blocks(content: torch.Tensor, sizes: torch.Tensor,
                  offsets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk stream -> (coefficients int16 [N, 64] in natural row-major 8x8
    order, err i32 [N]); a bad block's coefficients are 0."""
    n = sizes.shape[0] if sizes.dim() == 1 else -1
    _check_stream(content, sizes, offsets, n)
    dev = content.device
    if build.on_cpu(dev, "huffman_decode"):
        return decode_blocks_plain(content, sizes, offsets)
    coeffs = torch.empty((n, 64), dtype=torch.int16, device=dev)
    err = torch.empty(n, dtype=torch.int32, device=dev)
    build.launch("huffman_decode", dev, content.data_ptr(), content.numel(),
                 sizes.data_ptr(), offsets.data_ptr(), n, coeffs.data_ptr(),
                 err.data_ptr())
    return coeffs, err


def decode_idct_blocks_plain(content, sizes, offsets, qtables, dct, h, w):
    """The plain PyTorch version of K2 (same contract)."""
    coeffs, err = decode_blocks_plain(content, sizes, offsets)
    px = transform.dequantize_idct_pixels_plain(coeffs, qtables, dct, h, w)
    px = torch.where(err[:, None, None] != 0, 0, px).to(torch.uint8)
    return (*transform.blocks_to_planes(px, h, w), err)


def decode_idct_blocks(content: torch.Tensor, sizes: torch.Tensor,
                       offsets: torch.Tensor, qtables: torch.Tensor,
                       dct: torch.Tensor, h: int, w: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Chunk stream -> frame.

    Blocks are ordered Y, then U, then V raster of an h x w frame
    (multiples of 16); ``qtables`` [3, 8, 8] and ``dct`` [8, 8] are
    float32. Returns (y [H, W], u, v [H/2, W/2] uint8, err i32 [N]); a bad
    chunk's pixels are 0. K6 followed by K4 in one kernel.
    """
    n = transform.frame_blocks(h, w)
    _check_stream(content, sizes, offsets, n)
    dev = content.device
    build.check_tensors(dev, ("qtables", qtables, (3, 8, 8), torch.float32),
                        ("dct", dct, (8, 8), torch.float32))
    if build.on_cpu(dev, "decode_idct"):
        return decode_idct_blocks_plain(content, sizes, offsets, qtables,
                                        dct, h, w)
    y = torch.empty((h, w), dtype=torch.uint8, device=dev)
    u = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev)
    v = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev)
    err = torch.empty(n, dtype=torch.int32, device=dev)
    build.launch("decode_idct", dev, content.data_ptr(), content.numel(),
                 sizes.data_ptr(), offsets.data_ptr(), h, w,
                 qtables.data_ptr(), dct.data_ptr(), y.data_ptr(),
                 u.data_ptr(), v.data_ptr(), err.data_ptr())
    return y, u, v, err
