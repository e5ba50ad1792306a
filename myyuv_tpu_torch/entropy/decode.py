"""K2, K6 and T5 wrappers: the fused frame decode, the coefficient decode
and the decoder's tree stage alone.

``decode_idct_blocks`` launches ``csrc/decode_idct.cu`` (the port of
``myyuv_tpu/entropy/pallas_decode8.py::_fused_decode_idct_kernel8``);
``decode_blocks`` launches ``csrc/huffman_decode.cu`` (the port of
``pallas_decode8.py::_tree_kernel8`` + ``_payload_kernel8`` and of their
entry point ``entropy/pallas_decode.py::_tree_kernel`` +
``_payload_kernel``); ``parse_trees`` launches ``csrc/huffman_tree.cu``
(the port of ``_tree_kernel8`` as ``tools/exp_r3stage.py`` times it alone).
Each runs on tensors on a CUDA device and runs its plain PyTorch version on
tensors on the CPU. There is no fallback: a CUDA tensor launches the kernel
or raises.

Input contract of all three: ``content`` u8 [T] holds the chunks back to
back as the file does, ``sizes`` i32 [N] (0..255) their byte counts and
``offsets`` i64 [N] their exclusive prefix sum; bytes outside ``content``
read as 0. ``err[b]`` is native ``decode_block``'s code 1..8 for a bad
chunk (1..4 for a bad tree, from ``parse_trees``), else 0.
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


def parse_trees_plain(content, sizes, offsets
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of T5 (same contract)."""
    return edev.parse_tree_lanes(edev.gather_lanes(content, sizes, offsets),
                                 sizes)


def parse_trees(content: torch.Tensor, sizes: torch.Tensor,
                offsets: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunk stream -> the tree stage's tables: (symbols int16 [N, 64], the
    first 64 tree symbols of each block in canonical order, zero past their
    count; counts i32 [N, 8], the codes of length 1..8; err i32 [N], 0 or
    native's tree code 1..4), as ``entropy/device.py::parse_tree_lanes``
    defines them. A bad block's symbols and counts are 0."""
    n = sizes.shape[0] if sizes.dim() == 1 else -1
    _check_stream(content, sizes, offsets, n)
    dev = content.device
    if build.on_cpu(dev, "huffman_tree"):
        return parse_trees_plain(content, sizes, offsets)
    symbols = torch.empty((n, 64), dtype=torch.int16, device=dev)
    counts = torch.empty((n, 8), dtype=torch.int32, device=dev)
    err = torch.empty(n, dtype=torch.int32, device=dev)
    build.launch("huffman_tree", dev, content.data_ptr(), content.numel(),
                 sizes.data_ptr(), offsets.data_ptr(), n, symbols.data_ptr(),
                 counts.data_ptr(), err.data_ptr())
    return symbols, counts, err


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
