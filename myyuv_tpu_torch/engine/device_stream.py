"""Frame codec on the device: planes up once, file bytes down once.

Port of ``myyuv_tpu/engine/device_stream.py`` in block-major form:

  compress:   planes --h2d--> K1 (dct_encode_blocks) -> lanes, sizes
              -> on-device compaction to the exact on-disk byte stream
              --d2h--> sizes, content -> per-plane split
  decompress: sizes, content (as the file holds them) --h2d-->
              offsets = cumsum(sizes) on the device -> K2
              (decode_idct_blocks) -> planes --d2h-->

The compaction is a row-major mask select of the 256-byte lanes
(``lanes[arange(256) < sizes[:, None]]``), so the chunks come out back to
back in block order — the TPU package's continuation-word tiers, its A/C
interchange regions and the host repack/expand steps have no counterpart.
Blocks are ordered Y raster, then U, then V (DCT.cpp:112-173).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..entropy import decode, encode
from ..kernels.device import plane_block_counts
from ..runtime.errors import BitstreamError

Stream = Tuple[np.ndarray, np.ndarray]  # (chunk sizes u8, content u8)


def _raise_first_bad(err: torch.Tensor, what: str) -> None:
    bad = torch.nonzero(err).flatten()
    if bad.numel():
        b = int(bad[0])
        raise BitstreamError(f"{what} failed at block {b} "
                             f"(code {int(err[b])})")


def compress_frame(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   qtables: torch.Tensor, dct: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device planes -> (sizes i32 [N], content u8 [T]) on the same device:
    the chunks of all blocks back to back, exactly as the file stores
    them."""
    lanes, sizes, err = encode.dct_encode_blocks(y, u, v, qtables, dct)
    _raise_first_bad(err, "Huffman encode")
    return sizes, compact_chunks(lanes, sizes)


def compact_chunks(lanes: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """[N, 256] lanes -> the chunks back to back in block order (a
    row-major mask select, on the lanes' device)."""
    col = torch.arange(lanes.shape[1], device=lanes.device)
    return lanes[col[None, :] < sizes[:, None]]


def split_planes(sizes: np.ndarray, content: np.ndarray, h: int,
                 w: int) -> List[Stream]:
    """A frame's (sizes, content) -> [(sizes u8, content u8)] per plane."""
    out, lo, pos = [], 0, 0
    for n in plane_block_counts(h, w):
        s = sizes[lo:lo + n]
        t = int(s.sum(dtype=np.int64))
        out.append((s.astype(np.uint8), content[pos:pos + t]))
        lo, pos = lo + n, pos + t
    return out


def compress_frame_to_streams(planes: Sequence[np.ndarray],
                              qtables: torch.Tensor, dct: torch.Tensor
                              ) -> List[Stream]:
    """(y, u, v) uint8 planes -> [(sizes u8, content u8)] per plane, coded
    on ``qtables.device``."""
    dev = qtables.device
    y, u, v = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
               for p in planes)
    sizes, content = compress_frame(y, u, v, qtables, dct)
    return split_planes(sizes.cpu().numpy(), content.cpu().numpy(),
                        *planes[0].shape)


def decompress_frame(content: torch.Tensor, sizes: torch.Tensor,
                     qtables: torch.Tensor, dct: torch.Tensor, h: int,
                     w: int) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(content u8 [T], sizes i32 [N]) on the device -> (y, u, v) uint8
    planes on it. Raises BitstreamError naming the first bad block."""
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    y, u, v, err = decode.decode_idct_blocks(content, sizes, offsets,
                                             qtables, dct, h, w)
    _raise_first_bad(err, "Huffman decode")
    return y, u, v


def decompress_streams_to_frame(streams: Sequence[Stream],
                                qtables: torch.Tensor, dct: torch.Tensor,
                                h: int, w: int
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Per-plane (sizes u8, content u8) -> (y, u, v) uint8 planes, decoded
    on ``qtables.device``. A plane whose content is shorter than its chunk
    sizes add up to is rejected, as the host decoder rejects it."""
    contents = []
    for s, c in streams:
        need = int(s.sum(dtype=np.int64))
        if need > c.size:
            raise BitstreamError(
                "content buffer shorter than chunk sizes imply")
        contents.append(c[:need])
    dev = qtables.device
    sizes = torch.from_numpy(np.concatenate([s for s, _ in streams]))
    sizes = sizes.to(dev).to(torch.int32)
    content = torch.from_numpy(np.concatenate(contents)).to(dev)
    y, u, v = decompress_frame(content, sizes, qtables, dct, h, w)
    return y.cpu().numpy(), u.cpu().numpy(), v.cpu().numpy()
