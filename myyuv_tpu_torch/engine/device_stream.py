"""Frame and batch codec on the device: planes up once, file bytes down once.

Port of ``myyuv_tpu/engine/device_stream.py`` in block-major form. Two
routes give the same bytes and pixels:

  fused (default):
    compress:   planes --h2d--> K1 (dct_encode_blocks) -> lanes, sizes
                -> on-device compaction to the exact on-disk byte stream
                --d2h--> sizes, content -> per-plane split
    decompress: sizes, content (as the file holds them) --h2d-->
                offsets = cumsum(sizes) on the device -> K2
                (decode_idct_blocks) -> planes --d2h-->
  staged (``fused=False``; the JAX flat route and two-kernel decompress):
    compress:   K3 (dct_quantize_blocks) -> [N, 64] i16 coefficients -> K5
                (encode_blocks) -> lanes, sizes -> the same compaction
    decompress: offsets -> K6 (decode_blocks) -> coefficients -> K4
                (dequantize_idct_blocks) -> planes

The compaction is a row-major mask select of the 256-byte lanes
(``lanes[arange(256) < sizes[:, None]]``), so the chunks come out back to
back in block order — the TPU package's continuation-word tiers, its A/C
interchange regions and the host repack/expand steps have no counterpart.
A mask select's size depends on the data, so it waits for the card; the
entries that must not (``encode_frame``, ``ingest_frame``,
``roundtrip_frame``, ``preview_frame``, the streaming drivers of
``engine/streaming.py``) scatter the chunks into a buffer of the
worst-case size instead (``scatter_chunks``), or decode straight from the
lanes (offsets 256 * b), and keep ``total`` and ``ok`` on the device.

Capture and playback (``ingest_frame``, ``preview_frame``; the JAX
package's ``word_frame.ingest_frame`` / ``preview_frame``): X1
(``kernels/convert.py``) then K1, and K2 then X2, two launches each.

Blocks are ordered Y raster, then U, then V (DCT.cpp:112-173). A batch of B
frames ([B, H, W] and 2x [B, H/2, W/2], contiguous) is coded as one frame of
B*H rows, which gives the JAX package's plane-major batch order (all Y,
then all U, then all V, frames contiguous within each region) with no
kernel of its own.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..entropy import decode, encode
from ..entropy.device import LANE
from ..kernels import convert, transform
from ..kernels.device import plane_block_counts
from ..runtime.errors import BitstreamError

Stream = Tuple[np.ndarray, np.ndarray]  # (chunk sizes u8, content u8)


def _raise_first_bad(err: torch.Tensor, what: str) -> None:
    bad = torch.nonzero(err).flatten()
    if bad.numel():
        b = int(bad[0])
        raise BitstreamError(f"{what} failed at block {b} "
                             f"(code {int(err[b])})")


def compact_chunks(lanes: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """[N, 256] lanes -> the chunks back to back in block order (a
    row-major mask select, on the lanes' device)."""
    col = torch.arange(lanes.shape[1], device=lanes.device)
    return lanes[col[None, :] < sizes[:, None]]


def scatter_chunks(lanes: torch.Tensor, sizes: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, 256] lanes -> (content u8 [N * 255], total i64 scalar): the
    chunks back to back in block order in ``content[:total]``. No host
    sync: the buffer has the worst-case size (a chunk holds at most 255
    bytes; an err chunk's lane is zero and takes no room).

    Works on 8-byte words: lane b, shifted by its start's byte offset
    within a word, is added into the 33 words from its start on. A lane is
    zero past its chunk's size (K1's, K5's and the plain encoder's
    contract) and the chunks do not overlap, so the bytes added into a
    word never share a bit: the sums are the bytes, with no carries."""
    n, lane = lanes.shape
    dev = lanes.device
    live = torch.where(sizes < lane, sizes, 0).to(torch.int64)
    starts = torch.cumsum(live, 0) - live
    shift = (starts % 8 * 8)[:, None]              # bits, 0..56
    words = lanes.view(torch.int64)                # [N, 32] little-endian
    lo = words << shift                            # into the start's word
    top = (words >> (64 - shift)) & ((torch.ones_like(shift) << shift) - 1)
    hi = torch.where(shift == 0, 0, top)           # into the next word
    zero = words.new_zeros(n, 1)
    spread = torch.cat([lo, zero], 1) | torch.cat([zero, hi], 1)
    idx = (starts // 8)[:, None] + torch.arange(lane // 8 + 1, device=dev)
    cap = n * (lane - 1)
    out = torch.zeros(cap // 8 + lane // 8 + 2, dtype=torch.int64,
                      device=dev)
    out.index_add_(0, idx.view(-1), spread.view(-1))
    return out.view(torch.uint8)[:cap], sizes.sum(dtype=torch.int64)


def _encode(y, u, v, qtables, dct, fused: bool):
    """Planes -> (sizes i32 [N], content u8 [T], err i32 [N])."""
    if fused:
        lanes, sizes, err = encode.dct_encode_blocks(y, u, v, qtables, dct)
    else:
        lanes, sizes, err = encode.encode_blocks(
            transform.dct_quantize_blocks(y, u, v, qtables, dct))
    return sizes, compact_chunks(lanes, sizes), err


def _decode(content, sizes, qtables, dct, h, w, fused: bool):
    """(content, sizes) -> (y, u, v, err i32 [N])."""
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    if fused:
        return decode.decode_idct_blocks(content, sizes, offsets, qtables,
                                         dct, h, w)
    coeffs, err = decode.decode_blocks(content, sizes, offsets)
    return (*transform.dequantize_idct_blocks(coeffs, qtables, dct, h, w),
            err)


def compress_frame(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   qtables: torch.Tensor, dct: torch.Tensor,
                   fused: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device planes -> (sizes i32 [N], content u8 [T]) on the same device:
    the chunks of all blocks back to back, exactly as the file stores
    them. ``fused=False`` takes the staged route (K3 then K5)."""
    sizes, content, err = _encode(y, u, v, qtables, dct, fused)
    _raise_first_bad(err, "Huffman encode")
    return sizes, content


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


def to_device(planes: Sequence[np.ndarray], dev: torch.device):
    """Host arrays -> contiguous tensors on ``dev``."""
    return [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
            for p in planes]


def compress_frame_to_streams(planes: Sequence[np.ndarray],
                              qtables: torch.Tensor, dct: torch.Tensor,
                              fused: bool = True) -> List[Stream]:
    """(y, u, v) uint8 planes -> [(sizes u8, content u8)] per plane, coded
    on ``qtables.device``."""
    sizes, content = compress_frame(*to_device(planes, qtables.device),
                                    qtables, dct, fused)
    return split_planes(sizes.cpu().numpy(), content.cpu().numpy(),
                        *planes[0].shape)


def decompress_frame(content: torch.Tensor, sizes: torch.Tensor,
                     qtables: torch.Tensor, dct: torch.Tensor, h: int,
                     w: int, fused: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(content u8 [T], sizes i32 [N]) on the device -> (y, u, v) uint8
    planes on it. Raises BitstreamError naming the first bad block.
    ``fused=False`` takes the staged route (K6 then K4)."""
    y, u, v, err = _decode(content, sizes, qtables, dct, h, w, fused)
    _raise_first_bad(err, "Huffman decode")
    return y, u, v


def streams_to_device(streams: Sequence[Stream], dev: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-plane (sizes u8, content u8) -> (content u8 [T], sizes i32 [N])
    on ``dev``, the planes' chunks back to back. A plane whose content is
    shorter than its chunk sizes add up to is rejected, as the host decoder
    rejects it."""
    contents = []
    for s, c in streams:
        need = int(s.sum(dtype=np.int64))
        if need > c.size:
            raise BitstreamError(
                "content buffer shorter than chunk sizes imply")
        contents.append(c[:need])
    sizes = torch.from_numpy(np.concatenate([s for s, _ in streams]))
    sizes = sizes.to(dev).to(torch.int32)
    content = torch.from_numpy(np.concatenate(contents)).to(dev)
    return content, sizes


def decompress_streams_to_frame(streams: Sequence[Stream],
                                qtables: torch.Tensor, dct: torch.Tensor,
                                h: int, w: int, fused: bool = True
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Per-plane (sizes u8, content u8) -> (y, u, v) uint8 planes, decoded
    on ``qtables.device`` (``streams_to_device``'s checks)."""
    content, sizes = streams_to_device(streams, qtables.device)
    y, u, v = decompress_frame(content, sizes, qtables, dct, h, w, fused)
    return y.cpu().numpy(), u.cpu().numpy(), v.cpu().numpy()


# ---------------------------------------------------------------------------
# Batched multi-frame API: B frames per kernel launch, plane-major blocks
# ---------------------------------------------------------------------------


def as_one_frame(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Contiguous [..., H, W] + 2x [..., H/2, W/2] planes -> views of one
    frame of prod(...) * H rows, whose raster blocks are the plane-major
    batch order. Raises ValueError on other shapes or strides, and unless
    H and W are multiples of 16 (else chroma blocks would straddle
    frames)."""
    *lead, h, w = y.shape
    if h % 16 or w % 16:
        raise ValueError("frame height and width must be multiples of 16")
    for name, t, shape in (("y", y, (*lead, h, w)),
                           ("u", u, (*lead, h // 2, w // 2)),
                           ("v", v, (*lead, h // 2, w // 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return y.view(-1, w), u.view(-1, w // 2), v.view(-1, w // 2)


def compress_batch(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   qtables: torch.Tensor, dct: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] (+2x [B, H/2, W/2]) uint8 on the device -> (sizes i32
    [B*Nf], content u8 [T]) on it, blocks plane-major. Raises
    BitstreamError naming the first bad block."""
    return compress_frame(*as_one_frame(y, u, v), qtables, dct)


def decompress_batch(content: torch.Tensor, sizes: torch.Tensor,
                     qtables: torch.Tensor, dct: torch.Tensor, b: int,
                     h: int, w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A batch's plane-major (content, sizes) -> ([B, H, W], 2x
    [B, H/2, W/2]) uint8 planes on the device. Raises BitstreamError
    naming the first bad block."""
    y, u, v = decompress_frame(content, sizes, qtables, dct, b * h, w)
    return (y.view(b, h, w), u.view(b, h // 2, w // 2),
            v.view(b, h // 2, w // 2))


def roundtrip_frame(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    qtables: torch.Tensor, dct: torch.Tensor):
    """Compress + decompress on the device -> (ry, ru, rv, total bytes,
    ok), total and ok as device scalars — the transcode / RD-loop entry.
    K2 decodes K1's lanes in place (offsets 256 * b), so nothing waits for
    the card: no compaction, no host sync."""
    h, w = y.shape
    lanes, sizes, cerr = encode.dct_encode_blocks(y, u, v, qtables, dct)
    offsets = torch.arange(sizes.numel(), dtype=torch.int64,
                           device=lanes.device) * LANE
    ry, ru, rv, derr = decode.decode_idct_blocks(lanes.view(-1), sizes,
                                                 offsets, qtables, dct, h, w)
    ok = ~(cerr.any() | derr.any())
    return ry, ru, rv, sizes.sum(dtype=torch.int64), ok


def encode_frame(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 qtables: torch.Tensor, dct: torch.Tensor):
    """Planes on the device -> (sizes i32 [N], content u8 [N * 255], total
    i64, ok bool) on it: K1, then ``scatter_chunks``; the frame's on-disk
    chunk stream is ``content[:total]``. ``total`` and ``ok`` are device
    scalars: no host sync."""
    lanes, sizes, err = encode.dct_encode_blocks(y, u, v, qtables, dct)
    content, total = scatter_chunks(lanes, sizes)
    return sizes, content, total, ~err.any()


def ingest_frame(pixels: torch.Tensor, qtables: torch.Tensor,
                 dct: torch.Tensor):
    """The capture step: BGRX pixels [..., H, W, 4] (H and W multiples of
    16) on the device -> X1 -> K1 -> (sizes, content, total, ok) as
    ``encode_frame`` returns them; a batch is coded as one frame of
    prod(...) * H rows (plane-major blocks). No host sync."""
    return encode_frame(*as_one_frame(*convert.bgrx_to_iyuv(pixels)),
                        qtables, dct)


def preview_frame(content: torch.Tensor, sizes: torch.Tensor,
                  qtables: torch.Tensor, dct: torch.Tensor, h: int, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The playback step: a frame's chunk stream (content u8 [T], sizes i32
    [N]) on the device -> K2 -> X2 -> (BGRX u8 [H, W, 4], ok bool device
    scalar). No host sync; a bad chunk's block decodes to zero pixels and
    ``ok`` is False."""
    *planes, err = _decode(content, sizes, qtables, dct, h, w, True)
    return convert.iyuv_to_bgrx(*planes), ~err.any()


def roundtrip_batch(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    qtables: torch.Tensor, dct: torch.Tensor):
    """Round trip of a [B, ...] frame batch -> ((ry, ru, rv) [B, ...],
    total compressed bytes, ok), all on the device."""
    b, h, w = y.shape
    ry, ru, rv, total, ok = roundtrip_frame(*as_one_frame(y, u, v), qtables,
                                            dct)
    return ((ry.view(b, h, w), ru.view(b, h // 2, w // 2),
             rv.view(b, h // 2, w // 2)), total, ok)


def batch_streams_split(sizes_np: np.ndarray, packed: np.ndarray, b: int,
                        ny: int, nc: int) -> List[List[Stream]]:
    """Split a batch's plane-major (sizes, content) into per-frame
    [(sizes u8, content u8) x3]."""
    boffs = np.cumsum(sizes_np.astype(np.int64)) - sizes_np
    frames = [[] for _ in range(b)]
    pbase = 0
    for npl in (ny, nc, nc):
        for f in range(b):
            lo = pbase + f * npl
            s = sizes_np[lo:lo + npl]
            base = int(boffs[lo])
            frames[f].append(
                (s.astype(np.uint8),
                 packed[base:base + int(s.astype(np.int64).sum())]))
        pbase += b * npl
    return frames


def compress_batch_to_streams(planes: Sequence[np.ndarray],
                              qtables: torch.Tensor, dct: torch.Tensor
                              ) -> List[List[Stream]]:
    """Batched (y [B, H, W], u, v [B, H/2, W/2]) uint8 planes -> per-frame
    [(sizes u8, content u8) x3] (file layout), coded on
    ``qtables.device``."""
    b, h, w = planes[0].shape
    sizes, content = compress_batch(*to_device(planes, qtables.device),
                                    qtables, dct)
    ny, nc, _ = plane_block_counts(h, w)
    return batch_streams_split(sizes.cpu().numpy(), content.cpu().numpy(),
                               b, ny, nc)
