"""Frame and batch codec on the device: planes up once, file bytes down once.

Port of ``myyuv_tpu/engine/device_stream.py`` in block-major form. One
route a precision:

  compress:   planes --h2d--> K1 (dct_encode_blocks) -> lanes, sizes
              -> on-device compaction to the exact on-disk byte stream
              --d2h--> sizes, content -> per-plane split
  decompress: sizes, content (as the file holds them) --h2d-->
              offsets = cumsum(sizes) on the device -> K2
              (decode_idct_blocks) -> planes --d2h-->

The compaction is C1 (``csrc/compact_chunks.cu``, wrapper
``compact_chunks``; the plain version ``compact_chunks_plain`` is the
row-major mask select ``lanes[arange(256) < sizes[:, None]]``): a warp
copies the live bytes of 32 consecutive lanes to their starts, the
cumulative sum of the sizes, so the chunks come out back to back in block
order -- the TPU package's continuation-word tiers, its A/C interchange
regions and the host repack/expand steps have no counterpart. The stream's
length depends on the data, so ``compact_chunks`` queues C1 into a buffer
of the worst-case size, then reads the total and the encoder's error flag
to the host in one copy (one sync a compress call) and returns the stream
as the buffer's first ``total`` bytes; a decompress call reads its
decoder's error flag (one sync). The entries that must not wait
(``encode_frame``, ``ingest_frame``, ``roundtrip_frame``,
``preview_frame``, the streaming drivers of ``engine/streaming.py``) run
the same kernel into a zeroed buffer of the worst-case size
(``scatter_chunks``), or decode straight from the lanes (offsets 256 * b),
and keep ``total`` and ``ok`` on the device.

Capture and playback (``ingest_frame``, ``preview_frame``; the JAX
package's ``word_frame.ingest_frame`` / ``preview_frame``): X1
(``kernels/convert.py``) then K1, and K2 then X2, two launches each.
``play_frame`` is the playback step of ``streaming.decompress_stream``: a
frame staged as its file holds it, one-byte sizes then chunks, in one
buffer whose length alone sets what the step allocates.

K frames a call (``roundtrip_scan``, the JAX package's ``lax.scan`` of
``roundtrip_frame``): the K frames coded as one frame, as a batch is, with
each frame's total and ok reduced from its own blocks.

``precision="fast"`` (the entries whose JAX counterparts take it; default
"exact", any other value raises ValueError) splits each kernel in two,
with the fast transforms, as the JAX package's ``fast`` never enters its
packed or fused kernels (``myyuv_tpu/engine/device_stream.py:188, 477``):
F1 (``transform.fast_dct_quantize_blocks``) then K5 (``encode_blocks``)
to compress, K6 (``decode_blocks``) then F2
(``fast_dequantize_idct_blocks``) to decompress. Coefficients and pixels
are within +-1 of exact; the streams are ordinary ``.myyuv`` DCT streams,
which decode with either precision.

Blocks are ordered Y raster, then U, then V (DCT.cpp:112-173). A batch of B
frames ([B, H, W] and 2x [B, H/2, W/2], contiguous) is coded as one frame of
B*H rows, which gives the JAX package's plane-major batch order (all Y,
then all U, then all V, frames contiguous within each region) with no
kernel of its own.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..entropy import decode, encode
from ..entropy.device import LANE
from ..kernels import build, convert, transform
from ..kernels import device as kdev
from ..kernels.device import plane_block_counts
from ..runtime import trace
from ..runtime.errors import BitstreamError

Stream = Tuple[np.ndarray, np.ndarray]  # (chunk sizes u8, content u8)


def _raise_first_bad(err: torch.Tensor, what: str) -> None:
    """The error path, taken once a flag read on the host says ``err``
    holds a nonzero code: search for the first bad block (``wait.err``;
    counter ``err.search``) and raise BitstreamError naming it."""
    trace.add("err.search", 1)
    with trace.span("wait.err"):
        b = int(torch.nonzero(err)[0, 0])
        raise BitstreamError(f"{what} failed at block {b} "
                             f"(code {int(err[b])})")


def _check_err(err: torch.Tensor, what: str) -> None:
    """Raise BitstreamError naming the first bad block of ``err``, if
    any: one reduction and one read of its flag (``wait.err``), and the
    search only when the flag is set."""
    with trace.span("wait.err"):
        bad = bool(err.any())
    if bad:
        _raise_first_bad(err, what)


def compact_chunks_plain(lanes: torch.Tensor, sizes: torch.Tensor
                         ) -> torch.Tensor:
    """The plain PyTorch version of the compaction: a row-major mask
    select. Block b gives its first ``clamp(sizes[b], 0, 256)`` lane
    bytes."""
    col = torch.arange(lanes.shape[1], device=lanes.device)
    return lanes[col[None, :] < sizes[:, None]]


def _check_lanes(lanes: torch.Tensor, sizes: torch.Tensor) -> int:
    """Raise ValueError unless ``lanes`` is contiguous u8 [N, 256] and
    ``sizes`` [N] lies on its device; return N."""
    n = lanes.shape[0] if lanes.dim() == 2 else -1
    build.check_tensors(lanes.device, ("lanes", lanes, (n, LANE),
                                       torch.uint8))
    if tuple(sizes.shape) != (n,) or sizes.device != lanes.device:
        raise ValueError(f"sizes: want [{n}] on {lanes.device}, got "
                         f"{list(sizes.shape)} on {sizes.device}")
    return n


def _launch_compact(lanes: torch.Tensor, live: torch.Tensor,
                    ends: torch.Tensor, out: torch.Tensor) -> None:
    """C1 (``csrc/compact_chunks.cu``): block b's first ``live[b]`` lane
    bytes (int32, 0..256) to ``out[ends[b] - live[b]:]``, ``ends`` (int64)
    the inclusive cumulative sum of ``live``; nothing else of ``out`` is
    written."""
    build.launch("compact_chunks", lanes.device, lanes.data_ptr(),
                 live.data_ptr(), ends.data_ptr(), lanes.shape[0],
                 out.data_ptr())


def compact_chunks(lanes: torch.Tensor, sizes: torch.Tensor,
                   err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, 256] lanes -> content u8 [T], the chunks back to back in block
    order on the lanes' device: block b gives its first
    ``clamp(sizes[b], 0, 256)`` bytes (an err block of size >= 256 all of
    its zero lane), byte for byte the mask select
    ``compact_chunks_plain``. ``err``, the encoder's codes (i32 [N]), when
    given: a nonzero code raises BitstreamError naming the first bad block
    (``_raise_first_bad``).

    On a CUDA device: the sizes clamped, their cumulative sum, an
    any-error flag after it, C1 launched into an uninitialised buffer of
    N * 256 bytes, then one read of the total and the flag together (the
    one host sync, ``wait.size``); ``content`` is a view of the buffer's
    first T bytes. The counter ``compact.bytes`` adds the total. On the
    CPU: the plain version and the flag under the one ``wait.size``."""
    n = _check_lanes(lanes, sizes)
    if build.on_cpu(lanes.device, "compact_chunks"):
        with trace.span("wait.size"):
            out = compact_chunks_plain(lanes, sizes)
            bad = err is not None and bool(err.any())
    else:
        live = sizes.clamp(0, LANE).to(torch.int32)
        # ends, then the flag in the next byte (unset without err): the
        # total and the flag side by side, read in one copy of 9 bytes
        ends = torch.empty(n + 1, dtype=torch.int64, device=lanes.device)
        torch.cumsum(live, 0, dtype=torch.int64, out=ends[:n])
        raw = ends.view(torch.uint8)
        if err is not None:
            torch.any(err, 0, out=raw[8 * n].view(torch.bool))
        out = torch.empty(n * LANE, dtype=torch.uint8, device=lanes.device)
        _launch_compact(lanes, live, ends, out)
        with trace.span("wait.size"):
            head = bytes(raw[8 * n - 8:8 * n + 1].tolist()) if n else bytes(9)
        total = int.from_bytes(head[:8], "little")
        bad = err is not None and head[8] != 0
        out = out[:total]
        trace.add("compact.bytes", total)
    if bad:
        _raise_first_bad(err, "Huffman encode")
    return out


def scatter_chunks(lanes: torch.Tensor, sizes: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, 256] lanes -> (content u8 [N * 255], total i64 scalar): the
    chunks back to back in block order in ``content[:total]``, zeros after
    them; ``total`` is ``sizes.sum()``. No host sync: the buffer has the
    worst-case size (a chunk holds at most 255 bytes; an err chunk, of size
    past 255, and a negative size take no room).

    On a CUDA device C1 writes the live chunks into the zeroed buffer at
    starts summed on the device; on the CPU the plain version's bytes go
    to its front."""
    n = _check_lanes(lanes, sizes)
    live = torch.where(sizes < LANE, sizes, 0).clamp_(min=0).to(torch.int32)
    out = torch.zeros(n * (LANE - 1), dtype=torch.uint8, device=lanes.device)
    if build.on_cpu(lanes.device, "compact_chunks"):
        chunks = compact_chunks_plain(lanes, live)
        out[:chunks.numel()] = chunks
    else:
        _launch_compact(lanes, live, torch.cumsum(live, 0, dtype=torch.int64),
                        out)
    return out, sizes.sum(dtype=torch.int64)


def frame_lanes(y, u, v, qtables, dct, precision: str = "exact"):
    """Planes -> (lanes u8 [N, 256], sizes i32 [N], err i32 [N]): K1, or
    F1 then K5 with ``precision="fast"``."""
    if not kdev.is_fast(precision):
        return encode.dct_encode_blocks(y, u, v, qtables, dct)
    return encode.encode_blocks(transform.dct_quantize_blocks(
        y, u, v, qtables, dct, precision))


def frame_planes(content, sizes, offsets, qtables, dct, h, w,
                 precision: str = "exact"):
    """Chunks at ``offsets`` -> (y, u, v, err i32 [N]): K2, or K6 then F2
    with ``precision="fast"``."""
    if not kdev.is_fast(precision):
        return decode.decode_idct_blocks(content, sizes, offsets, qtables,
                                         dct, h, w)
    coeffs, err = decode.decode_blocks(content, sizes, offsets)
    return (*transform.dequantize_idct_blocks(coeffs, qtables, dct, h, w,
                                              precision), err)


def _decode(content, sizes, qtables, dct, h, w, precision: str = "exact"):
    """(content, sizes) -> (y, u, v, err i32 [N])."""
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    return frame_planes(content, sizes, offsets, qtables, dct, h, w,
                        precision)


def compress_frame(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   qtables: torch.Tensor, dct: torch.Tensor,
                   precision: str = "exact"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device planes -> (sizes i32 [N], content u8 [T]) on the same device:
    the chunks of all blocks back to back, exactly as the file stores
    them (on a CUDA device a view of ``compact_chunks``' buffer). Raises
    BitstreamError naming the first bad block; one host sync.
    ``precision="fast"``: F1 then K5."""
    with trace.span("stream.compress_frame"):
        return _compress(y, u, v, qtables, dct, precision)


def _compress(y, u, v, qtables, dct, precision: str):
    """``compress_frame``'s body, also ``compress_batch``'s: a batch entry
    records its frame entry's span around its own work too, and spans of
    one name must not nest."""
    lanes, sizes, err = frame_lanes(y, u, v, qtables, dct, precision)
    return sizes, compact_chunks(lanes, sizes, err)


def split_planes(sizes: np.ndarray, content: np.ndarray, h: int, w: int,
                 totals: Optional[Sequence[int]] = None) -> List[Stream]:
    """A frame's (sizes, content) -> [(sizes u8, content u8)] per plane;
    ``totals``, the planes' content bytes, are summed from the sizes when
    not given."""
    with trace.span("stream.split"):
        out, lo, pos = [], 0, 0
        for i, n in enumerate(plane_block_counts(h, w)):
            s = sizes[lo:lo + n]
            t = int(s.sum(dtype=np.int64)) if totals is None else totals[i]
            out.append((s.astype(np.uint8), content[pos:pos + t]))
            lo, pos = lo + n, pos + t
        return out


def _upload(t: torch.Tensor, dev) -> torch.Tensor:
    """A host tensor on ``dev``: one pageable copy to a CUDA device, which
    waits for the card (``wait.h2d``; its bytes in
    ``pageable_bytes.h2d``)."""
    with trace.span("wait.h2d"):
        if torch.device(dev).type == "cuda":
            trace.add("pageable_bytes.h2d", t.nbytes)
        return t.to(dev)


def to_device(planes: Sequence[np.ndarray], dev: torch.device):
    """Host arrays -> contiguous tensors on ``dev``, one pageable upload
    each (``wait.h2d``)."""
    return [_upload(torch.from_numpy(np.ascontiguousarray(p)), dev)
            for p in planes]


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host array: one pageable copy from a CUDA
    device, which waits for the card (``wait.d2h``; its bytes in
    ``pageable_bytes.d2h``)."""
    with trace.span("wait.d2h"):
        if t.is_cuda:
            trace.add("pageable_bytes.d2h", t.nbytes)
        return t.cpu().numpy()


def compress_frame_to_streams(planes: Sequence[np.ndarray],
                              qtables: torch.Tensor, dct: torch.Tensor,
                              precision: str = "exact") -> List[Stream]:
    """(y, u, v) uint8 planes -> [(sizes u8, content u8)] per plane, coded
    on ``qtables.device`` (``compress_frame``'s routes)."""
    sizes, content = compress_frame(*to_device(planes, qtables.device),
                                    qtables, dct, precision)
    return split_planes(to_host(sizes), to_host(content), *planes[0].shape)


def decompress_frame(content: torch.Tensor, sizes: torch.Tensor,
                     qtables: torch.Tensor, dct: torch.Tensor, h: int,
                     w: int, precision: str = "exact"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(content u8 [T], sizes i32 [N]) on the device -> (y, u, v) uint8
    planes on it. Raises BitstreamError naming the first bad block.
    ``precision="fast"``: K6 then F2."""
    with trace.span("stream.decompress_frame"):
        return _decompress(content, sizes, qtables, dct, h, w, precision)


def _decompress(content, sizes, qtables, dct, h, w, precision: str):
    """``decompress_frame``'s body, also ``decompress_batch``'s."""
    y, u, v, err = _decode(content, sizes, qtables, dct, h, w, precision)
    _check_err(err, "Huffman decode")
    return y, u, v


def plane_chunks(streams: Sequence[Stream]) -> List[np.ndarray]:
    """Per-plane (sizes u8, content u8) -> each plane's content cut to the
    bytes its chunk sizes add up to. A plane whose content is shorter is
    rejected (BitstreamError), as the host decoder rejects it."""
    contents = []
    for s, c in streams:
        # a u32 sum is exact below 2**24 sizes and ~3x faster than an i64
        need = int(s.sum(dtype=np.uint32 if s.size <= 1 << 24 else np.int64))
        if need > c.size:
            raise BitstreamError(
                "content buffer shorter than chunk sizes imply")
        contents.append(c[:need])
    return contents


def check_streams(streams: Sequence[Stream], h: int, w: int
                  ) -> List[np.ndarray]:
    """``plane_chunks`` of an h x w frame's streams, after checking that
    there are three planes of u8 arrays, plane i holding
    ``plane_block_counts(h, w)[i]`` sizes (ValueError otherwise)."""
    counts = plane_block_counts(h, w)
    got = [int(np.size(s)) for s, _ in streams]
    if got != list(counts):
        raise ValueError(f"a {h}x{w} frame has {list(counts)} blocks a "
                         f"plane, the streams {got}")
    if any(a.dtype != np.uint8 for stream in streams for a in stream):
        raise ValueError("plane streams must be uint8 sizes and content")
    return plane_chunks(streams)


def streams_to_device(streams: Sequence[Stream], dev: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-plane (sizes u8, content u8) -> (content u8 [T], sizes i32 [N])
    on ``dev``, the planes' chunks back to back (``plane_chunks``'
    check)."""
    contents = plane_chunks(streams)
    sizes = _upload(torch.from_numpy(np.concatenate([s for s, _ in streams])),
                   dev).to(torch.int32)
    content = _upload(torch.from_numpy(np.concatenate(contents)), dev)
    return content, sizes


def decompress_streams_to_frame(streams: Sequence[Stream],
                                qtables: torch.Tensor, dct: torch.Tensor,
                                h: int, w: int, precision: str = "exact"
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Per-plane (sizes u8, content u8) -> (y, u, v) uint8 planes, decoded
    on ``qtables.device`` (``streams_to_device``'s checks;
    ``decompress_frame``'s routes)."""
    content, sizes = streams_to_device(streams, qtables.device)
    y, u, v = decompress_frame(content, sizes, qtables, dct, h, w, precision)
    return to_host(y), to_host(u), to_host(v)


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
                   qtables: torch.Tensor, dct: torch.Tensor,
                   precision: str = "exact"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] (+2x [B, H/2, W/2]) uint8 on the device -> (sizes i32
    [B*Nf], content u8 [T]) on it, blocks plane-major, as
    ``compress_frame`` returns them. Raises BitstreamError naming the
    first bad block. ``precision="fast"``: F1 then K5."""
    with trace.span("stream.compress_frame"):
        return _compress(*as_one_frame(y, u, v), qtables, dct, precision)


def decompress_batch(content: torch.Tensor, sizes: torch.Tensor,
                     qtables: torch.Tensor, dct: torch.Tensor, b: int,
                     h: int, w: int, precision: str = "exact"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A batch's plane-major (content, sizes) -> ([B, H, W], 2x
    [B, H/2, W/2]) uint8 planes on the device. Raises BitstreamError
    naming the first bad block. ``precision="fast"``: K6 then F2."""
    with trace.span("stream.decompress_frame"):
        y, u, v = _decompress(content, sizes, qtables, dct, b * h, w,
                              precision)
        return (y.view(b, h, w), u.view(b, h // 2, w // 2),
                v.view(b, h // 2, w // 2))


def roundtrip_frame(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    qtables: torch.Tensor, dct: torch.Tensor,
                    precision: str = "exact"):
    """Compress + decompress on the device -> (ry, ru, rv, total bytes,
    ok), total and ok as device scalars — the transcode / RD-loop entry.
    K2 decodes K1's lanes in place (offsets 256 * b), so nothing waits for
    the card: no compaction, no host sync. ``precision="fast"``: F1 and K5,
    then K6 on K5's lanes in place and F2."""
    with trace.span("stream.roundtrip_frame"):
        return _roundtrip(y, u, v, qtables, dct, precision)


def _roundtrip(y, u, v, qtables, dct, precision: str):
    """``roundtrip_frame``'s body, also ``roundtrip_batch``'s."""
    ry, ru, rv, sizes, cerr, derr = _roundtrip_blocks(y, u, v, qtables, dct,
                                                      precision)
    ok = ~(cerr.any() | derr.any())
    return ry, ru, rv, sizes.sum(dtype=torch.int64), ok


def _roundtrip_blocks(y, u, v, qtables, dct, precision: str):
    """Planes -> (ry, ru, rv, sizes i32 [N], cerr i32 [N], derr i32 [N]):
    K1 (F1 and K5 when fast), then K2 (K6 and F2) on its lanes in place
    (offsets 256 * b)."""
    h, w = y.shape
    lanes, sizes, cerr = frame_lanes(y, u, v, qtables, dct,
                                     precision=precision)
    offsets = torch.arange(sizes.numel(), dtype=torch.int64,
                           device=lanes.device) * LANE
    ry, ru, rv, derr = frame_planes(lanes.view(-1), sizes, offsets,
                                    qtables, dct, h, w, precision=precision)
    return ry, ru, rv, sizes, cerr, derr


def roundtrip_scan(ys: torch.Tensor, us: torch.Tensor, vs: torch.Tensor,
                   qtables: torch.Tensor, dct: torch.Tensor,
                   precision: str = "exact"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K whole-frame round trips of stacked frames ([K, H, W] and
    2x [K, H/2, W/2] u8, contiguous; qtables [3, 8, 8] and dct [8, 8] f32
    on their device; H and W positive multiples of 16, else ValueError) ->
    (totals i64 [K], oks bool [K]) on their device, equal to K calls of
    ``roundtrip_frame`` — the counterpart of the JAX package's ``lax.scan``
    executable. The stack is coded as one frame of K * H rows, as a batch
    is (K1 and K2 once a scan; F1, K5, K6 and F2 with
    ``precision="fast"``), and each frame's total and ok are reduced from
    its own blocks of the plane-major Y, U and V ranges. No host sync."""
    if ys.dim() != 3:
        raise ValueError("ys must be [K, H, W]")
    k, h, w = ys.shape
    transform.frame_blocks(h, w)
    build.check_tensors(
        ys.device, ("ys", ys, (k, h, w), torch.uint8),
        ("us", us, (k, h // 2, w // 2), torch.uint8),
        ("vs", vs, (k, h // 2, w // 2), torch.uint8),
        ("qtables", qtables, (3, 8, 8), torch.float32),
        ("dct", dct, (8, 8), torch.float32))
    if k == 0:
        return (torch.zeros(0, dtype=torch.int64, device=ys.device),
                torch.zeros(0, dtype=torch.bool, device=ys.device))
    with trace.span("stream.roundtrip_frame"):
        *_, sizes, cerr, derr = _roundtrip_blocks(
            *as_one_frame(ys, us, vs), qtables, dct, precision)
        ranges = [k * n for n in plane_block_counts(h, w)]

        def per_frame(x):  # [K * Nf] plane-major -> [K, Nf], frame-major
            return torch.cat([r.view(k, -1) for r in x.split(ranges)], 1)

        return (per_frame(sizes).sum(1, dtype=torch.int64),
                ~per_frame(cerr | derr).any(1))


def encode_frame(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 qtables: torch.Tensor, dct: torch.Tensor,
                 precision: str = "exact"):
    """Planes on the device -> (sizes i32 [N], content u8 [N * 255], total
    i64, ok bool) on it: K1 (F1 then K5 with ``precision="fast"``), then
    ``scatter_chunks``; the frame's on-disk chunk stream is
    ``content[:total]``. ``total`` and ``ok`` are device scalars: no host
    sync."""
    lanes, sizes, err = frame_lanes(y, u, v, qtables, dct,
                                    precision=precision)
    content, total = scatter_chunks(lanes, sizes)
    return sizes, content, total, ~err.any()


def ingest_frame(pixels: torch.Tensor, qtables: torch.Tensor,
                 dct: torch.Tensor):
    """The capture step: BGRX pixels [..., H, W, 4] (H and W multiples of
    16) on the device -> X1 -> K1 -> (sizes, content, total, ok) as
    ``encode_frame`` returns them; a batch is coded as one frame of
    prod(...) * H rows (plane-major blocks). No host sync."""
    return _ingest(pixels, qtables, dct)


def _ingest(pixels, qtables, dct, precision: str = "exact"):
    """``ingest_frame`` at ``precision`` (X1, then F1 and K5 when fast):
    the step of ``streaming.ingest_stream`` and of ``compress_stream`` on
    BGRX frames (span ``stream.ingest_frame``)."""
    with trace.span("stream.ingest_frame"):
        return encode_frame(*as_one_frame(*convert.bgrx_to_iyuv(pixels)),
                            qtables, dct, precision)


def preview_frame(content: torch.Tensor, sizes: torch.Tensor,
                  qtables: torch.Tensor, dct: torch.Tensor, h: int, w: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The playback step: a frame's chunk stream (content u8 [T], sizes i32
    [N]) on the device -> K2 -> X2 -> (BGRX u8 [H, W, 4], ok bool device
    scalar). No host sync; a bad chunk's block decodes to zero pixels and
    ``ok`` is False."""
    pixels, err = _preview(content, sizes, qtables, dct, h, w)
    return pixels, ~err.any()


def _preview(content, sizes, qtables, dct, h, w, precision: str = "exact"):
    """``preview_frame`` at ``precision`` (K6 and F2 when fast, then X2)
    -> (BGRX, err i32 [N]): the step of ``streaming.preview_stream`` and
    of ``play_frame``."""
    *planes, err = _decode(content, sizes, qtables, dct, h, w, precision)
    return convert.iyuv_to_bgrx(*planes), err


def play_frame(staged: torch.Tensor, n: int, qtables: torch.Tensor,
               dct: torch.Tensor, h: int, w: int, precision: str = "exact"
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The playback step of ``streaming.decompress_stream``: one u8 buffer
    on the device that holds a frame as its file does, its ``n`` one-byte
    chunk sizes, then its chunks back to back (bytes past them are never
    read) -> (BGRX u8 [H, W, 4], ok bool device scalar, err i32 [N]): the
    sizes' cast and offsets, K2 (K6 and F2 when fast), X2. What it
    allocates depends on the buffer's length and not on the chunks', so
    one CUDA graph can hold it for every frame staged into the buffer. No
    host sync; a bad chunk's block decodes to zero pixels."""
    pixels, err = _preview(staged[n:], staged[:n].to(torch.int32), qtables,
                           dct, h, w, precision)
    return pixels, ~err.any(), err


def roundtrip_batch(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    qtables: torch.Tensor, dct: torch.Tensor,
                    precision: str = "exact"):
    """Round trip of a [B, ...] frame batch -> ((ry, ru, rv) [B, ...],
    total compressed bytes, ok), all on the device (``roundtrip_frame``'s
    routes)."""
    b, h, w = y.shape
    with trace.span("stream.roundtrip_frame"):
        ry, ru, rv, total, ok = _roundtrip(*as_one_frame(y, u, v), qtables,
                                           dct, precision)
        return ((ry.view(b, h, w), ru.view(b, h // 2, w // 2),
                 rv.view(b, h // 2, w // 2)), total, ok)


def batch_streams_split(sizes_np: np.ndarray, packed: np.ndarray, b: int,
                        ny: int, nc: int) -> List[List[Stream]]:
    """Split a batch's plane-major (sizes, content) into per-frame
    [(sizes u8, content u8) x3]."""
    with trace.span("stream.split"):
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
                              qtables: torch.Tensor, dct: torch.Tensor,
                              precision: str = "exact"
                              ) -> List[List[Stream]]:
    """Batched (y [B, H, W], u, v [B, H/2, W/2]) uint8 planes -> per-frame
    [(sizes u8, content u8) x3] (file layout), coded on
    ``qtables.device`` (``compress_batch``'s routes)."""
    b, h, w = planes[0].shape
    sizes, content = compress_batch(*to_device(planes, qtables.device),
                                    qtables, dct, precision)
    ny, nc, _ = plane_block_counts(h, w)
    return batch_streams_split(to_host(sizes), to_host(content), b, ny, nc)
