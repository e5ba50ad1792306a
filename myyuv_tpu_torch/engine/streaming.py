"""Frames-in-flight streaming drivers: the card kept busy across frames.

Port of ``myyuv_tpu/engine/streaming.py`` (``roundtrip_stream``,
``ingest_stream``, ``preview_stream``, ``sustained_roundtrip_fps``,
``sustained_scan_fps``, ``sustained_pipeline_fps``, ``compress_stream``,
``compress_stream_timed``). Each driver queues every frame's kernels back
to back and waits for the card only where a result must reach the host:

* ``roundtrip_stream`` (the transcode / RD loop), ``ingest_stream`` (the
  capture pipeline: BGRX -> X1 -> K1) and ``preview_stream`` (the playback
  pipeline: stream -> K2 -> X2) keep each frame's ``ok`` and ``total`` on
  the card and bring them down once, at the drain: one ``torch.stack``,
  one d2h. Every step they run is free of host syncs (the round trip
  decodes K1's lanes in place, ingest compacts with ``scatter_chunks``);
* ``compress_stream`` (the capture loop with the bytes) copies each
  frame's sizes and flags into pinned host buffers with
  ``non_blocking=True`` and records one CUDA event per frame; with
  ``depth`` frames in flight it waits for the oldest frame's event alone,
  then pulls that frame's ``content[:total]`` on a side stream, so the
  pull does not wait for the frames queued behind it.

``roundtrip_scan_stream`` and ``sustained_scan_fps`` queue K frames a call
through ``device_stream.roundtrip_scan``: one CUDA graph replay of K
round trips a call.

The drivers whose JAX counterparts take ``precision`` take it too (default
"exact"; "fast" runs F1 then K5 to compress, K6 then F2 to decompress, as
``device_stream`` does; any other value raises ValueError).
``compress_stream_timed`` takes none, as its JAX counterpart.

Not ported: JAX's ``FLAG_CHUNK`` (one stack at the drain replaces the
chunked stacks), the cont ladder and its retries (the 256-byte lanes
always hold a chunk; ``err`` reports the rest, so
``sustained_roundtrip_fps`` has no ``retried_frames``). On tensors on the
CPU the drivers run the plain versions, with no events, no pinned buffers
and no graphs.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..kernels import convert
from ..runtime.errors import BitstreamError
from . import device_stream as ds


def _drain(*flags: List[torch.Tensor]) -> List[np.ndarray]:
    """Lists of per-frame device scalars (or per-scan [K] tensors) -> one
    int64 numpy array each, by one stack and one d2h."""
    if not flags[0]:
        return [np.zeros(0, np.int64) for _ in flags]
    both = torch.stack([torch.stack(f).to(torch.int64) for f in flags])
    return list(both.cpu().numpy())


def roundtrip_stream(frames: Iterable[Sequence[torch.Tensor]],
                     qtables: torch.Tensor, dct: torch.Tensor,
                     precision: str = "exact"):
    """Round trips of device-resident (y, u, v) frames, queued back to back
    with no host sync until the drain. Returns (ok [N] bool, totals [N]
    int64 compressed bytes, elapsed_s on the host clock)."""
    oks, totals = [], []
    t0 = time.perf_counter()
    for y, u, v in frames:
        *_, total, ok = ds.roundtrip_frame(y, u, v, qtables, dct, precision)
        oks.append(ok)
        totals.append(total)
    ok_np, tot_np = _drain(oks, totals)
    return ok_np.astype(bool), tot_np, time.perf_counter() - t0


def ingest_stream(frames_bgrx: Iterable[torch.Tensor], qtables: torch.Tensor,
                  dct: torch.Tensor, precision: str = "exact"):
    """The capture pipeline: BGRX device frames -> ``ds.ingest_frame`` (X1,
    K1, compaction; X1, F1 and K5 when fast), with no host sync until the
    drain. Returns (ok [N] bool, totals [N] int64, elapsed_s); the
    compressed streams are dropped (``compress_stream`` brings them
    down)."""
    oks, totals = [], []
    t0 = time.perf_counter()
    for px in frames_bgrx:
        _sizes, _content, total, ok = ds._ingest(px, qtables, dct, precision)
        oks.append(ok)
        totals.append(total)
    ok_np, tot_np = _drain(oks, totals)
    return ok_np.astype(bool), tot_np, time.perf_counter() - t0


def preview_stream(stream_dev: Tuple[torch.Tensor, torch.Tensor],
                   qtables: torch.Tensor, dct: torch.Tensor, h: int, w: int,
                   n_frames: int, precision: str = "exact"):
    """The playback pipeline: one frame's (content, sizes) on the device
    decoded and converted ``n_frames`` times (``ds.preview_frame``: K2,
    X2; K6, F2 and X2 when fast), with no host sync until the drain.
    Returns (ok [N] bool, elapsed_s)."""
    content, sizes = stream_dev
    oks = []
    t0 = time.perf_counter()
    for _ in range(n_frames):
        _px, ok = ds._preview(content, sizes, qtables, dct, h, w, precision)
        oks.append(ok)
    (ok_np,) = _drain(oks)
    return ok_np.astype(bool), time.perf_counter() - t0


def sustained_roundtrip_fps(planes_np: Sequence[np.ndarray],
                            qtables: torch.Tensor, dct: torch.Tensor,
                            n_frames: int = 112, windows: int = 2,
                            precision: str = "exact"):
    """Upload one frame to ``qtables.device`` and stream ``n_frames`` round
    trips of it, ``windows`` times after a warm run. Returns (fps of the
    headline window, ok, compressed bytes of the frame, stats): the
    headline is the window with the most frames ok, then the fastest;
    ``stats`` holds every window's fps and ok count (``windows_fps``,
    ``windows_ok``)."""
    frame = ds.to_device(planes_np, qtables.device)
    roundtrip_stream([frame], qtables, dct, precision)
    runs = [roundtrip_stream([frame] * n_frames, qtables, dct, precision)
            for _ in range(max(1, windows))]
    stats = {"windows_fps": [n_frames / e for _, _, e in runs],
             "windows_ok": [int(o.sum()) for o, _, _ in runs]}
    ok_np, tot_np, elapsed = max(runs,
                                 key=lambda r: (int(r[0].sum()), -r[2]))
    return n_frames / elapsed, bool(ok_np.all()), int(tot_np[0]), stats


def roundtrip_scan_stream(stacks: Iterable[Sequence[torch.Tensor]],
                          qtables: torch.Tensor, dct: torch.Tensor,
                          precision: str = "exact"):
    """Scans of device-resident K-frame stacks (ys [K, H, W], us, vs
    [K, H/2, W/2]), ``ds.roundtrip_scan`` each, queued back to back with no
    host sync until the drain. Returns (ok [n, K] bool, totals [n, K] int64
    compressed bytes, elapsed_s on the host clock)."""
    oks, totals = [], []
    t0 = time.perf_counter()
    for ys, us, vs in stacks:
        total, ok = ds.roundtrip_scan(ys, us, vs, qtables, dct, precision)
        oks.append(ok)
        totals.append(total)
    ok_np, tot_np = _drain(oks, totals)
    return ok_np.astype(bool), tot_np, time.perf_counter() - t0


def sustained_scan_fps(planes_np: Sequence[np.ndarray],
                       qtables: torch.Tensor, dct: torch.Tensor,
                       n_frames: int = 112, k: int = 8,
                       precision: str = "exact"):
    """Upload one frame to ``qtables.device``, stack it K times and run
    ceil(n_frames / K) scans of the stack (``roundtrip_scan_stream``) after
    one warm scan, which captures the graph. Returns (fps on the host clock,
    ok of every timed frame, compressed bytes of the frame)."""
    frame = ds.to_device(planes_np, qtables.device)
    stack = [p.expand(k, *p.shape).contiguous() for p in frame]
    roundtrip_scan_stream([stack], qtables, dct, precision)
    ok_np, tot_np, elapsed = roundtrip_scan_stream(
        [stack] * -(-n_frames // k), qtables, dct, precision)
    return ok_np.size / elapsed, bool(ok_np.all()), int(tot_np[0, 0])


def sustained_pipeline_fps(planes_np: Sequence[np.ndarray],
                           qtables: torch.Tensor, dct: torch.Tensor,
                           n_frames: int = 112, precision: str = "exact"):
    """Sustained fps of the capture and playback pipelines over one frame
    on ``qtables.device``: ingest (BGRX -> IYUV -> compress) of the frame's
    own X2 preview, and preview (its stream -> IYUV -> BGRX). Both run once
    before they are timed. Returns (ingest_fps, preview_fps, ok)."""
    frame = ds.to_device(planes_np, qtables.device)
    h, w = planes_np[0].shape
    px = convert.iyuv_to_bgrx(*frame)
    sizes, content = ds.compress_frame(*frame, qtables, dct,
                                       precision=precision)
    ok_w, _, _ = ingest_stream([px], qtables, dct, precision)
    ok_wp, _ = preview_stream((content, sizes), qtables, dct, h, w, 1,
                              precision)
    ok_i, _, t_i = ingest_stream([px] * n_frames, qtables, dct, precision)
    ok_p, t_p = preview_stream((content, sizes), qtables, dct, h, w,
                               n_frames, precision)
    ok = all(bool(o.all()) for o in (ok_w, ok_wp, ok_i, ok_p))
    return n_frames / t_i, n_frames / t_p, ok


def _pull(t: torch.Tensor) -> torch.Tensor:
    """Start copying ``t`` into a pinned host buffer (CUDA) and return the
    buffer; ready once the card has passed the copy. A CPU tensor is its
    own copy."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def compress_stream(frames: Iterable[Sequence[torch.Tensor]],
                    qtables: torch.Tensor, dct: torch.Tensor,
                    depth: int = 3, precision: str = "exact"
                    ) -> Iterator[List[ds.Stream]]:
    """Streamed compress of device-resident (y, u, v) frames: yields each
    frame's [(sizes u8, content u8) x 3] plane streams, the bytes of
    ``ds.compress_frame_to_streams``, in order.

    Per frame: ``ds.encode_frame`` (K1, or F1 and K5 when fast, and the
    sync-free compaction), then non-blocking copies of its sizes and
    (total, ok) into pinned buffers and one CUDA event. The next frames
    are queued before the oldest
    pending frame is assembled; ``depth`` bounds the frames in flight.
    Assembly waits for that frame's event only and pulls its
    ``content[:total]`` on a side stream. A chunk longer than 255 bytes
    raises BitstreamError, as ``compress_frame`` does."""
    pending = deque()
    side = None

    def assemble(content, sizes_h, flags_h, event, h, w):
        if event is not None:
            event.synchronize()
        total, ok = flags_h.tolist()
        if not ok:
            raise BitstreamError("Huffman encode failed: a chunk does not "
                                 "fit its 8-bit size")
        data = content[:total]
        if side is not None:
            with torch.cuda.stream(side):
                data = _pull(data)
            side.synchronize()
        return ds.split_planes(sizes_h.numpy(), data.numpy(), h, w)

    for y, u, v in frames:
        h, w = y.shape
        sizes, content, total, ok = ds.encode_frame(y, u, v, qtables, dct,
                                                    precision)
        flags = torch.stack([total, ok.to(torch.int64)])
        event = None
        if y.is_cuda:
            if side is None:
                side = torch.cuda.Stream(y.device)
            event = torch.cuda.Event()
            pulled = (_pull(sizes), _pull(flags))
            event.record(torch.cuda.current_stream(y.device))
        else:
            pulled = (sizes, flags)
        pending.append((content, *pulled, event, h, w))
        while len(pending) > depth:
            yield assemble(*pending.popleft())
    while pending:
        yield assemble(*pending.popleft())


def compress_stream_timed(planes_np: Sequence[np.ndarray],
                          qtables: torch.Tensor, dct: torch.Tensor,
                          n_frames: int = 16, depth: int = 3):
    """Stream ``n_frames`` copies of one frame through ``compress_stream``
    on ``qtables.device`` after a warm run. Returns (fps on the host clock,
    compressed bytes of the frame, the frame's plane streams): the
    sustained compress rate with the pulls included."""
    frame = ds.to_device(planes_np, qtables.device)
    (first,) = compress_stream([frame], qtables, dct, depth)
    k = 0
    t0 = time.perf_counter()
    for _ in compress_stream([frame] * n_frames, qtables, dct, depth):
        k += 1
    elapsed = time.perf_counter() - t0
    if k != n_frames:
        raise BitstreamError("compress_stream dropped frames")
    return n_frames / elapsed, sum(int(c.size) for _, c in first), first
