"""Frames-in-flight streaming drivers: the card kept busy across frames.

Port of ``myyuv_tpu/engine/streaming.py`` (``roundtrip_stream``,
``ingest_stream``, ``preview_stream``, ``sustained_roundtrip_fps``,
``sustained_scan_fps``, ``sustained_pipeline_fps``, ``compress_stream``,
``compress_stream_timed``), and ``decompress_stream``, which the JAX
package lacks. Each driver queues every frame's kernels back to back and
waits for the card only where a result must reach the host:

* ``roundtrip_stream`` (the transcode / RD loop), ``ingest_stream`` (the
  capture pipeline: BGRX -> X1 -> K1) and ``preview_stream`` (the playback
  pipeline: stream -> K2 -> X2) keep each frame's ``ok`` and ``total`` on
  the card and bring them down once, at the drain: one ``torch.stack``,
  one d2h. Every step they run is free of host syncs (the round trip
  decodes K1's lanes in place, ingest compacts with ``scatter_chunks``);
* ``compress_stream`` (the capture loop with the bytes; frames as (y, u,
  v) planes or as BGRX pixels, which take ``ingest_stream``'s X1 first)
  replays one CUDA graph a frame (the encode and the frame's head: chunk
  totals, ok and sizes), copies the head into a pinned host buffer with
  ``non_blocking=True`` and records one CUDA event per frame; with
  ``depth`` frames queued it waits for the oldest frame's event alone,
  then pulls that frame's ``content[:total]`` on a side stream, so the
  pull does not wait for the frames queued behind it, and assembles the
  frame pulled before it while this pull runs;
* ``decompress_stream`` (the playback loop: each frame's streams in host
  memory, as a player reads them, decoded to BGRX pixels on the card)
  stages each frame into a pinned buffer, uploads it on a side stream and
  replays one CUDA graph a frame (the sizes' cast and offsets, K2, X2 and
  a pinned copy of ``ok``) behind the upload's event; with ``depth``
  frames queued it waits for the oldest frame's event alone.

``roundtrip_scan_stream`` and ``sustained_scan_fps`` queue K frames a call
through ``device_stream.roundtrip_scan``: the K frames coded as one
frame, K1 and K2 once a scan.

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

import itertools
import time
from collections import deque
from typing import (Callable, Iterable, Iterator, List, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from ..entropy.device import LANE
from ..kernels import convert, transform
from ..runtime import trace
from ..runtime.errors import BitstreamError
from . import device_stream as ds

# a frame of ``compress_stream``: BGRX [H, W, 4] uint8, or (y, u, v) planes
Frame = Union[torch.Tensor, Sequence[torch.Tensor]]


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
        _px, err = ds._preview(content, sizes, qtables, dct, h, w,
                               precision)
        oks.append(~err.any())
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
    one warm scan, which loads the kernels. Returns (fps on the host clock,
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
    """Start copying ``t`` into a pinned host buffer (CUDA; its bytes in
    ``pinned_bytes.d2h``) and return the buffer; ready once the card has
    passed the copy. A CPU tensor is its own copy."""
    if t.device.type == "cpu":
        return t
    trace.add("pinned_bytes.d2h", t.nbytes)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


# a frame's head: six chunk totals and its ok, int64, before its sizes
HEAD = 7 * 8


def _head(sizes: torch.Tensor, ok: torch.Tensor, h: int,
          w: int) -> torch.Tensor:
    """A frame's head on its device, one u8 tensor that one pull brings
    down: ``HEAD`` bytes of int64, the chunk bytes of each quarter of the
    Y blocks, of the U blocks and of the V blocks (a 4:2:0 frame's Y plane
    has four times a chroma plane's blocks), then ok; then the sizes as
    u8. Three launches: one reduction and two casting copies."""
    nc = ds.plane_block_counts(h, w)[1]
    head = torch.empty(HEAD + sizes.numel(), dtype=torch.uint8,
                       device=sizes.device)
    meta = head[:HEAD].view(torch.int64)
    torch.sum(sizes.view(-1, nc), 1, dtype=torch.int64, out=meta[:6])
    meta[6] = ok
    head[HEAD:] = sizes
    return head


def _geometry(frame: Frame) -> Tuple[int, int]:
    """A frame's (H, W); a BGRX frame must be one [H, W, 4] picture."""
    if isinstance(frame, torch.Tensor):
        if frame.dim() != 3:
            raise ValueError("a BGRX frame must be [H, W, 4], got "
                             f"{list(frame.shape)}")
        return tuple(frame.shape[:2])
    return tuple(frame[0].shape)


def _encode(frame: Frame, qtables: torch.Tensor, dct: torch.Tensor,
            precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame of ``compress_stream`` on the CPU -> (head, content): BGRX
    pixels through ``ds.ingest_frame``'s step (X1 first), planes through
    ``ds.encode_frame``."""
    h, w = _geometry(frame)
    if isinstance(frame, torch.Tensor):
        sizes, content, _, ok = ds._ingest(frame, qtables, dct, precision)
    else:
        sizes, content, _, ok = ds.encode_frame(*frame, qtables, dct,
                                                precision)
    return _head(sizes, ok, h, w), content


def _capture_graph(body: Callable, device: torch.device):
    """``body()`` captured as one CUDA graph on ``device`` -> (graph, what
    the captured ``body`` returned). ``body()`` runs eagerly on a side
    stream first, so each kernel's module is loaded before the capture
    (loading one inside it can break it); the capture synchronises the
    card. A replay adds nothing to ``build.launches``. A failed capture
    raises."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    return graph, out


class _Slot:
    """A frame's place on the card in ``compress_stream``: (y, u, v)
    planes of its own and one CUDA graph of ``ds.encode_frame`` and
    ``_head`` on them (K1, or F1 and K5 when fast, then ``scatter_chunks``'
    zero-fill, cumulative sum and C1, and the head's three launches),
    captured at the slot's first frame by ``_capture_graph``. The graph
    owns its outputs, the head and the content buffer; a replay
    overwrites them."""

    def __init__(self, h: int, w: int, device: torch.device):
        self.planes = [torch.empty(s, dtype=torch.uint8, device=device)
                       for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        self.graph = self.out = None

    def run(self, frame: Frame, qtables: torch.Tensor, dct: torch.Tensor,
            precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(head, content) of ``frame``: X1 of BGRX pixels into the
        slot's planes (span ``stream.ingest_frame`` around it and the
        replay), or the planes copied in, then one replay."""
        if isinstance(frame, torch.Tensor):
            with trace.span("stream.ingest_frame"):
                convert.bgrx_to_iyuv(frame, out=self.planes)
                return self._replay(qtables, dct, precision)
        transform.check_frame(*frame, qtables, dct)
        for dst, src in zip(self.planes, frame):
            dst.copy_(src)
        return self._replay(qtables, dct, precision)

    def _replay(self, qtables, dct, precision):
        if self.graph is None:
            y, u, v = self.planes

            def body():
                sizes, content, _, ok = ds.encode_frame(y, u, v, qtables,
                                                        dct, precision)
                return _head(sizes, ok, *y.shape), content
            self.graph, self.out = _capture_graph(body, y.device)
        self.graph.replay()
        return self.out


def compress_stream(frames: Iterable[Frame], qtables: torch.Tensor,
                    dct: torch.Tensor, depth: int = 3,
                    precision: str = "exact"
                    ) -> Iterator[List[ds.Stream]]:
    """Streamed compress of device-resident frames, each a BGRX [H, W, 4]
    uint8 tensor or a (y, u, v) triple of uint8 planes (H and W multiples
    of 16): yields each frame's [(sizes u8, content u8) x 3] plane streams,
    in order: the bytes of ``ds.compress_frame_to_streams`` on the planes,
    or on X1's planes of the pixels.

    Per frame: ``ds.encode_frame`` (K1, or F1 and K5 when fast, and the
    sync-free compaction), after X1 for BGRX (``ds.ingest_frame``'s step,
    span ``stream.ingest_frame``), and the frame's head (``_head``: chunk
    totals, ok and u8 sizes); then a non-blocking copy of the head into a
    pinned buffer and one CUDA event. On a CUDA device the step after X1
    is one replay of a CUDA graph (``_Slot``): frame k takes slot k mod
    (depth + 2) of its geometry, so a slot comes round again only after
    its last frame was assembled; the first frame of a slot captures its
    graph, which waits for the card once.

    ``depth`` frames stay queued on the card behind the one whose stream
    is on its way to the host. Once a frame is queued past them, the
    oldest queued frame's event is waited for (span ``wait.event``) and
    its ``content[:total]`` pulled on a side stream; then the frame pulled
    before it is assembled: the wait for its pull (span ``wait.pull``: the
    side stream's synchronize) and ``split_planes``. So the host's wait
    for a pull overlaps the caller's work and the next frame's launch.
    Each pinned pull adds its bytes to the counter ``pinned_bytes.d2h``.
    On the CPU the step runs eagerly, the wait spans hold no wait and
    nothing is pinned. A chunk longer than 255 bytes raises BitstreamError
    at its frame, as ``compress_frame`` does."""
    queued = deque()
    pulling = None
    side, slots, used = None, {}, {}

    def pull(content, head_h, event, h, w):
        with trace.span("wait.event"):
            if event is not None:
                event.synchronize()
        *parts, ok = head_h[:HEAD].view(torch.int64).tolist()
        totals = [sum(parts[:4]), *parts[4:]]
        data = content[:sum(totals) if ok else 0]
        if side is not None:
            with torch.cuda.stream(side):
                data = _pull(data)
        return data, head_h, totals, ok, h, w

    def assemble(data, head_h, totals, ok, h, w):
        with trace.span("wait.pull"):
            if side is not None:
                side.synchronize()
        if not ok:
            raise BitstreamError("Huffman encode failed: a chunk does not "
                                 "fit its 8-bit size")
        return ds.split_planes(head_h[HEAD:].numpy(), data.numpy(), h, w,
                               totals)

    def turn():
        """Start the oldest queued frame's pull; assemble the one before."""
        nonlocal pulling
        done = assemble(*pulling) if pulling is not None else None
        pulling = pull(*queued.popleft())
        return done

    for frame in frames:
        h, w = _geometry(frame)
        device = (frame if isinstance(frame, torch.Tensor)
                  else frame[0]).device
        event = None
        if device.type == "cuda":
            if side is None:
                side = torch.cuda.Stream(device)
            ring = slots.setdefault((h, w), [])
            k = used[h, w] = used.get((h, w), -1) + 1
            if len(ring) < depth + 2:
                transform.frame_blocks(h, w)
                ring.append(_Slot(h, w, device))
            with torch.cuda.device(device):
                head, content = ring[k % len(ring)].run(frame, qtables,
                                                        dct, precision)
                event = torch.cuda.Event()
                head_h = _pull(head)
                event.record()
        else:
            head_h, content = _encode(frame, qtables, dct, precision)
        queued.append((content, head_h, event, h, w))
        if len(queued) > depth:
            done = turn()
            if done is not None:
                yield done
    while queued:
        done = turn()
        if done is not None:
            yield done
    if pulling is not None:
        yield assemble(*pulling)


def _stage(parts: Sequence[np.ndarray], out: torch.Tensor) -> torch.Tensor:
    """Copy the u8 arrays ``parts`` back to back into the front of ``out``
    (u8, on the host) -> that view. One thread copies: PyTorch's copy
    splits the arrays over the host's threads, which on an 8-core H100
    host slowed the uploads beside it and spread the frame rate."""
    n = sum(p.size for p in parts)
    np.concatenate(parts, out=out.numpy()[:n])
    return out[:n]


class _PlaySlot:
    """A frame's place in ``decompress_stream`` on a CUDA device: a pinned
    host buffer and a device buffer of N * 256 bytes (N one-byte sizes and
    the longest content N chunks make, 255 bytes each), the events of its
    upload and of its decode, and one CUDA graph of ``ds.play_frame`` on
    the device buffer followed by a copy of ``ok`` into a pinned byte,
    captured at the slot's first frame by ``_capture_graph``. The graph
    owns the frame's BGRX pixels, ``ok`` and ``err``; a replay overwrites
    them."""

    def __init__(self, n: int, device: torch.device):
        self.n = n
        self.host = torch.empty(n * LANE, dtype=torch.uint8, pin_memory=True)
        self.buf = torch.empty(n * LANE, dtype=torch.uint8, device=device)
        self.ok = torch.empty((), dtype=torch.bool, pin_memory=True)
        self.uploaded, self.done = torch.cuda.Event(), torch.cuda.Event()
        self.graph = self.out = None

    def decode(self, m: int, side: torch.cuda.Stream, qtables: torch.Tensor,
               dct: torch.Tensor, h: int, w: int, precision: str):
        """Upload the staged ``m`` bytes on ``side``, make the current
        stream wait for the upload and replay the graph -> (BGRX, pinned
        ok, err, the done event)."""
        with torch.cuda.stream(side):
            self.buf[:m].copy_(self.host[:m], non_blocking=True)
            self.uploaded.record()
        trace.add("pinned_bytes.h2d", m)
        torch.cuda.current_stream().wait_event(self.uploaded)
        if self.graph is None:
            def body():
                out = ds.play_frame(self.buf, self.n, qtables, dct, h, w,
                                    precision)
                self.ok.copy_(out[1], non_blocking=True)
                return out
            self.graph, self.out = _capture_graph(body, self.buf.device)
        self.graph.replay()
        self.done.record()
        pixels, _, err = self.out
        return pixels, self.ok, err, self.done


def decompress_stream(frames: Iterable[Sequence[ds.Stream]],
                      qtables: torch.Tensor, dct: torch.Tensor, h: int,
                      w: int, depth: int = 3, precision: str = "exact"
                      ) -> Iterator[torch.Tensor]:
    """Streamed decode of frames whose streams lie in host memory, each
    frame's [(sizes u8, content u8)] x 3 plane streams as
    ``compress_stream`` yields them and a ``.myyuv`` file holds them
    (numpy arrays, pageable or not) -> each frame's BGRX [H, W, 4] uint8
    on ``qtables.device``, in order: the bytes of
    ``ds.decompress_streams_to_frame`` followed by X2.

    Per frame: the host checks the streams (``ds.check_streams``: three
    planes of this geometry's block counts, content as long as the sizes
    imply) and copies the sizes, then the chunks, into one buffer (span
    ``stream.stage``); then ``ds.play_frame`` on it (span
    ``stream.decode_frame``). On a CUDA device the buffer is the pinned
    one of frame k's slot, k mod (depth + 2) (``_PlaySlot``); one
    non-blocking copy of its N + T bytes (counter ``pinned_bytes.h2d``)
    runs on a side stream, and the current stream waits for it and
    replays the slot's graph, so the upload of one frame overlaps the
    decode of the one before and the host stages the next meanwhile. The
    first frame of a slot captures its graph, which waits for the card
    once.

    ``depth`` frames stay queued behind the one yielded: once a frame is
    queued past them, the oldest queued frame's decode is waited for (span
    ``wait.event``) and its frame yielded. A yielded frame on a CUDA
    device is a view of its slot's pixels: frame k + depth + 2 overwrites
    it, and the stream queues that frame while it yields frame k + 2, so
    ``clone()`` a frame kept past the next one. A slot's pinned buffer is
    refilled only after its last frame was yielded.

    A frame whose chunk does not decode raises BitstreamError when it is
    due, with ``ds.decompress_frame``'s message; a frame whose streams
    fail the checks raises when it is staged, ``depth`` frames earlier.
    Leaving the stream (closing it, or an error) waits for the frames
    still queued. On the CPU the steps run eagerly on the plain versions,
    the wait span holds no wait and nothing is pinned.
    ``precision="fast"``: K6 then F2, then X2."""
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")
    n = transform.frame_blocks(h, w)
    device = qtables.device
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    queued, ring = deque(), []

    def due():
        pixels, ok, err, event = queued.popleft()
        with trace.span("wait.event"):
            if event is not None:
                event.synchronize()
        if not bool(ok):
            ds._raise_first_bad(err, "Huffman decode")
        return pixels

    try:
        for k, frame in enumerate(frames):
            if cuda and len(ring) < depth + 2:
                ring.append(_PlaySlot(n, device))
            slot = ring[k % len(ring)] if cuda else None
            with trace.span("stream.stage"):
                parts = [s for s, _ in frame] + ds.check_streams(frame, h, w)
                staged = _stage(parts, slot.host if cuda else torch.empty(
                    sum(p.size for p in parts), dtype=torch.uint8))
            with trace.span("stream.decode_frame"):
                if cuda:
                    with torch.cuda.device(device):
                        queued.append(slot.decode(staged.numel(), side,
                                                  qtables, dct, h, w,
                                                  precision))
                else:
                    queued.append((*ds.play_frame(staged, n, qtables, dct,
                                                  h, w, precision), None))
            if len(queued) > depth:
                yield due()
        while queued:
            yield due()
    finally:
        for *_, event in queued:
            if event is not None:
                event.synchronize()


def compress_stream_timed(planes_np: Sequence[np.ndarray],
                          qtables: torch.Tensor, dct: torch.Tensor,
                          n_frames: int = 16, depth: int = 3):
    """Stream ``n_frames`` copies of one frame through ``compress_stream``
    on ``qtables.device``, after ``depth + 1`` warm frames of the same
    stream (every slot's graph captured). Returns (fps on the host clock,
    compressed bytes of the frame, the frame's plane streams): the
    sustained compress rate with the pulls included."""
    frame = ds.to_device(planes_np, qtables.device)
    stream = compress_stream(itertools.repeat(frame), qtables, dct, depth)
    first = next(stream)
    for _ in range(depth):
        next(stream)
    t0 = time.perf_counter()
    for _ in range(n_frames):
        next(stream)
    elapsed = time.perf_counter() - t0
    stream.close()
    return n_frames / elapsed, sum(int(c.size) for _, c in first), first
