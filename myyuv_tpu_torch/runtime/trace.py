"""The port's recorder of host spans and counters.

Four calls: ``start()`` clears what was recorded and switches the recorder
on, ``stop()`` switches it off and returns ``(spans, counters)``,
``span(name)`` is a context manager around a stretch of host work, and
``add(name, n)`` adds ``n`` to a counter. It is off until ``start()``.

A span record is ``(name, depth, t0_ns, t1_ns)`` on ``time.time_ns()``,
the clock of ``torch.profiler``'s events, so spans and a device trace can
be laid side by side. Depth is kept per thread: a span's parent is the
enclosing span one level shallower on the same thread. Counters are
``{name: int}``.

Off, ``span`` returns one shared no-op context and ``add`` tests a flag:
neither allocates, reads the clock or touches the card. On, a span costs
two clock reads and an append, and nothing waits for the card.

What the program records:

* ``yuv.from_bytes``, ``yuv.to_bytes``, ``yuv.from_planes``,
  ``dct_stream.parse``, ``dct_stream.serialize``: the container, on the
  host (``formats/``);
* ``pipeline.compress_dct``, ``pipeline.decompress_dct``,
  ``pipeline.codec_params``: the file API's entries and its tables;
* ``stream.compress_frame``, ``stream.decompress_frame``,
  ``stream.roundtrip_frame`` (the batch entries record these too),
  ``stream.ingest_frame`` (X1 and the sync-free encode of BGRX pixels:
  ``ingest_frame``, ``streaming.ingest_stream`` and
  ``streaming.compress_stream`` on BGRX frames) and ``stream.split``: the
  frame codec on the device (``device_stream``); ``stream.stage`` (the
  host's checks of a frame's streams and their copy into one buffer,
  pinned on a CUDA device) and ``stream.decode_frame`` (the upload's
  enqueue and the decode's graph replay): ``streaming.decompress_stream``;
* ``sweep.quality``: one quality of ``sweep.quality_sweep``;
* ``wait.h2d`` (a pageable upload), ``wait.d2h`` (a pageable download,
  ``device_stream.to_host``), ``wait.err`` (a decoder's error flag, and
  the search for the first bad block once a flag is set: in a compress
  call only on that error path), ``wait.size`` (an output whose size
  depends on the data: the compaction's length, read with the encoder's
  error flag in one copy; ``torch.unique``), ``wait.scalar`` (a device
  scalar read on the host), ``wait.event`` (``streaming.compress_stream``
  and ``streaming.decompress_stream`` waiting for their oldest queued
  frame's event) and ``wait.pull`` (``compress_stream``'s
  side stream's synchronize on a frame's pinned pull of the stream): each
  place where the host blocks on the card, one span a wait; they do not
  nest in one another;
* counters ``pageable_bytes.h2d`` and ``pageable_bytes.d2h``: the bytes of
  each pageable copy to or from a CUDA device (none on the CPU route);
  ``pinned_bytes.d2h``: the bytes ``streaming.compress_stream`` pulls into
  pinned host buffers, each frame's head and stream (none on the CPU
  route); ``pinned_bytes.h2d``: the bytes
  ``streaming.decompress_stream`` uploads from pinned host buffers, each
  frame's one-byte sizes and chunks (none on the CPU route);
  ``compact.bytes``: the stream bytes
  ``device_stream.compact_chunks`` wrote with C1 (none on the CPU route);
  ``err.search``: the searches for a first bad block, one a call that
  raises BitstreamError for an encoder's or decoder's error codes (none
  on clean input).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

Span = Tuple[str, int, int, int]

_on = False
_spans: List[Span] = []
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """The shared context ``span`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "depth", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.depth = getattr(_local, "depth", 0)
        _local.depth = self.depth + 1
        self.t0 = time.time_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _local.depth = self.depth
        _spans.append((self.name, self.depth, self.t0, t1))
        return False


def start() -> None:
    """Forget what was recorded and record from now on."""
    global _on
    with _lock:
        _spans.clear()
        _counters.clear()
        _on = True


def stop() -> Tuple[List[Span], Dict[str, int]]:
    """Stop recording; return the spans (in the order they ended) and the
    counters recorded since ``start()``."""
    global _on
    with _lock:
        _on = False
        return list(_spans), dict(_counters)


def span(name: str):
    """A context manager that records ``name`` around its body while the
    recorder is on."""
    return _Span(name) if _on else _OFF


def add(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n
