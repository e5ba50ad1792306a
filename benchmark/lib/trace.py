"""Reduction of a traced run: device operations from ``torch.profiler``,
host spans from the benchmark, into what the per-layer metric readers read.

The profiler records CUDA activity only (kernels, memcpys, memsets and the
runtime calls that launched them), which costs the host little. Its
timestamps are on the clock of ``time.time_ns()``, as the spans are. Each
device operation is charged to the spans that were open on the host when
its launch call ran (matched by the profiler's correlation id; an operation
with no launch call found is charged by its own start).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# (name, start ns, end ns, launch ns)
DeviceOp = Tuple[str, int, int, int]


def short(name: str) -> str:
    """A device operation's name without "void " and cut to 96
    characters: kernels of templates are named by their whole signature."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= 96 else name[:93] + "..."


def kind(name: str) -> str:
    """"memcpy", "memset" or "kernel"."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def device_ops(prof) -> List[DeviceOp]:
    """The device operations a stopped ``torch.profiler.profile`` holds."""
    events = prof.profiler.kineto_results.events()
    launch = {}
    for e in events:
        if (str(e.device_type()).endswith("CPU") and e.correlation_id()
                and e.name().startswith("cu")):
            launch[e.correlation_id()] = e.start_ns()
    ops = []
    for e in events:
        if (str(e.device_type()).endswith("CUDA")
                and not e.is_user_annotation()):
            ops.append((e.name(), e.start_ns(), e.end_ns(),
                        launch.get(e.correlation_id(), e.start_ns())))
    return ops


@dataclasses.dataclass
class SpanStat:
    """One span name over the traced window."""

    count: int = 0
    host_s: float = 0.0      # summed span durations
    device_s: float = 0.0    # device time of the operations it launched
    copy_s: float = 0.0      # of which memcpy (host <-> device)
    kernels: int = 0


@dataclasses.dataclass
class TraceSummary:
    """What the per-layer metric readers read."""

    window_s: float
    busy_s: float
    frames: int
    kernels: int
    spans: Dict[str, SpanStat]
    work: Dict[str, Tuple[float, float, int]]  # span -> bytes, ops, calls
    peak: Optional[Dict[str, float]]
    device_top: List[Tuple[str, float]]
    idle_top: List[Tuple[str, float]]

    def span(self, name: str) -> Optional[SpanStat]:
        s = self.spans.get(name)
        return s if s is not None and s.count else None


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted, merged [k, 2] intervals."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def _open_at(spans, t: np.ndarray) -> Dict[str, np.ndarray]:
    """name -> bool mask of the times ``t`` at which a span of that name
    was open; spans of one name never overlap (one client thread)."""
    out = {}
    for name in {s[0] for s in spans}:
        iv = np.array(sorted((s[2], s[3]) for s in spans if s[0] == name),
                      np.int64)
        i = np.searchsorted(iv[:, 0], t, side="right") - 1
        ok = i >= 0
        ok[ok] = t[ok] <= iv[i[ok], 1]
        out[name] = ok
    return out


def summarise(ops: Sequence[DeviceOp], spans, t0: int, t1: int,
              frames: int, work, peak) -> TraceSummary:
    """Reduce the device operations and host spans of the window
    [t0, t1] (ns)."""
    ops = [o for o in ops if o[2] > t0 and o[1] < t1]
    spans = [s for s in spans if s[3] > t0 and s[2] < t1]
    names = [o[0] for o in ops]
    se = np.array([(o[1], o[2]) for o in ops], np.int64).reshape(-1, 2)
    dur = (se[:, 1] - se[:, 0]) / 1e9
    launch = np.array([o[3] for o in ops], np.int64)
    kinds = np.array([kind(n) for n in names])

    clipped = np.clip(se, t0, t1)
    busy = _union(clipped)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9 if len(busy) else 0.

    stats: Dict[str, SpanStat] = {}
    for name, _, a, b in spans:
        s = stats.setdefault(name, SpanStat())
        s.count += 1
        s.host_s += (b - a) / 1e9
    for name, mask in _open_at(spans, launch).items():
        s = stats[name]
        s.device_s = float(dur[mask].sum())
        s.copy_s = float(dur[mask & (kinds == "memcpy")].sum())
        s.kernels = int((mask & (kinds == "kernel")).sum())

    by_name: Dict[str, float] = {}
    for n, d in zip(names, dur):
        by_name[short(n)] = by_name.get(short(n), 0.0) + float(d)
    device_top = sorted(by_name.items(), key=lambda x: -x[1])[:10]

    # idle time, charged to the innermost span open on the host then: cut
    # the window at every edge of a busy interval or a span
    edges = [np.array([t0, t1]), busy.reshape(-1)]
    edges += [np.array([s[2] for s in spans] + [s[3] for s in spans])]
    cuts = np.unique(np.clip(np.concatenate(edges).astype(np.int64), t0, t1))
    mid = (cuts[:-1] + cuts[1:]) // 2
    length = np.diff(cuts) / 1e9
    if len(busy):
        i = np.searchsorted(busy[:, 0], mid, side="right") - 1
        ok = i >= 0
        ok[ok] = mid[ok] < busy[i[ok], 1]
        mid, length = mid[~ok], length[~ok]
    depth = np.full(len(mid), -1)
    label = np.full(len(mid), "outside any span", dtype=object)
    for name, d in {(s[0], s[1]) for s in spans}:
        inside = _open_at([s for s in spans if s[0] == name], mid)[name]
        take = inside & (d > depth)
        depth[take] = d
        label[take] = name
    idle = {lab: float(length[label == lab].sum()) for lab in set(label)}
    idle_top = sorted(idle.items(), key=lambda x: -x[1])[:10]

    return TraceSummary(
        window_s=(t1 - t0) / 1e9, busy_s=busy_s, frames=frames,
        kernels=int((kinds == "kernel").sum()), spans=stats, work=dict(work),
        peak=peak, device_top=device_top, idle_top=idle_top)
