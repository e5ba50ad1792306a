"""One run of one cell: set-up, the measured window, the trace, the check.

A driver (``drivers/<name>.py``, class ``Driver``) is built with a ``Cell``
and offers:

* ``setup()``: make the inputs from the seed and warm up every shape the
  window uses (counted in ``setup_s``);
* ``begin()``: forget what the warm-up left (counts, sample, work);
* ``step() -> int``: one unit of the closed loop, the frames it adds;
* ``drain()``: wait until the device has finished what was queued;
* ``end_to_end() -> dict``: the cell's end-to-end metrics other than
  the frame rate and ``setup_s``;
* ``work``: span name -> [bytes, operations, calls] of the window's calls,
  counted from shapes (``lib/roofline.py``), for the rooflines;
* ``release()``: drop the program's state, so the reference has the card;
* ``check() -> [(name, value, limit)]``: each number compared, passing
  where value <= limit.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.lib import roofline, trace
from benchmark.lib.manifest import Manifest
from benchmark.lib.spans import Spans


@dataclasses.dataclass
class Cell:
    """What a driver is given."""

    name: str
    config: Dict
    traffic: Dict
    seed: int
    device: torch.device
    spans: Spans
    precision: str = "exact"


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, Tuple[float, str]]
    device: Dict
    checks: List[Tuple[str, float, float]]
    breakdown: Optional[Dict] = None
    notes: List[str] = dataclasses.field(default_factory=list)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t_start: float,
             precision: str = "exact") -> Result:
    """Run cell ``name`` once; ``t_start`` is ``time.perf_counter()`` at the
    start of the process (set-up is counted from there)."""
    spec = manifest.cell(name)
    traffic = manifest.traffic(spec["traffic"])
    cell = Cell(name, manifest.config(spec["config"]), traffic, seed, device,
                Spans(), precision)
    driver = manifest.driver(traffic["driver"])(cell)
    t_driver = time.perf_counter()
    driver.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    cell.spans.clear()
    driver.begin()

    prof = None
    if traced:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[
            act.CUDA if device.type == "cuda" else act.CPU])
        prof.start()
        sync(device)
    frames = attempted = failed = 0
    t0, p0 = time.time_ns(), time.perf_counter()
    while time.perf_counter() - p0 < seconds:
        attempted += 1
        try:
            frames += driver.step()
        except Exception:  # a failed request is counted, not fatal
            if not failed:
                traceback.print_exc(file=sys.stderr)
            failed += 1
    driver.drain()
    window_s = time.perf_counter() - p0
    t1 = time.time_ns()
    ops = []
    if prof is not None:
        prof.stop()
        ops = trace.device_ops(prof)
        del prof
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}

    metrics: Dict[str, Tuple[float, str]] = {}
    breakdown = None
    notes: List[str] = []
    if not traced:
        values = {"setup_s": setup_s, **driver.end_to_end()}
        for m in manifest.metrics("end_to_end", name):
            # the window's frame rate, under the name of the cell's group
            # of cells (frames_per_s, frames_per_s.<group>), each group
            # with a bound of its own
            value = (frames / window_s
                     if m["name"].split(".")[0] == "frames_per_s"
                     else values[m["name"]])
            metrics[m["name"]] = (value, m["unit"])
    else:
        pk = roofline.peak(dev_info["kind"])
        summary = trace.summarise(ops, cell.spans.records, t0, t1, frames,
                                  driver.work, pk)
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        for m in manifest.metrics("per_layer", name):
            value = manifest.reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        breakdown = {"device_ops": [[n, float(v)]
                                    for n, v in summary.device_top],
                     "idle_gaps": [[n, float(v)]
                                   for n, v in summary.idle_top]}
        for span, (nbytes, nops, calls) in sorted(driver.work.items()):
            if pk and calls:
                least, by = roofline.least_seconds(nbytes, nops, pk)
                notes.append(f"{span}: least {least / calls * 1e6:.3f} us a "
                             f"call, bound by {by}")

    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = driver.check()
    notes.append(f"set-up {setup_s:.3f} s ({t_driver - t_start:.3f} s "
                 f"before the driver's, {setup_s - t_driver + t_start:.3f} s"
                 f" in it: inputs, warm-up), window {window_s:.3f} s, "
                 f"check {time.perf_counter() - t_check:.3f} s, "
                 f"{frames} frames")
    correct = (attempted > 0 and frames > 0 and failed == 0
               and all(v <= lim for _, v, lim in checks))
    return Result(correct, attempted, failed, metrics, dev_info, checks,
                  breakdown, notes)
