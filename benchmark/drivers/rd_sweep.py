"""Driver ``rd_sweep``: rate-distortion sweeps of stills, closed loop.

Each step sweeps the next still of the pool (host planes) with
``engine/sweep.py::quality_sweep`` at every quality of ``qualities``, with
the default rate route (K3 then K5): the span ``sweep``. Inside it the
sweep's calls of ``batch.roundtrip_step`` (K3, K4, the squared-error sums
and the histogram) are wrapped in the span ``step``; the wrapper records
the span and the step's work and, in a sweep that the sample keeps for
the check (drawn before the sweep), what the step returned: the
reconstructed planes and the symbol histogram. Other sweeps keep nothing.

Traffic keys: ``qualities``, ``pool`` (stills, swept in an order drawn
from the seed), ``warmup`` (sweeps), ``sample`` (sweeps kept for the
check). The check compares, for each kept sweep and quality, the
reconstructed planes and the symbol histogram exactly with the plain
reference's, and every field of the point: integers exactly, the rounded
PSNR and entropy to one unit of their last printed digit (the program sums
squared errors in float32, in an order of its own).
"""

from __future__ import annotations

import functools
import math

import torch

from benchmark.lib import inputs, roofline
from benchmark.lib.compare import elements_off
from benchmark.lib.driver import Base
from benchmark.reference import expected
from myyuv_tpu_torch.engine import batch as batch_module
from myyuv_tpu_torch.engine import sweep

PSNR_KEYS = ("psnr_y_db", "psnr_u_db", "psnr_v_db")


def fields_off(got, want) -> int:
    """Fields of the program's point ``got`` that disagree with the
    reference's unrounded point ``want``."""
    off = int(got.get("quality") != want["quality"])
    off += int(got.get("compressed_bytes") != want["compressed_bytes"])
    off += int(got.get("bits_per_pixel")
               != round(want["bits_per_pixel"], 4))
    for key, places in [(k, 3) for k in PSNR_KEYS] + [
            ("entropy_bits_per_symbol", 4)]:
        value = got.get(key)
        unit = 10.0 ** -places
        if not (isinstance(value, float)
                and abs(value - round(want[key], places)) <= unit * 1.0001):
            off += 1
    return off


class Driver(Base):

    def setup(self) -> None:
        t = self.cell.traffic
        self.qualities = [int(q) for q in t["qualities"]]
        self.pool = [[p.cpu().numpy() for p in planes]
                     for planes in inputs.stills(self.cell.config,
                                                 int(t["pool"]),
                                                 self.cell.seed, self.dev)]
        self.seq = self.order(len(self.pool))
        self.original = batch_module.roundtrip_step
        batch_module.roundtrip_step = functools.partial(self.timed_step,
                                                        self.original)
        # warm-up through step(), so that the window's sample reuses the
        # device memory that the warm-up's sample held
        for _ in range(int(t.get("warmup", 1))):
            self.step()

    def timed_step(self, step, y, *args, **kwargs):
        with self.spans.span("step"):
            out = step(y, *args, **kwargs)
        h, w = y.shape[-2:]
        self.add_work("step", *roofline.transform_step(
            h, w, math.prod(y.shape[:-2])))
        if self.outputs is not None:
            planes, metrics = out
            self.outputs.append((planes, metrics["symbol_hist"]))
        return out

    def serve(self, i: int):
        with self.spans.span("sweep"):
            return sweep.quality_sweep(self.pool[i], self.qualities,
                                       device=self.dev,
                                       precision=self.cell.precision)

    def step(self) -> int:
        i = int(self.seq[self.count % len(self.seq)])
        self.count += 1
        slot = self.sample.claim()
        self.outputs = None if slot is None else []
        points = self.serve(i)
        if slot is not None:
            self.sample.put(slot, (i, points, self.outputs))
        return 1

    def release(self) -> None:
        batch_module.roundtrip_step = self.original

    def check(self):
        refs = {}
        off = pixels = hist = 0
        for i, points, outputs in self.sample.items:
            if i not in refs:
                planes = [torch.from_numpy(p).to(self.dev)
                          for p in self.pool[i]]
                refs[i] = expected.rd_points(planes, self.qualities)
            want = refs[i]
            off += 7 * abs(len(points) - len(want))
            off += sum(fields_off(g, w) for g, w in zip(points, want))
            pixels += sum(p.size for p in self.pool[i]) * abs(
                len(outputs) - len(want))
            for (rec, got_hist), w in zip(outputs, want):
                pixels += sum(elements_off(a, b) for a, b in
                              zip(rec, w["reconstruction"]))
                hist += elements_off(got_hist, w["symbol_hist"])
        return [("rd_fields_off", off, 0), ("pixels_off", pixels, 0),
                ("hist_bins_off", hist, 0)]
