"""What the drivers share."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmark.lib import inputs
from benchmark.lib.compare import Reservoir
from benchmark.lib.harness import Cell, sync
from myyuv_tpu_torch.engine import pipeline


class Base:
    """A driver's defaults: the request order, the sample of answers kept
    for the check, the work counters and the wait for the device."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.dev = cell.device
        self.spans = cell.spans
        self.begin()

    def begin(self) -> None:
        self.work: Dict[str, List[float]] = {}
        self.sample = Reservoir(int(self.cell.traffic["sample"]),
                                self.cell.seed)
        self.count = 0

    def order(self, n: int) -> np.ndarray:
        """The order in which requests cycle through a pool of ``n``: a
        permutation drawn from the seed."""
        return np.random.default_rng([self.cell.seed, 0x0d3]).permutation(n)

    def add_work(self, span: str, nbytes: float, ops: float) -> None:
        w = self.work.setdefault(span, [0.0, 0.0, 0])
        w[0] += nbytes
        w[1] += ops
        w[2] += 1

    def drain(self) -> None:
        sync(self.dev)

    def end_to_end(self) -> Dict[str, float]:
        return {}

    def release(self) -> None:
        pass


class Batches(Base):
    """A job of frames in device memory, served ``batch`` frames at a
    time in order; the program's codec tables at the traffic's quality."""

    def setup(self) -> None:
        t = self.cell.traffic
        self.quality = [int(q) for q in t["quality"]]
        self.b = int(t["batch"])
        self.h, self.w = self.cell.config["height"], self.cell.config["width"]
        self.job = inputs.video(self.cell.config, int(t["pool"]),
                                self.cell.seed, self.dev)
        self.nb = int(t["pool"]) // self.b
        self.dct, self.qt = pipeline.codec_params(self.quality, self.dev)
        for k in range(int(t.get("warmup", 2))):
            self.serve(k % self.nb)

    def batch(self, k: int):
        return [p[k * self.b:(k + 1) * self.b] for p in self.job]

    def next_batch(self) -> int:
        k = self.count % self.nb
        self.count += 1
        return k

    def release(self) -> None:
        del self.qt, self.dct
