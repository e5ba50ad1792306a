"""Driver ``batch_roundtrip``: frame batches already on the card, coded and
decoded in one call, queued back to back.

Each step queues ``device_stream.roundtrip_batch`` of the next batch of
``batch`` frames (K1, then K2 on K1's lanes in place; the span
``roundtrip_batch`` covers the host's part) and does not wait for the card:
the reconstructed planes, the stream's total bytes and the ``ok`` flag stay
on the device until the window closes.

Traffic keys: ``quality``, ``pool`` (frames in the job), ``batch``,
``warmup`` (batches), ``sample`` (batches whose planes are kept for the
check). The check counts the batches whose ``ok`` is false, compares the
total of every batch of a kept batch's index, and the kept planes, with the
plain reference's.
"""

from __future__ import annotations

import torch

from benchmark.lib import roofline
from benchmark.lib.compare import elements_off
from benchmark.lib.driver import Batches
from benchmark.reference import expected
from myyuv_tpu_torch.engine import device_stream as ds


class Driver(Batches):

    def begin(self) -> None:
        super().begin()
        self.totals, self.oks, self.ks = [], [], []

    def serve(self, k: int):
        with self.spans.span("roundtrip_batch"):
            return ds.roundtrip_batch(*self.batch(k), self.qt, self.dct,
                                      precision=self.cell.precision)

    def step(self) -> int:
        k = self.next_batch()
        planes, total, ok = self.serve(k)
        self.ks.append(k)
        self.totals.append(total)
        self.oks.append(ok)
        self.add_work("roundtrip_batch",
                      *roofline.roundtrip(self.h, self.w, self.b))
        self.sample.offer((k, planes))
        return self.b

    def check(self):
        not_ok = int((~torch.stack(self.oks)).sum()) if self.oks else 0
        totals = torch.stack(self.totals).cpu().tolist() if self.totals else []
        refs = {}
        pixels_off = 0
        for k, planes in self.sample.items:
            if k not in refs:
                refs[k] = expected.batch_roundtrip(self.batch(k),
                                                   self.quality)
            pixels_off += sum(elements_off(a, b)
                              for a, b in zip(planes, refs[k][0]))
        total_off = sum(abs(t - refs[k][1])
                        for k, t in zip(self.ks, totals) if k in refs)
        return [("not_ok", not_ok, 0), ("total_bytes_off", total_off, 0),
                ("pixels_off", pixels_off, 0)]
