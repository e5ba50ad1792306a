"""Driver ``file_roundtrip``: the file API, one client in a closed loop.

A request takes a raw IYUV file's bytes from the pool (in memory), parses
them (``YUVImage.from_bytes``), compresses them with
``pipeline.compress_dct`` on the card and serialises the result
(``to_bytes``): the ``compress`` span. Then it parses those bytes,
decompresses them with ``pipeline.decompress_dct`` and serialises the
result: the ``decompress`` span. A frame counts once both are done.

Traffic keys: ``quality`` ([Y, U, V]), ``pool`` (distinct images, served
in an order drawn from the seed), ``warmup`` (requests), ``sample``
(requests kept for the check). The check compares both files' bytes with
the plain reference's.
"""

from __future__ import annotations

import torch

from benchmark.lib import inputs, stats
from benchmark.lib.compare import bytes_off
from benchmark.lib.driver import Base
from benchmark.reference import container, expected
from myyuv_tpu_torch.engine import pipeline
from myyuv_tpu_torch.formats.yuv import YUVImage


class Driver(Base):

    def setup(self) -> None:
        t = self.cell.traffic
        self.quality = [int(q) for q in t["quality"]]
        self.params = bytes(self.quality)
        self.pool = [container.raw_file([p.cpu().numpy() for p in planes])
                     for planes in inputs.stills(self.cell.config,
                                                 int(t["pool"]),
                                                 self.cell.seed, self.dev)]
        self.seq = self.order(len(self.pool))
        for i in range(int(t.get("warmup", 2))):
            self.serve(int(self.seq[i % len(self.seq)]))

    def serve(self, i: int):
        with self.spans.span("compress"):
            packed = pipeline.compress_dct(
                YUVImage.from_bytes(self.pool[i]), self.params,
                device=self.dev, precision=self.cell.precision).to_bytes()
        with self.spans.span("decompress"):
            back = pipeline.decompress_dct(
                YUVImage.from_bytes(packed), device=self.dev,
                precision=self.cell.precision).to_bytes()
        return packed, back

    def step(self) -> int:
        i = int(self.seq[self.count % len(self.seq)])
        self.count += 1
        self.sample.offer((i, *self.serve(i)))
        return 1

    def end_to_end(self):
        return {f"{name}_ms_p95": stats.percentile(
                    self.spans.durations_ms(name), 95)
                for name in ("compress", "decompress")}

    def check(self):
        refs = {}
        packed_off = back_off = 0
        for i, packed, back in self.sample.items:
            if i not in refs:
                planes = [torch.from_numpy(p.copy()).to(self.dev)
                          for p in container.raw_planes(self.pool[i])]
                refs[i] = expected.still_files(planes, self.quality)
            packed_off += bytes_off(packed, refs[i][0])
            back_off += bytes_off(back, refs[i][1])
        return [("compressed_bytes_off", packed_off, 0),
                ("decompressed_bytes_off", back_off, 0)]
