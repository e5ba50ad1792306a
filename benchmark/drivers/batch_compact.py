"""Driver ``batch_compact``: frame batches already on the card, coded to a
compact stream and decoded back, closed loop.

The job's frames live in device memory. Each step takes the next batch of
``batch`` frames, codes it with ``device_stream.compress_batch`` (K1, then
the mask-select compaction to the on-disk chunk stream; the span
``compress_batch``) and decodes that stream with ``decompress_batch`` (K2;
``decompress_batch``). The stream stays on the card.

Traffic keys: ``quality``, ``pool`` (frames in the job), ``batch``,
``warmup`` (batches), ``sample`` (batches kept for the check). The check
compares each kept batch's chunk sizes, stream bytes and decoded planes
with the plain reference's.
"""

from __future__ import annotations

from benchmark.lib import roofline
from benchmark.lib.compare import elements_off
from benchmark.lib.driver import Batches
from benchmark.reference import expected
from myyuv_tpu_torch.engine import device_stream as ds


class Driver(Batches):

    def serve(self, k: int):
        p = self.cell.precision
        with self.spans.span("compress_batch"):
            sizes, content = ds.compress_batch(*self.batch(k), self.qt,
                                               self.dct, precision=p)
        with self.spans.span("decompress_batch"):
            planes = ds.decompress_batch(content, sizes, self.qt, self.dct,
                                         self.b, self.h, self.w, precision=p)
        return sizes, content, planes

    def step(self) -> int:
        k = self.next_batch()
        sizes, content, planes = self.serve(k)
        chunk_bytes = content.numel()
        self.add_work("compress_batch",
                      *roofline.encode(self.h, self.w, self.b, chunk_bytes))
        self.add_work("decompress_batch",
                      *roofline.decode(self.h, self.w, self.b, chunk_bytes))
        self.sample.offer((k, sizes, content, planes))
        return self.b

    def check(self):
        sizes_off = content_off = pixels_off = 0
        refs = {}
        for k, sizes, content, planes in self.sample.items:
            if k not in refs:
                refs[k] = expected.batch_stream(self.batch(k), self.quality)
            ref_sizes, ref_content, ref_planes = refs[k]
            sizes_off += elements_off(sizes, ref_sizes)
            content_off += elements_off(content, ref_content)
            pixels_off += sum(elements_off(a, b)
                              for a, b in zip(planes, ref_planes))
        return [("sizes_off", sizes_off, 0),
                ("stream_bytes_off", content_off, 0),
                ("pixels_off", pixels_off, 0)]
