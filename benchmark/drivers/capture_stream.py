"""Driver ``capture_stream``: BGRX frames already on the card coded to
``.myyuv`` plane streams in host memory, one client in a closed loop.

The job's frames live in device memory as BGRX pixels, as a screen or
camera capture (NvFBC, GPUDirect) leaves them. One
``streaming.compress_stream`` runs over the job in order, round and round,
with ``depth`` frames in flight: each frame takes X1, K1 and the sync-free
compaction on the card, its stream is pulled into pinned host memory and
split per plane. A step takes the next frame the stream yields (span
``capture``), so the card's work on the frames behind it overlaps the
host's assembly of this one.

Traffic keys: ``quality``, ``pool`` (frames in the job), ``depth``,
``warmup`` (frames), ``sample`` (frames kept for the check). The check
compares each kept frame's three (sizes, content) streams with the plain
reference's (``reference/capture.py``).
"""

from __future__ import annotations

import itertools

from benchmark.content import bgrx_job
from benchmark.lib import capture_work, inputs
from benchmark.lib.compare import bytes_off
from benchmark.lib.driver import Base
from benchmark.reference import capture
from myyuv_tpu_torch.engine import pipeline, streaming


class Driver(Base):

    def setup(self) -> None:
        t, c = self.cell.traffic, self.cell.config
        self.quality = [int(q) for q in t["quality"]]
        self.h, self.w = c["height"], c["width"]
        self.job = bgrx_job.pan_bgrx(int(t["pool"]), self.h, self.w,
                                     c["content"],
                                     inputs.generator(self.cell.seed,
                                                      self.dev), self.dev)
        self.dct, self.qt = pipeline.codec_params(self.quality, self.dev)
        self.yielded = 0
        self.stream = streaming.compress_stream(
            self.frames(), self.qt, self.dct, depth=int(t["depth"]),
            precision=self.cell.precision)
        for _ in range(int(t.get("warmup", 2))):
            self.serve()

    def frames(self):
        """The job's frames in order, round and round."""
        for k in itertools.count():
            yield self.job[k % len(self.job)]

    def serve(self):
        """The next frame's streams and the frame's index in the job."""
        k = self.yielded % len(self.job)
        streams = next(self.stream)
        self.yielded += 1
        return k, streams

    def step(self) -> int:
        with self.spans.span("capture"):
            k, streams = self.serve()
        chunk_bytes = sum(int(content.size) for _, content in streams)
        self.add_work("capture",
                      *capture_work.capture(self.h, self.w, chunk_bytes))
        self.sample.offer((k, streams))
        return 1

    def release(self) -> None:
        self.stream.close()
        del self.stream, self.qt, self.dct

    def check(self):
        off = 0
        refs = {}
        for k, streams in self.sample.items:
            if k not in refs:
                refs[k] = capture.frame_streams(self.job[k], self.quality)
            off += abs(len(streams) - len(refs[k]))
            for (sizes, content), (ref_sizes, ref_content) in zip(streams,
                                                                  refs[k]):
                off += (bytes_off(sizes.tobytes(), ref_sizes.tobytes())
                        + bytes_off(content.tobytes(), ref_content.tobytes()))
        return [("streams_off", off, 0)]
