"""Driver ``playback_stream``: ``.myyuv`` plane streams in host memory
decoded to BGRX frames on the card, one client in a closed loop.

A player's read-ahead holds each frame's streams in pageable host memory,
as a file's parser leaves them, and it wants displayable pixels on the
card. Set-up makes capture2160's BGRX job from the seed, codes it once with
the program's ``streaming.compress_stream`` and keeps the streams as
pageable numpy arrays, views of one buffer that holds the frames as their
file does (the pool, ``read_ahead``); then one
``streaming.decompress_stream`` runs over the pool in order, round and
round, with ``depth`` frames in flight: each frame is staged into pinned
memory, uploaded and decoded by K2 and X2 on the card. A step takes the
next frame the stream yields (span ``playback``), so the card's work on the
frames behind it overlaps the host's staging.

Traffic keys: ``quality``, ``pool`` (frames), ``depth``, ``warmup``
(frames), ``sample`` (frames kept for the check). A yielded frame is a view
that a later frame overwrites, so a kept frame's pixels are copied on the
card when the sample draws it, outside the span. The check compares each
kept frame's input streams with the plain reference's
(``reference/capture.py``) and its pixels with ``reference/playback.py``'s,
both of the frame's source pixels, which stay on the card.
"""

from __future__ import annotations

import itertools

import numpy as np

from benchmark.content import bgrx_job
from benchmark.lib import inputs, playback_work
from benchmark.lib.compare import bytes_off, elements_off
from benchmark.lib.driver import Base
from benchmark.reference import capture, container, playback
from myyuv_tpu_torch.engine import pipeline, streaming


def read_ahead(frames):
    """The frames' payloads back to back in one pageable buffer, each as a
    ``.myyuv`` file holds it (``reference/container.payload``) -> each
    frame's [(sizes, content)] x 3 as views of that buffer, as a player's
    parser leaves the read-ahead it holds in memory."""
    buf = np.concatenate([np.frombuffer(container.payload(streams),
                                        np.uint8) for streams in frames])
    pool, pos = [], 0
    for streams in frames:
        pos += 12                                 # u32 plane lengths
        views = []
        for sizes, content in streams:
            pos += 8                              # u32 n_blocks, length
            views.append((buf[pos:pos + sizes.size],
                          buf[pos + sizes.size:
                              pos + sizes.size + content.size]))
            pos += sizes.size + content.size
        pool.append(views)
    return pool


class Driver(Base):

    def setup(self) -> None:
        # first: a program without the playback driver fails here, at once
        decompress_stream = streaming.decompress_stream
        t, c = self.cell.traffic, self.cell.config
        self.quality = [int(q) for q in t["quality"]]
        self.h, self.w = c["height"], c["width"]
        depth = int(t["depth"])
        self.job = bgrx_job.pan_bgrx(int(t["pool"]), self.h, self.w,
                                     c["content"],
                                     inputs.generator(self.cell.seed,
                                                      self.dev), self.dev)
        self.dct, self.qt = pipeline.codec_params(self.quality, self.dev)
        self.pool = read_ahead(
            [[(sizes.copy(), content.copy()) for sizes, content in streams]
             for streams in streaming.compress_stream(
                 self.job, self.qt, self.dct, depth=depth)])
        self.chunk_bytes = [sum(int(content.size) for _, content in streams)
                            for streams in self.pool]
        self.yielded = 0
        self.stream = decompress_stream(
            self.frames(), self.qt, self.dct, self.h, self.w, depth=depth,
            precision=self.cell.precision)
        for _ in range(int(t.get("warmup", 2))):
            self.serve()

    def frames(self):
        """The pool's frames in order, round and round."""
        for k in itertools.count():
            yield self.pool[k % len(self.pool)]

    def serve(self):
        """The next frame's BGRX pixels and the frame's index in the
        pool."""
        k = self.yielded % len(self.pool)
        pixels = next(self.stream)
        self.yielded += 1
        return k, pixels

    def step(self) -> int:
        with self.spans.span("playback"):
            k, pixels = self.serve()
        self.add_work("playback", *playback_work.playback(
            self.h, self.w, self.chunk_bytes[k]))
        slot = self.sample.claim()
        if slot is not None:
            self.sample.put(slot, (k, pixels.clone()))
        return 1

    def release(self) -> None:
        self.stream.close()
        del self.stream, self.qt, self.dct

    def check(self):
        streams_off = pixels_off = 0
        refs = {}
        for k, pixels in self.sample.items:
            if k not in refs:
                refs[k] = (capture.frame_streams(self.job[k], self.quality),
                           playback.frame_bgrx(self.job[k], self.quality))
            ref_streams, ref_pixels = refs[k]
            streams_off += abs(len(self.pool[k]) - len(ref_streams))
            for (sizes, content), (ref_sizes, ref_content) in zip(
                    self.pool[k], ref_streams):
                streams_off += (
                    bytes_off(sizes.tobytes(), ref_sizes.tobytes())
                    + bytes_off(content.tobytes(), ref_content.tobytes()))
            pixels_off += elements_off(pixels, ref_pixels)
        return [("streams_off", streams_off, 0), ("pixels_off", pixels_off, 0)]
