"""Spans of the program's own recorder (``myyuv_tpu_torch/runtime/trace.py``)
in the trace reduction as it stands: placed deeper than any of the
benchmark's spans, they leave every per-layer metric and the device
breakdown as they were and take the idle time under them. The harness does
not start the recorder yet; these tests hold the records' format and clock
to what ``trace.summarise`` reads."""

import numpy as np
import pytest

from benchmark.lib import trace
from benchmark.lib.manifest import Manifest
from benchmark.lib.spans import Spans
from conftest import REPO
from myyuv_tpu_torch.engine import pipeline
from myyuv_tpu_torch.formats import yuv
from myyuv_tpu_torch.runtime import trace as recorder

MS = 1_000_000
PEAK = {"bytes_per_s": 3.35e12, "f32_per_s": 67e12}
BENCH = [("compress", 0, 0, 10 * MS), ("decompress", 0, 10 * MS, 20 * MS),
         ("sweep", 0, 20 * MS, 30 * MS), ("step", 1, 22 * MS, 26 * MS),
         ("compress_batch", 0, 30 * MS, 34 * MS),
         ("decompress_batch", 0, 34 * MS, 38 * MS),
         ("roundtrip_batch", 0, 38 * MS, 40 * MS)]
PROGRAM = [("yuv.from_bytes", 0, 0, 1 * MS),
           ("pipeline.compress_dct", 0, 1 * MS, 9 * MS),
           ("wait.h2d", 1, 2 * MS, 3 * MS),
           ("stream.compress_frame", 1, 3 * MS, 7 * MS),
           ("wait.size", 2, 5 * MS, 6 * MS),
           ("wait.d2h", 1, 7 * MS, 8 * MS),
           ("yuv.to_bytes", 0, 9 * MS, 10 * MS),
           ("pipeline.decompress_dct", 0, 11 * MS, 19 * MS),
           ("sweep.quality", 0, 21 * MS, 29 * MS),
           ("wait.scalar", 1, 27 * MS, 28 * MS),
           ("stream.compress_frame", 0, 30 * MS, 34 * MS),
           ("stream.decompress_frame", 0, 34 * MS, 38 * MS),
           ("stream.roundtrip_frame", 0, 38 * MS, 40 * MS)]
OPS = [("Memcpy HtoD (Pageable -> Device)", 2 * MS, 3 * MS, 2 * MS),
       ("k1", 4 * MS, 5 * MS, 3 * MS + 1),
       ("Memcpy DtoH (Device -> Pageable)", 7 * MS, 8 * MS, 7 * MS),
       ("k2", 13 * MS, 15 * MS, 12 * MS),
       ("k3", 23 * MS, 24 * MS, 22 * MS + 5),
       ("k1", 31 * MS, 33 * MS, 30 * MS + 5),
       ("k2", 35 * MS, 36 * MS, 34 * MS + 5),
       ("k1", 38 * MS + 10, 40 * MS, 38 * MS + 5)]
WORK = {"compress_batch": [1e6, 1e9, 1], "decompress_batch": [1e6, 1e9, 1],
        "roundtrip_batch": [2e6, 2e9, 1], "step": [1e6, 1e9, 1]}


def merged(bench, program):
    """The benchmark's spans and the program's, the program's one level
    deeper than the benchmark's deepest."""
    base = 1 + max((s[1] for s in bench), default=-1)
    return list(bench) + [(n, base + d, a, b) for n, d, a, b in program]


def test_program_spans_leave_every_per_layer_metric_as_it_was():
    plain = trace.summarise(OPS, BENCH, 0, 40 * MS, 4, WORK, PEAK)
    both = trace.summarise(OPS, merged(BENCH, PROGRAM), 0, 40 * MS, 4, WORK,
                           PEAK)
    m = Manifest(REPO)
    for x in m.data["per_layer"]:
        assert m.reader(x["name"])(both) == m.reader(x["name"])(plain), x
    assert both.device_top == plain.device_top
    assert (both.busy_s, both.kernels) == (plain.busy_s, plain.kernels)
    for name, s in plain.spans.items():
        assert both.spans[name] == s, name
    assert both.span("wait.scalar").count == 1


def test_a_program_span_inside_a_benchmark_span_takes_its_idle_time():
    plain = trace.summarise(OPS, BENCH, 0, 10 * MS, 1, WORK, PEAK)
    both = trace.summarise(OPS, merged(BENCH, PROGRAM), 0, 10 * MS, 1, WORK,
                           PEAK)
    assert dict(plain.idle_top) == pytest.approx({"compress": 0.007})
    # 0-1 from_bytes, 1-2 and 8-9 compress_dct, 3-4 and 6-7
    # compress_frame, 5-6 wait.size, 9-10 to_bytes; wait.h2d and wait.d2h
    # have a copy under them
    assert dict(both.idle_top) == pytest.approx({
        "yuv.from_bytes": 0.001, "pipeline.compress_dct": 0.002,
        "stream.compress_frame": 0.002, "wait.size": 0.001,
        "yuv.to_bytes": 0.001})


def test_recorded_spans_share_the_benchmarks_clock_and_format():
    """A file request on the CPU inside the benchmark's spans, the
    program's recorder on: every program span lies inside the benchmark's
    window, and the reduction counts its waits."""
    h, w = 32, 48
    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 256, s, np.uint8)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    raw = yuv.YUVImage.from_planes(yuv.FourccFormats.IYUV, planes, w,
                                   h).to_bytes()
    spans = Spans()
    recorder.start()
    try:
        with spans.span("compress"):
            packed = pipeline.compress_dct(yuv.YUVImage.from_bytes(raw),
                                           bytes([50] * 3), "cpu").to_bytes()
        with spans.span("decompress"):
            pipeline.decompress_dct(yuv.YUVImage.from_bytes(packed),
                                    "cpu").to_bytes()
    finally:
        program, counters = recorder.stop()
    assert counters == {} and len(program) == 16 + 15
    t0, t1 = spans.records[0][2], spans.records[-1][3]
    assert all(t0 <= a <= b <= t1 for _, _, a, b in program)
    s = trace.summarise([], merged(spans.records, program), t0, t1, 1, {},
                        PEAK)
    assert s.span("wait.h2d").count == 9 and s.span("wait.d2h").count == 5
    assert s.span("compress").count == s.span("decompress").count == 1
    idle = dict(s.idle_top)
    assert sum(v for n, v in idle.items() if "." in n) > 0.5 * sum(
        idle.values())
