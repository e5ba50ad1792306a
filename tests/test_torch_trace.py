"""The port's span recorder (``runtime/trace.py``) on the CPU: off it
records nothing and hands out one shared no-op; on it records the named
spans of the main paths, nested as the calls nest, one ``wait.*`` span for
each place where the host would block on the card, and no pageable bytes
on the CPU route."""

import collections
import itertools
import tracemalloc
import types

import numpy as np
import pytest
import torch

from myyuv_tpu_torch.engine import device_stream, pipeline, streaming, sweep
from myyuv_tpu_torch.formats import yuv
from myyuv_tpu_torch.kernels import convert
from myyuv_tpu_torch.runtime import trace
from myyuv_tpu_torch.runtime.errors import BitstreamError

CPU = torch.device("cpu")

COMPRESS_TREE = [
    ("yuv.from_bytes", 0),
    ("pipeline.compress_dct", 0),
    ("pipeline.codec_params", 1), ("wait.h2d", 2), ("wait.h2d", 2),
    ("wait.h2d", 1), ("wait.h2d", 1), ("wait.h2d", 1),
    ("stream.compress_frame", 1), ("wait.size", 2),
    ("wait.d2h", 1), ("wait.d2h", 1),
    ("stream.split", 1),
    ("dct_stream.serialize", 1),
    ("yuv.to_bytes", 0),
]
DECOMPRESS_TREE = [
    ("yuv.from_bytes", 0),
    ("pipeline.decompress_dct", 0),
    ("dct_stream.parse", 1),
    ("pipeline.codec_params", 1), ("wait.h2d", 2), ("wait.h2d", 2),
    ("wait.h2d", 1), ("wait.h2d", 1),
    ("stream.decompress_frame", 1), ("wait.err", 2),
    ("wait.d2h", 1), ("wait.d2h", 1), ("wait.d2h", 1),
    ("yuv.from_planes", 1),
    ("yuv.to_bytes", 0),
]


@pytest.fixture(autouse=True)
def recorder_off():
    trace.stop()
    yield
    trace.stop()


def _raw_file(rng, h=32, w=48):
    planes = [rng.integers(0, 256, s, np.uint8)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    img = yuv.YUVImage.from_planes(yuv.FourccFormats.IYUV, planes, w, h)
    return planes, img.to_bytes()


def _file_roundtrip(raw):
    packed = pipeline.compress_dct(yuv.YUVImage.from_bytes(raw),
                                   bytes([50, 50, 50]), device=CPU).to_bytes()
    return packed, pipeline.decompress_dct(yuv.YUVImage.from_bytes(packed),
                                           device=CPU).to_bytes()


def _tree(spans):
    """(name, depth) in the order the spans started."""
    return [(n, d) for n, d, _, _ in sorted(spans, key=lambda s: (s[2], s[1]))]


def _waits(spans):
    return collections.Counter(n for n, _, _, _ in spans
                               if n.startswith("wait."))


def test_off_records_nothing_and_shares_one_no_op(rng, monkeypatch):
    _, raw = _raw_file(rng)
    trace.start()
    assert trace.stop() == ([], {})
    assert trace.span("a") is trace.span("b")
    clock = types.SimpleNamespace(time_ns=lambda: pytest.fail("clock read"))
    monkeypatch.setattr(trace, "time", clock)
    with trace.span("outside"):
        trace.add("pageable_bytes.h2d", 7)
    _file_roundtrip(raw)
    assert trace.stop() == ([], {})


def test_off_allocates_nothing_a_call():
    def peak(n):
        tracemalloc.start()
        try:
            for _ in itertools.repeat(None, n):
                with trace.span("x"):
                    trace.add("y", 1)
            return tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()

    peak(10)
    few, many = peak(10), peak(10_000)
    assert many == few and few[0] == 0


def test_on_records_the_file_path_with_its_nesting(rng):
    _, raw = _raw_file(rng)
    trace.start()
    packed = pipeline.compress_dct(yuv.YUVImage.from_bytes(raw),
                                   bytes([50, 50, 50]), device=CPU).to_bytes()
    spans, counters = trace.stop()
    assert _tree(spans) == COMPRESS_TREE
    trace.start()
    pipeline.decompress_dct(yuv.YUVImage.from_bytes(packed),
                            device=CPU).to_bytes()
    spans, counters = trace.stop()
    assert _tree(spans) == DECOMPRESS_TREE
    assert counters == {}
    # each span lies inside its parent: the last one a level up that
    # started before it
    for name, depth, t0, t1 in spans:
        assert t0 <= t1
        outer = [s for s in spans if s[1] == depth - 1 and s[2] <= t0]
        if depth:
            parent = max(outer, key=lambda s: s[2])
            assert parent[2] <= t0 and t1 <= parent[3], name


def test_waits_do_not_nest_and_formats_spans_do_not_nest(rng):
    _, raw = _raw_file(rng)
    trace.start()
    _file_roundtrip(raw)
    spans, _ = trace.stop()
    for prefixes in (("wait.",), ("yuv.", "dct_stream.")):
        inner = [s for s in spans if s[0].startswith(prefixes)]
        for a in inner:
            for b in inner:
                assert a is b or a[3] <= b[2] or b[3] <= a[2], (a, b)


@pytest.mark.parametrize("path,want", [
    ("compress_dct", {"wait.h2d": 5, "wait.size": 1, "wait.d2h": 2}),
    ("decompress_dct", {"wait.h2d": 4, "wait.err": 1, "wait.d2h": 3}),
    ("quality_sweep", {"wait.h2d": 3 + 2 * 2, "wait.size": 2,
                       "wait.scalar": 2 * 10}),
    ("compress_batch", {"wait.size": 1}),
    ("decompress_batch", {"wait.err": 1}),
    ("roundtrip_batch", {}),
])
def test_wait_spans_per_call_are_pinned(rng, path, want):
    planes, raw = _raw_file(rng)
    packed, _ = _file_roundtrip(raw)
    dct, qt = pipeline.codec_params([50] * 3, CPU)
    batch = [torch.from_numpy(np.stack([p, p])) for p in planes]
    sizes, content = device_stream.compress_batch(*batch, qt, dct)
    calls = {
        "compress_dct": lambda: pipeline.compress_dct(
            yuv.YUVImage.from_bytes(raw), bytes([50] * 3), device=CPU),
        "decompress_dct": lambda: pipeline.decompress_dct(
            yuv.YUVImage.from_bytes(packed), device=CPU),
        "quality_sweep": lambda: sweep.quality_sweep(planes, (10, 90),
                                                     device=CPU),
        "compress_batch": lambda: device_stream.compress_batch(*batch, qt,
                                                               dct),
        "decompress_batch": lambda: device_stream.decompress_batch(
            content, sizes, qt, dct, 2, 32, 48),
        "roundtrip_batch": lambda: device_stream.roundtrip_batch(*batch, qt,
                                                                 dct),
    }
    trace.start()
    calls[path]()
    spans, counters = trace.stop()
    assert _waits(spans) == want
    assert counters.get("pageable_bytes.h2d", 0) == 0
    assert counters.get("pageable_bytes.d2h", 0) == 0
    assert counters.get("err.search", 0) == 0


@pytest.mark.parametrize("entry", ["compress_batch", "compress_frame",
                                   "decompress_batch", "decompress_frame"])
def test_a_bad_block_takes_the_search_and_raises_the_same_message(
        rng, monkeypatch, entry):
    """A nonzero error code at block 5 (the encoder's: a chunk past its
    8-bit size) or block 7 (the decoder's code 3): the entry's one wait
    reads the flag, then the search (``wait.err``, counter ``err.search``
    at 1) names the block in the message the entries have always
    raised."""
    planes, _ = _raw_file(rng)
    dct, qt = pipeline.codec_params([50] * 3, CPU)
    batch = [torch.from_numpy(np.stack([p, p])) for p in planes]
    frame = [torch.from_numpy(p) for p in planes]
    sizes, content = device_stream.compress_batch(*batch, qt, dct)
    fsizes, fcontent = device_stream.compress_frame(*frame, qt, dct)
    lanes_of, planes_of = device_stream.frame_lanes, device_stream.frame_planes

    def too_long(*a, **k):
        lanes, sizes, err = lanes_of(*a, **k)
        sizes, err = sizes.clone(), err.clone()
        sizes[5], err[5] = 300, 1
        return lanes, sizes, err

    def corrupt(*a, **k):
        *out, err = planes_of(*a, **k)
        err = err.clone()
        err[7] = 3
        return (*out, err)
    monkeypatch.setattr(device_stream, "frame_lanes", too_long)
    monkeypatch.setattr(device_stream, "frame_planes", corrupt)
    calls = {
        "compress_batch": lambda: device_stream.compress_batch(*batch, qt,
                                                               dct),
        "compress_frame": lambda: device_stream.compress_frame(*frame, qt,
                                                               dct),
        "decompress_batch": lambda: device_stream.decompress_batch(
            content, sizes, qt, dct, 2, 32, 48),
        "decompress_frame": lambda: device_stream.decompress_frame(
            fcontent, fsizes, qt, dct, 32, 48),
    }
    trace.start()
    with pytest.raises(BitstreamError) as raised:
        calls[entry]()
    spans, counters = trace.stop()
    if entry.startswith("compress"):
        assert str(raised.value) == "Huffman encode failed at block 5 (code 1)"
        assert _waits(spans) == {"wait.size": 1, "wait.err": 1}
    else:
        assert str(raised.value) == "Huffman decode failed at block 7 (code 3)"
        assert _waits(spans) == {"wait.err": 2}
    assert counters["err.search"] == 1


def test_sweep_records_one_span_a_quality(rng):
    planes, _ = _raw_file(rng)
    trace.start()
    sweep.quality_sweep(planes, (10, 50, 90), device=CPU)
    spans, _ = trace.stop()
    names = collections.Counter(n for n, _, _, _ in spans)
    assert names["sweep.quality"] == 3
    assert names["pipeline.codec_params"] == 3


def test_start_clears_the_previous_run(rng):
    _, raw = _raw_file(rng)
    trace.start()
    _file_roundtrip(raw)
    trace.add("pageable_bytes.h2d", 5)
    first, counters = trace.stop()
    assert first and counters == {"pageable_bytes.h2d": 5}
    trace.start()
    with trace.span("only"):
        pass
    spans, counters = trace.stop()
    assert [s[:2] for s in spans] == [("only", 0)] and counters == {}


def _bgrx(rng, n=3, h=32, w=48):
    return [torch.from_numpy(rng.integers(0, 256, (h, w, 4), np.uint8))
            for _ in range(n)]


@pytest.mark.parametrize("frames", ["bgrx", "planes"])
def test_compress_stream_records_ingest_and_its_two_waits(rng, frames):
    """A frame of ``compress_stream``: ``stream.ingest_frame`` (BGRX only),
    then at assembly ``wait.event``, ``wait.pull`` and ``stream.split``,
    each at depth 0 below a caller that opened no span; no pinned bytes on
    the CPU route; nothing recorded while the recorder is off."""
    dct, qt = pipeline.codec_params([50] * 3, CPU)
    px = _bgrx(rng)
    stream = (px if frames == "bgrx"
              else [convert.bgrx_to_iyuv(p) for p in px])
    trace.start()
    got = list(streaming.compress_stream(stream, qt, dct, depth=2))
    spans, counters = trace.stop()
    assert len(got) == 3
    want = {("wait.event", 0): 3, ("wait.pull", 0): 3, ("stream.split", 0): 3}
    if frames == "bgrx":
        want[("stream.ingest_frame", 0)] = 3
    assert collections.Counter(s[:2] for s in spans) == want
    assert _waits(spans) == {"wait.event": 3, "wait.pull": 3}
    assert "pinned_bytes.d2h" not in counters and counters == {}
    # assembly: the event's wait, then the pull's, then the split
    order = [n for n, _, _, _ in sorted(spans, key=lambda s: s[2])
             if n != "stream.ingest_frame"]
    assert order == ["wait.event", "wait.pull", "stream.split"] * 3

    trace.start()
    trace.stop()
    list(streaming.compress_stream(stream, qt, dct))
    assert trace.stop() == ([], {})


@pytest.mark.parametrize("entry", ["ingest_frame", "ingest_stream"])
def test_ingest_entries_record_the_ingest_span(rng, entry):
    dct, qt = pipeline.codec_params([50] * 3, CPU)
    px = _bgrx(rng, n=2)
    trace.start()
    if entry == "ingest_frame":
        device_stream.ingest_frame(px[0], qt, dct)
        n = 1
    else:
        streaming.ingest_stream(px, qt, dct)
        n = 2
    spans, counters = trace.stop()
    assert [s[:2] for s in spans] == [("stream.ingest_frame", 0)] * n
    assert counters == {}


@pytest.mark.parametrize(
    "device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_decompress_stream_records_stage_decode_and_its_wait(rng, device):
    """A frame of ``decompress_stream``: ``stream.stage``, then
    ``stream.decode_frame``, then at its turn ``wait.event``, each at depth
    0 below a caller that opened no span; on the CPU nothing is counted, on
    a CUDA device ``pinned_bytes.h2d`` counts each frame's N one-byte sizes
    and T chunk bytes."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    h, w = 32, 48
    dct, qt = pipeline.codec_params([50] * 3, CPU)
    streams = list(streaming.compress_stream(_bgrx(rng, n=3, h=h, w=w), qt,
                                             dct))
    dct, qt = pipeline.codec_params([50] * 3, device)
    trace.start()
    got = list(streaming.decompress_stream(streams, qt, dct, h, w, depth=1))
    spans, counters = trace.stop()
    assert len(got) == 3
    assert collections.Counter(s[:2] for s in spans) == {
        ("stream.stage", 0): 3, ("stream.decode_frame", 0): 3,
        ("wait.event", 0): 3}
    order = [n for n, _, _, _ in sorted(spans, key=lambda s: s[2])]
    assert order == ["stream.stage", "stream.decode_frame"] * 2 + [
        "wait.event", "stream.stage", "stream.decode_frame"] + [
        "wait.event"] * 2
    nbytes = sum(s.size + c.size for st in streams for s, c in st)
    assert counters == ({} if device == "cpu"
                        else {"pinned_bytes.h2d": nbytes})
