"""The playback cell small on the CPU (``playback2160`` cut to 128 x 256, a
pool of 3 frames, every frame of the window checked): a sound run is
correct, the reference's pixels are the port's CPU route's, and the check
fails for the control (``precision="fast"``) and for the streamed path
broken where it reads or produces its answer: one BGRX byte altered, one
input chunk byte altered.

F2's roundings move a pixel in a few frames of this size (none in 64 x 128
frames on three seeds); the control's seed is one whose first two frames
hold such pixels, so it fails whatever the window's length."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.content import bgrx_job
from benchmark.drivers import playback_stream
from benchmark.lib import inputs
from benchmark.lib.harness import run_cell
from benchmark.lib.manifest import Manifest
from benchmark.reference import container, playback
from conftest import REPO, make_small
from myyuv_tpu_torch.engine import device_stream as ds
from myyuv_tpu_torch.engine import pipeline, streaming
from myyuv_tpu_torch.kernels import convert

CPU = torch.device("cpu")
CELL = "playback2160.q50.play"
H, W = 128, 256


@pytest.fixture
def root(tmp_path):
    root = make_small(tmp_path)
    path = root / "benchmark" / "configs" / "playback2160.json"
    c = json.loads(path.read_text())
    c["height"], c["width"] = H, W
    c["content"].update(r_max=40, pan=[8, 16])
    path.write_text(json.dumps(c))
    path = root / "benchmark" / "traffic" / "q50.play.json"
    t = json.loads(path.read_text())
    t["sample"] = 64
    path.write_text(json.dumps(t))
    return root


def run(root, precision="exact", traced=False, seed=2 ** 31 + 93):
    return run_cell(Manifest(root), CELL, seed, 1.0, traced, CPU,
                    time.perf_counter(), precision)


def test_reference_equals_the_ports_cpu_route():
    """``reference/playback.frame_bgrx`` of a job's frames: the port's
    plain route on the same frames (compress, decompress, X2)."""
    config = json.loads((REPO / "benchmark" / "configs"
                         / "playback2160.json").read_text())
    job = bgrx_job.pan_bgrx(2, H, W, dict(config["content"], r_max=40,
                                          pan=[8, 16]),
                            inputs.generator(7, CPU), CPU)
    dct, qt = pipeline.codec_params([50] * 3, CPU)
    for px in job:
        planes = [p.numpy() for p in convert.bgrx_to_iyuv(px)]
        streams = ds.compress_frame_to_streams(planes, qt, dct)
        rec = ds.decompress_streams_to_frame(streams, qt, dct, H, W)
        want = convert.iyuv_to_bgrx(*(torch.from_numpy(p) for p in rec))
        assert torch.equal(playback.frame_bgrx(px, [50] * 3), want)


def test_pool_is_one_buffer_of_the_files_payloads():
    """``read_ahead``: the frames' payloads back to back in one buffer, as
    their files hold them, each stream a view of it equal to its input."""
    rng = np.random.default_rng(3)
    frames = [[(rng.integers(0, 40, n, dtype=np.uint8),
                rng.integers(0, 256, t, dtype=np.uint8))
               for n, t in ((12, 90), (3, 20), (3, 17))] for _ in range(4)]
    pool = playback_stream.read_ahead(frames)
    buf = pool[0][0][0].base
    assert buf is not None and all(a.base is buf for frame in pool
                                   for stream in frame for a in stream)
    assert buf.tobytes() == b"".join(container.payload(f) for f in frames)
    for got, want in zip(pool, frames):
        for (s, c), (ws, wc) in zip(got, want):
            assert np.array_equal(s, ws) and np.array_equal(c, wc)


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(root, traced):
    result = run(root, traced=traced)
    assert result.correct, result.checks
    assert [(n, v) for n, v, _ in result.checks] == [("streams_off", 0),
                                                    ("pixels_off", 0)]
    assert result.attempted > 3          # more frames than the pool holds
    if not traced:
        assert set(result.metrics) == {"frames_per_s", "setup_s"}


def test_control_is_not_correct(root):
    result = run(root, precision="fast", seed=5)
    assert not result.correct
    assert dict((n, v) for n, v, _ in result.checks)["pixels_off"] > 0


def pixel_altered(monkeypatch):
    """One byte of each frame's BGRX pixels flipped as the step makes
    them."""
    play = ds.play_frame

    def bad(*a, **k):
        pixels, ok, err = play(*a, **k)
        pixels = pixels.clone()
        pixels[H // 2, W // 2, 1] ^= 1
        return pixels, ok, err
    monkeypatch.setattr(ds, "play_frame", bad)


def chunk_altered(monkeypatch):
    """One payload byte of each frame's last Y chunk flipped in the pool
    the set-up keeps."""
    coded = streaming.compress_stream

    def bad(*a, **k):
        for streams in coded(*a, **k):
            sizes, content = streams[0]
            content = content.copy()
            content[-1] ^= 0x10
            yield [(sizes, content), *streams[1:]]
    monkeypatch.setattr(streaming, "compress_stream", bad)


@pytest.mark.parametrize("fault", [pixel_altered, chunk_altered])
def test_broken_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    result = run(root)
    assert not result.correct
    assert result.failed or any(v > lim for _, v, lim in result.checks)
