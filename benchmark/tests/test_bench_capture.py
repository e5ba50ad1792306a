"""The capture cell small on the CPU (``capture2160`` cut to 32 x 64, a job
of 3 frames, every frame of the window checked): a sound run is correct,
and the check fails for the control (``precision="fast"``) and for the
streamed path broken where it produces its answer: a stream byte flipped,
half a frame's rows left out, the first frame's streams returned again.

At this size F1's roundings change a chunk in about one frame in six (3 of
18 over six seeds); the seed is one whose first frame, the window's first,
is such a frame, so the control fails whatever the window's length."""

import json
import time

import pytest
import torch

from benchmark.lib.harness import run_cell
from benchmark.lib.manifest import Manifest
from conftest import make_small
from myyuv_tpu_torch.engine import device_stream as ds

CPU = torch.device("cpu")
CELL = "capture2160.q50.stream"


@pytest.fixture
def root(tmp_path):
    root = make_small(tmp_path)
    path = root / "benchmark" / "configs" / "capture2160.json"
    c = json.loads(path.read_text())
    c["height"], c["width"] = 32, 64
    c["content"].update(r_max=40, pan=[8, 16])
    path.write_text(json.dumps(c))
    path = root / "benchmark" / "traffic" / "q50.stream.json"
    t = json.loads(path.read_text())
    t["sample"] = 64
    path.write_text(json.dumps(t))
    return root


def run(root, precision="exact", traced=False, seed=2 ** 31 + 93):
    return run_cell(Manifest(root), CELL, seed, 0.3, traced, CPU,
                    time.perf_counter(), precision)


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(root, traced):
    result = run(root, traced=traced)
    assert result.correct, result.checks
    assert [(n, v) for n, v, _ in result.checks] == [("streams_off", 0)]
    assert result.attempted > 3          # more frames than the job holds
    if not traced:
        assert set(result.metrics) == {"frames_per_s", "setup_s"}


def test_control_is_not_correct(root):
    result = run(root, precision="fast")
    assert not result.correct
    assert any(v > lim for _, v, lim in result.checks)


def flipped(monkeypatch):
    """One byte of each frame's chunk stream flipped as the compaction
    writes it."""
    scatter = ds.scatter_chunks

    def bad(lanes, sizes):
        content, total = scatter(lanes, sizes)
        content = content.clone()
        content[int(total) // 2] ^= 1
        return content, total
    monkeypatch.setattr(ds, "scatter_chunks", bad)


def half_left_out(monkeypatch):
    """The lower half of each frame's rows left out, the upper half in its
    place."""
    ingest = ds._ingest

    def bad(pixels, *a, **k):
        half = pixels[:pixels.shape[0] // 2]
        return ingest(torch.cat([half, half]).contiguous(), *a, **k)
    monkeypatch.setattr(ds, "_ingest", bad)


def first_again(monkeypatch):
    """Every frame's streams those of the first frame."""
    split, first = ds.split_planes, []

    def stale(*a, **k):
        if not first:
            first.append(split(*a, **k))
        return first[0]
    monkeypatch.setattr(ds, "split_planes", stale)


@pytest.mark.parametrize("fault", [flipped, half_left_out, first_again])
def test_broken_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    result = run(root)
    assert not result.correct
    assert result.failed or any(v > lim for _, v, lim in result.checks)
