"""The output check fails where it should: the control (the program's own
lower-precision path, ``precision="fast"``) and the timed path broken
underneath in each way a cell can break. Every run here skips the look for
a card and drives the rest of a run at a small size on the CPU."""

import time

import pytest
import torch

from benchmark.lib.harness import run_cell
from benchmark.lib.manifest import Manifest
from myyuv_tpu_torch.engine import batch as batch_module
from myyuv_tpu_torch.engine import device_stream as ds

CPU = torch.device("cpu")
CELLS = ["still992.q50.file", "video1080.q50.batch8", "still4k.rdsweep",
         "video1080.q90.roundtrip8"]


def run(root, cell, precision="exact", seed=2 ** 31 + 77):
    return run_cell(Manifest(root), cell, seed, 0.3, False, CPU,
                    time.perf_counter(), precision)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_root, cell):
    result = run(small_root, cell)
    assert result.correct, result.checks
    assert all(v == 0 for _, v, _ in result.checks)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small_root, cell):
    result = run(small_root, cell, precision="fast")
    assert not result.correct
    assert any(v > lim for _, v, lim in result.checks)


def _flip(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    t.view(-1)[t.numel() // 2] ^= 1
    return t


def _halve(planes):
    """Planes [..., H, W] whose lower half of rows (or of frames, for a
    batch) is left out and filled with the upper half."""
    out = []
    for p in planes:
        axis = 0 if p.dim() == 3 else -2
        half = p.narrow(axis, 0, p.shape[axis] // 2)
        out.append(torch.cat([half, half], axis).contiguous())
    return out


def altered(monkeypatch, cell):
    """An answer altered where it is produced."""
    if cell == "still4k.rdsweep":
        step = batch_module.roundtrip_step

        def bad_step(*a, **k):
            out, m = step(*a, **k)
            return out, dict(m, sse_y=m["sse_y"] + 1e6)
        monkeypatch.setattr(batch_module, "roundtrip_step", bad_step)
    elif cell == "video1080.q90.roundtrip8":
        planes = ds.frame_planes
        monkeypatch.setattr(ds, "frame_planes", lambda *a, **k: (
            _flip(planes(*a, **k)[0]), *planes(*a, **k)[1:]))
    else:
        compact = ds.compact_chunks
        monkeypatch.setattr(ds, "compact_chunks",
                            lambda *a: _flip(compact(*a)))


def half_left_out(monkeypatch, cell):
    """Half of the batch (or of a frame's rows) left out, the rest in its
    place."""
    if cell == "still4k.rdsweep":
        step = batch_module.roundtrip_step
        monkeypatch.setattr(batch_module, "roundtrip_step",
                            lambda y, u, v, *a, **k: step(
                                *_halve([y, u, v]), *a, **k))
    elif cell == "video1080.q90.roundtrip8":
        rt = ds.roundtrip_batch
        monkeypatch.setattr(ds, "roundtrip_batch", lambda y, u, v, *a, **k:
                            rt(*_halve([y, u, v]), *a, **k))
    elif cell == "video1080.q50.batch8":
        cb = ds.compress_batch
        monkeypatch.setattr(ds, "compress_batch", lambda y, u, v, *a, **k:
                            cb(*_halve([y, u, v]), *a, **k))
    else:
        cf = ds.compress_frame
        monkeypatch.setattr(ds, "compress_frame", lambda y, u, v, *a, **k:
                            cf(*_halve([y, u, v]), *a, **k))


def unchanged(monkeypatch, cell):
    """A step that returns its state unchanged: the input for the output,
    or the first call's output again."""
    if cell == "still4k.rdsweep":
        step = batch_module.roundtrip_step

        def same(y, u, v, *a, **k):
            _, m = step(y, u, v, *a, **k)
            zero = torch.zeros((), dtype=torch.float32)
            return (y, u, v), dict(m, sse_y=zero, sse_u=zero, sse_v=zero)
        monkeypatch.setattr(batch_module, "roundtrip_step", same)
    elif cell == "video1080.q90.roundtrip8":
        rt = ds.roundtrip_batch
        monkeypatch.setattr(ds, "roundtrip_batch", lambda y, u, v, *a, **k:
                            ((y, u, v), *rt(y, u, v, *a, **k)[1:]))
    elif cell == "video1080.q50.batch8":
        cb, first = ds.compress_batch, []

        def stale(*a, **k):
            if not first:
                first.append(cb(*a, **k))
            return first[0]
        monkeypatch.setattr(ds, "compress_batch", stale)
    else:
        from myyuv_tpu_torch.engine import pipeline
        monkeypatch.setattr(pipeline, "compress_dct",
                            lambda img, *a, **k: img)


@pytest.mark.parametrize("fault", [altered, half_left_out, unchanged])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(small_root, monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    try:
        result = run(small_root, cell)
    except Exception:  # the warm-up failed: the run prints no result
        return
    assert not result.correct
    assert result.failed or any(v > lim for _, v, lim in result.checks)


def _pixel_off(monkeypatch):
    """One reconstructed pixel off by one, the statistics left as they
    were: the PSNRs, rounded, do not move."""
    step = batch_module.roundtrip_step

    def bad(*a, **k):
        (ry, ru, rv), m = step(*a, **k)
        return (_flip(ry), ru, rv), m
    monkeypatch.setattr(batch_module, "roundtrip_step", bad)


def _hist_off(monkeypatch):
    """One count of the symbol histogram moved to the next bin: the
    entropy, rounded, barely moves."""
    step = batch_module.roundtrip_step

    def bad(*a, **k):
        out, m = step(*a, **k)
        hist = m["symbol_hist"].clone()
        top = int(hist.argmax())
        hist[top] -= 1
        hist[top + 1] += 1
        return out, dict(m, symbol_hist=hist)
    monkeypatch.setattr(batch_module, "roundtrip_step", bad)


@pytest.mark.parametrize("fault", [_pixel_off, _hist_off])
def test_sweep_sees_its_reconstruction_and_histogram(small_root,
                                                     monkeypatch, fault):
    fault(monkeypatch)
    result = run(small_root, "still4k.rdsweep")
    assert not result.correct
    checks = {name: value for name, value, _ in result.checks}
    assert checks["pixels_off"] > 0 or checks["hist_bins_off"] > 0
