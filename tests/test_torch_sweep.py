"""The port's RD sweep (``engine/sweep.py``), its RD tool
(``tools/rd_sweep.py``) and ``entry()`` against the JAX package on the
CPU.

Tolerance: ``quality``, ``compressed_bytes`` and ``bits_per_pixel``
exact. ``psnr_*_db`` to 1e-3 and ``entropy_bits_per_symbol`` to 1e-4
(plus 1e-9 for the float difference of two rounded values): both
packages round them to 3 and 4 decimals, and they come from float32 sums
over the frame taken in different orders, so the last digit can flip.
``entry()``'s planes and histogram exact, its float32 sums to rtol 1e-6
(``tests/test_torch_batch.py``'s reason)."""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from myyuv_tpu import native
from myyuv_tpu.engine import sweep as jax_sweep
from myyuv_tpu_torch import entry
from myyuv_tpu_torch.engine import sweep
from myyuv_tpu_torch.tools import rd_sweep

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import __graft_entry__ as graft  # noqa: E402

QUALITIES = (10, 90)
BACKENDS = (None, "device")
ROUNDED = {"psnr_y_db": 1e-3, "psnr_u_db": 1e-3, "psnr_v_db": 1e-3,
           "entropy_bits_per_symbol": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def _native():
    if not native.available():
        pytest.skip("native entropy library unavailable")


@pytest.fixture(scope="module")
def planes():
    return rd_sweep.picture_planes(np.random.default_rng(3), (32, 64),
                                   torch.device("cpu"))


@pytest.fixture(scope="module")
def jax_points(planes):
    """JAX's sweep on both backends ("device": its frame codec, Pallas in
    interpret mode)."""
    return {b: jax_sweep.quality_sweep(planes, QUALITIES, entropy_backend=b)
            for b in BACKENDS}


def _same_point(got, want):
    assert got.keys() == want.keys()
    for key in ("quality", "compressed_bytes", "bits_per_pixel"):
        assert got[key] == want[key], key
    for key, tol in ROUNDED.items():
        assert abs(got[key] - want[key]) <= tol + 1e-9, key


@pytest.mark.parametrize("backend", BACKENDS)
def test_quality_sweep_matches_jax(planes, jax_points, backend):
    got = sweep.quality_sweep(planes, QUALITIES, entropy_backend=backend,
                              device="cpu")
    assert len(got) == len(QUALITIES)
    for g, want in zip(got, jax_points[backend]):
        _same_point(g, want)


def test_rate_routes_agree(planes, jax_points):
    """K3 then K5 and K1 give the same byte count, which is JAX's on both
    of its backends; the RD curve rises with the quality."""
    coder, frame = (sweep.quality_sweep(planes, QUALITIES,
                                        entropy_backend=b, device="cpu")
                    for b in BACKENDS)
    for c, f, j0, j1 in zip(coder, frame, *jax_points.values()):
        assert (c["compressed_bytes"] == f["compressed_bytes"]
                == j0["compressed_bytes"] == j1["compressed_bytes"])
    assert coder[0]["compressed_bytes"] < coder[1]["compressed_bytes"]
    assert coder[0]["psnr_y_db"] < coder[1]["psnr_y_db"]


def test_quality_sweep_refuses_what_it_cannot_do(planes):
    with pytest.raises(ValueError):
        sweep.quality_sweep(planes, QUALITIES, entropy_backend="device",
                            time_device=True, device="cpu")
    with pytest.raises(ValueError):
        sweep.quality_sweep(planes, QUALITIES, entropy_backend="native",
                            device="cpu")


def test_entry_step_matches_jax():
    step, args = entry.entry(device="cpu")
    jstep, jargs = graft.entry()
    for a, j in zip(args, jargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    (ry, ru, rv), m = step(*args)
    (jy, ju, jv), jm = jax.jit(jstep)(*jargs)
    for g, j in zip((ry, ru, rv), (jy, ju, jv)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    np.testing.assert_array_equal(m["symbol_hist"].numpy(),
                                  np.asarray(jm["symbol_hist"]))
    for key in ("sse_y", "sse_u", "sse_v", "entropy_bits_per_symbol"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-6)


def test_rd_sweep_runs_on_the_cpu():
    """The RD tool end to end at a small size: both tables, no device rates
    (a CPU run measures no device), a rising RD curve, a JSON line."""
    out = rd_sweep.run("cpu", rd_shape=(32, 64),
                       throughput_shape=(48, 96), qualities=(10, 50, 90))
    json.loads(json.dumps(out))
    assert out["device"] == "cpu" and "card" not in out
    for table in ("rd_points", "throughput_4k"):
        pts = out[table]["points"]
        assert [p["quality"] for p in pts] == [10, 50, 90]
        assert all(not any(k.endswith("_fps") for k in p) for p in pts)
        psnr = [p["psnr_y_db"] for p in pts]
        size = [p["compressed_bytes"] for p in pts]
        assert psnr == sorted(psnr) and size == sorted(size)
