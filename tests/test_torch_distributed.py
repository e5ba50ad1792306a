"""The port's ``parallel/distributed.py`` against the JAX package's: the
single-process no-ops, and real gloo process groups whose workers import
only the port (the counterparts of tests/test_distributed_multiprocess.py):
two processes gathering one plane's streams, four processes with an empty
tail process, and two processes running ``compress_batch_sharded``. Each
result is held to the JAX package's host coder on the test's side.

Tolerance: byte equality (sizes, contents, offsets); every worker has a
timeout of 120 s, and any worker that fails fails the test."""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from myyuv_tpu import entropy
from myyuv_tpu.kernels import scalar
from myyuv_tpu.parallel import distributed as jdist
from myyuv_tpu_torch.parallel import distributed as tdist
from myyuv_tpu_torch.parallel import mesh as meshlib

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120

_WORKER = r"""
import hashlib, json, sys
import numpy as np
import torch
from myyuv_tpu_torch.parallel import distributed as dist

port, rank, world, case = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
dist.initialize(f"localhost:{port}", num_processes=world, process_id=rank)
try:
    assert dist.process_info() == (rank, world), dist.process_info()
    from myyuv_tpu_torch.engine import device_stream as ds
    from myyuv_tpu_torch.engine import sharded_stream as ss
    from myyuv_tpu_torch.entropy import device as edev
    from myyuv_tpu_torch.kernels import constants
    from myyuv_tpu_torch.kernels import device as kdev
    from myyuv_tpu_torch.parallel import mesh as meshlib
    qts = [constants.quality_scaled_qtable(constants.PLANE_Q50[i], 50)
           for i in range(3)]
    out = {"pid": rank}
    if case == "batch":
        h, w, b = 32, 64, 4
        yy, xx = np.mgrid[0:h, 0:w]
        base = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(
            np.uint8)
        ys = np.stack([base + f for f in range(b)]).astype(np.uint8)
        us = np.stack([base[:h // 2, :w // 2] + f
                       for f in range(b)]).astype(np.uint8)
        vs = np.stack([base[h // 2:, :w // 2] + f
                       for f in range(b)]).astype(np.uint8)
        mesh = meshlib.make_mesh((2, 1), ["cpu", "cpu"])
        frames = ss.compress_batch_sharded(mesh, (ys, us, vs), qts)
        blob = b"".join(bytes(c) + bytes(s) for streams in frames
                        for s, c in streams)
        out.update(n_frames=len(frames), local=list(dist.local_shard(b)),
                   sha=hashlib.sha256(blob).hexdigest())
    else:
        h, w, fx, fy = (32, 64, 9.0, 7.0) if case == "gather" else \
            (24, 24, 3.1, 2.3)
        yy, xx = np.mgrid[0:h, 0:w]
        plane = (128 + 60 * np.sin(xx / fx) * np.cos(yy / fy)).astype(
            np.uint8)
        coeffs = kdev.dct_quantize(
            kdev.plane_to_blocks(torch.from_numpy(plane)),
            torch.from_numpy(qts[0])).reshape(-1, 64)
        lo, hi = dist.local_shard(coeffs.shape[0])
        if hi > lo:
            lanes, sizes, _ = edev.encode_lanes(coeffs[lo:hi])
            content = ds.compact_chunks(lanes, sizes).numpy()
            sizes = sizes.numpy().astype(np.uint8)
        else:
            sizes = np.zeros(0, np.uint8)
            content = np.zeros(0, np.uint8)
        all_sizes = dist.allgather_sizes(sizes)
        gsizes, gcontent = dist.gather_streams(sizes, content)
        out.update(local_n=hi - lo, n_hosts=len(all_sizes),
                   offsets=[int(o) for o in dist.global_offsets(all_sizes)],
                   sizes_dtype=str(gsizes.dtype),
                   sizes=[int(s) for s in gsizes],
                   sha=hashlib.sha256(gcontent.tobytes()).hexdigest())
finally:
    dist.shutdown()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "myyuv_tpu")]
assert not bad, bad
print(json.dumps(out), flush=True)
"""


def _run_workers(tmp_path, world: int, case: str):
    """Run ``world`` gloo workers of ``case``; their JSON results by rank.
    Any worker that fails or outlives TIMEOUT fails the test."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:" + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(port), str(i), str(world), case],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for i in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    except subprocess.TimeoutExpired:
        pytest.fail(f"gloo worker of {case!r} timed out")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return outs


def _jax_plane_stream(h, w, fx, fy):
    yy, xx = np.mgrid[0:h, 0:w]
    plane = (128 + 60 * np.sin(xx / fx) * np.cos(yy / fy)).astype(np.uint8)
    qt = scalar.plane_qtable(0, 50)
    coeffs = scalar.dct_quantize_blocks(
        scalar.plane_to_blocks(plane), qt).reshape(-1, 64)
    return entropy.encode_blocks(coeffs)


def test_single_process_noops_match_jax():
    tdist.initialize(None, None, None)
    tdist.initialize("localhost:1", 1, 0)
    assert tdist.process_info() == (0, 1) == jdist.process_info()
    for n in (0, 1, 7, 8):
        assert tdist.local_shard(n) == jdist.local_shard(n) == (0, n)
    s = np.array([3, 5, 7], np.uint8)
    c = np.arange(15, dtype=np.uint8)
    (got,) = tdist.allgather_sizes(s)
    assert got is s or np.array_equal(got, s)
    gs, gc = tdist.gather_streams(s, c)
    assert np.array_equal(gs, s) and np.array_equal(gc, c)
    t = torch.arange(4)
    assert torch.equal(tdist.allreduce_sum(t), t)


@pytest.mark.parametrize("sizes", [
    [np.array([1, 2, 3], np.uint8), np.array([4], np.uint8)],
    [np.array([255, 3], np.uint8), np.zeros(0, np.uint8),
     np.array([7, 7, 7], np.uint8)],
    [np.zeros(0, np.uint8)],
])
def test_global_offsets_match_jax(sizes):
    np.testing.assert_array_equal(tdist.global_offsets(sizes),
                                  jdist.global_offsets(sizes))


def test_shard_batch_splits_over_data_rows():
    mesh = meshlib.make_mesh((2, 2), ["cpu"] * 4)
    batch = np.arange(4 * 3 * 2, dtype=np.uint8).reshape(4, 3, 2)
    parts = tdist.shard_batch(batch, mesh)
    assert len(parts) == 2
    np.testing.assert_array_equal(torch.cat(parts).numpy(), batch)
    assert all(p.device == torch.device("cpu") for p in parts)
    with pytest.raises(ValueError):
        tdist.shard_batch(batch[:3], mesh)


def test_two_process_gather_streams(tmp_path):
    outs = _run_workers(tmp_path, 2, "gather")
    want_sizes, want_content = _jax_plane_stream(32, 64, 9.0, 7.0)
    assert [o["pid"] for o in outs] == [0, 1]
    assert all(o["n_hosts"] == 2 for o in outs)
    assert outs[0]["offsets"] == outs[1]["offsets"]
    half = int(want_sizes[:16].astype(np.int64).sum())
    assert outs[0]["offsets"] == [0, half]
    want_sha = hashlib.sha256(want_content.tobytes()).hexdigest()
    for o in outs:
        assert o["sizes"] == [int(s) for s in want_sizes]
        assert o["sizes_dtype"] == "uint8"
        assert o["sha"] == want_sha


def test_four_process_empty_tail(tmp_path):
    """9 blocks over 4 processes: shares 3/3/3/0. The empty tail process
    still takes part in every all-gather (padded to one element, int64
    sizes), and every process assembles the single-process stream."""
    outs = _run_workers(tmp_path, 4, "empty")
    want_sizes, want_content = _jax_plane_stream(24, 24, 3.1, 2.3)
    assert [o["local_n"] for o in outs] == [3, 3, 3, 0]
    per = [int(want_sizes[i:i + 3].astype(np.int64).sum())
           for i in (0, 3, 6)]
    want_sha = hashlib.sha256(want_content.tobytes()).hexdigest()
    for o in outs:
        assert o["n_hosts"] == 4
        assert o["offsets"] == [0, per[0], per[0] + per[1], sum(per)]
        assert o["sizes"] == [int(s) for s in want_sizes]
        assert o["sha"] == want_sha


def test_two_process_sharded_batch(tmp_path):
    """Frames split over two processes, block rows over each one's local
    mesh: both assemble every frame's streams, equal to the JAX package's
    host coder frame by frame."""
    outs = _run_workers(tmp_path, 2, "batch")
    assert [o["local"] for o in outs] == [[0, 2], [2, 4]]
    assert all(o["n_frames"] == 4 for o in outs)
    h, w, b = 32, 64, 4
    yy, xx = np.mgrid[0:h, 0:w]
    base = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
    ys = np.stack([base + f for f in range(b)]).astype(np.uint8)
    us = np.stack([base[:h // 2, :w // 2] + f
                   for f in range(b)]).astype(np.uint8)
    vs = np.stack([base[h // 2:, :w // 2] + f
                   for f in range(b)]).astype(np.uint8)
    qts = [np.asarray(scalar.plane_qtable(i, 50), np.float32)
           for i in range(3)]
    blob = b""
    for f in range(b):
        for p, plane in enumerate((ys[f], us[f], vs[f])):
            co = scalar.dct_quantize_blocks(scalar.plane_to_blocks(plane),
                                            qts[p])
            sizes, content = entropy.encode_blocks(
                co.reshape(-1, 64).astype(np.int16))
            blob += bytes(content) + bytes(sizes.astype(np.uint8))
    want = hashlib.sha256(blob).hexdigest()
    assert outs[0]["sha"] == outs[1]["sha"] == want
