"""The port's counterpart of the repository's ``__graft_entry__.entry``.

``entry(device)`` returns the flagship step, the batched transform round
trip with RD statistics (``engine/batch.py::roundtrip_step``: K3, K4 on a
CUDA device), and example arguments on ``device``: the same seed-0 numpy
draws as ``__graft_entry__._example_batch(2, 64, 128)`` and the three q50
tables.

``dryrun_multichip(n, device)`` is the counterpart of
``__graft_entry__.dryrun_multichip``: n shards over the visible devices of
that type, going round them again when there are fewer than n (one card
then stands for several shards), through the sharded round trip step and
the sharded frame codec, each held against the single-device path. The
JAX package's word-contract block is not ported (the word layout is not).
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import batch, device_stream, sharded_stream
from .engine.pipeline import codec_params, resolve_device
from .parallel import mesh as meshlib


def _example_batch(b: int, h: int, w: int, device) -> tuple:
    """Uniform random u8 planes ([b, h, w], 2x [b, h/2, w/2]) from seed 0,
    drawn in the order ``__graft_entry__._example_batch`` draws them."""
    rng = np.random.default_rng(0)
    shapes = ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2))
    return tuple(torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
                 .to(device) for s in shapes)


def entry(device="cuda"):
    """(step, example_args): ``step(*example_args)`` is one
    ``batch.roundtrip_step`` of a 2 x 64x128 batch at q50 on ``device``."""
    dev = resolve_device(device)
    qt_y, qt_u, qt_v = batch.plane_qtables([50, 50, 50], dev)
    return batch.roundtrip_step, (*_example_batch(2, 64, 128, dev),
                                  qt_y, qt_u, qt_v)


def _check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _mesh_shape(n: int) -> tuple:
    """(data, block) with data * block = n, as square as possible, data the
    larger (the JAX dry run's factorisation)."""
    for cand in range(int(n ** 0.5), 0, -1):
        if n % cand == 0:
            return n // cand, cand
    raise ValueError(f"no mesh of {n} devices")


def _frame_check(mesh, planes, q: int, dev) -> int:
    """Sharded compress and decompress of one frame at quality q against
    the single-device frame API on ``dev``; returns its largest chunk."""
    dct, qt = codec_params([q] * 3, dev)
    qts = list(qt.cpu().numpy())
    h, w = planes[0].shape
    got = sharded_stream.compress_frame_sharded(mesh, planes, qts)
    want = device_stream.compress_frame_to_streams(planes, qt, dct)
    for p, ((gs, gc), (ws, wc)) in enumerate(zip(got, want)):
        _check(np.array_equal(gs, ws) and np.array_equal(gc, wc),
               f"q{q} plane {p}: sharded stream differs")
    rec = sharded_stream.decompress_frame_sharded(mesh, got, qts, h, w)
    ref = device_stream.decompress_streams_to_frame(want, qt, dct, h, w)
    for p, (g, r) in enumerate(zip(rec, ref)):
        _check(np.array_equal(g, r), f"q{q} plane {p}: sharded decode "
               "differs")
    return max(int(s.max()) for s, _ in want)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the multi-device path once over n shards of ``device``'s type
    ("cuda": the visible cards, repeated round to n; "cpu": the CPU n
    times), each part held against the single-device path on the first
    device; raise RuntimeError on any difference. Returns what it ran.

    1. one ``make_sharded_roundtrip`` step on the (d, n / d) mesh, 2 d
       frames of 16 (n / d) x 32 (seed-0 noise, q50): planes and histogram
       equal ``roundtrip_step``'s, SSE to float32 rounding (rtol 1e-6);
    2. a smooth 16 n x 32 frame at q50 through ``compress_frame_sharded``
       and ``decompress_frame_sharded``: streams and planes equal the
       single-device frame API's;
    3. a noise frame of that size at q95, whose chunks exceed 64 bytes,
       the same way.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    devices = [cards[i % len(cards)] for i in range(n_devices)]
    d, blk = _mesh_shape(n_devices)
    mesh = meshlib.make_mesh((d, blk), devices)
    first = devices[0]

    y, u, v = _example_batch(2 * d, 16 * blk, 32, first)
    qts = batch.plane_qtables([50, 50, 50], first)
    (ry, ru, rv), m = batch.make_sharded_roundtrip(mesh)(y, u, v, *qts)
    (wy, wu, wv), wm = batch.roundtrip_step(y, u, v, *qts)
    for g, r in ((ry, wy), (ru, wu), (rv, wv)):
        _check(torch.equal(g, r), "sharded round trip planes differ")
    _check(torch.equal(m["symbol_hist"], wm["symbol_hist"]),
           "sharded histogram differs")
    _check(int(m["symbol_hist"].sum()) == y.numel() + u.numel() + v.numel(),
           "histogram does not count every coefficient once")
    for k in ("sse_y", "sse_u", "sse_v"):
        _check(torch.isclose(m[k], wm[k], rtol=1e-6, atol=0).item(),
               f"{k} {float(m[k])} != {float(wm[k])}")

    fh, fw = 16 * n_devices, 32
    yy, xx = np.mgrid[0:fh, 0:fw]
    yc, xc = np.mgrid[0:fh // 2, 0:fw // 2]
    smooth = [(128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)),
              (128 + 40 * np.sin(xc / 5.0)), (128 + 40 * np.cos(yc / 6.0))]
    _frame_check(mesh, [p.astype(np.uint8) for p in smooth], 50, first)
    rng = np.random.default_rng(5)
    noise = [rng.integers(0, 256, s).astype(np.uint8)
             for s in ((fh, fw), (fh // 2, fw // 2), (fh // 2, fw // 2))]
    biggest = _frame_check(mesh, noise, 95, first)
    _check(biggest > 64, "the q95 noise frame's chunks stay under 64 bytes")
    return {"mesh": (d, blk), "devices": [str(x) for x in devices],
            "step_planes": tuple(y.shape), "frame": (fh, fw),
            "q95_largest_chunk": biggest}
