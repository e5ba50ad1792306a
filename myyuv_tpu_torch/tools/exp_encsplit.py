"""Content split of the encoders on the card: the counterpart of
``tools/exp_encsplit.py``.

Run from the repository root on a machine with a CUDA card::

    python3 -m myyuv_tpu_torch.tools.exp_encsplit [--device cuda|cpu]

A flat 4032x3008 frame (every plane 128, the JAX tool's ``zero`` frame
``np.full_like(p, 128)``, :35) codes every block as an all-zero message of
one symbol, so every data-dependent loop of the encoder runs about once:
its time is the DCT, the fixed work of each stage and the lane's store.
Against it the tool times ``exp_r3stage.frames``' two q50 frames, ``cli``
(smooth) and ``noise``: for each frame, K1 (``encode.dct_encode_blocks``)
and K5 (``encode.encode_blocks`` on K3's coefficients) by ``probe.cuda_ms``
on inputs in device memory (``common.cold``), and the frame API's
``compress_frame`` and ``decompress_frame`` host-inclusive
(``probe.host_inclusive_ms``: they wait for the card), the JAX tool's two
lines; then K1(frame) - K1(flat) and K5(frame) - K5(flat), the
content-dependent part of each encoder.

Before timing it holds K1 to its plain version on the flat frame and
checks that every flat chunk is the one-symbol chunk (``FLAT_CHUNK``
bytes). On the CPU it runs that check on the plain version and times
nothing. One JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..engine import device_stream
from ..engine.pipeline import codec_params
from ..entropy import encode
from ..kernels import probe, transform
from . import common
from .exp_r3stage import SHAPE, frames

# a one-symbol chunk: the 3-byte header, one tree group of one 11-bit
# symbol (3 bytes) and a 1-bit payload (1 byte)
FLAT_CHUNK = 7


def flat_frame(dev, shape=SHAPE) -> list:
    """(y, u, v) planes of 128 on ``dev``."""
    h, w = shape
    return [torch.from_numpy(np.full(s, 128, np.uint8)).to(dev)
            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


def run(device="cuda", shape=SHAPE) -> dict:
    """K1 on the flat frame on ``device``: against its plain version (on a
    card), and every chunk the one-symbol chunk."""
    dev = torch.device(device)
    dct, qt = codec_params([50] * 3, dev)
    planes = flat_frame(dev, shape)
    got = encode.dct_encode_blocks(*planes, qt, dct)
    want = (encode.dct_encode_blocks_plain(*planes, qt, dct)
            if dev.type == "cuda" else got)
    return {"tool": "exp_encsplit", "shape": list(shape), "quality": 50,
            "exact": all(torch.equal(a, b) for a, b in zip(got, want)),
            "flat_one_symbol": bool((got[1] == FLAT_CHUNK).all())
            and not got[2].any(),
            "max_abs_err": common.max_abs_err(zip(got, want))}


def frame_times(planes, qt: torch.Tensor, dct: torch.Tensor) -> dict:
    """K1, K5 (on K3's coefficients) and the frame API on one frame, in
    ms."""
    h, w = planes[0].shape
    args = [*planes, qt, dct]
    coeffs = transform.dct_quantize_blocks(*args)
    sizes, stream = device_stream.compress_frame(*args)
    host_ms = probe.host_inclusive_ms
    return {
        "stream_bytes": int(stream.numel()),
        "K1": probe.cuda_ms(common.cold(encode.dct_encode_blocks, args)),
        "K5": probe.cuda_ms(common.cold(encode.encode_blocks, [coeffs])),
        "compress_frame_host_incl": host_ms(
            lambda: device_stream.compress_frame(*args)),
        "decompress_frame_host_incl": host_ms(
            lambda: device_stream.decompress_frame(stream, sizes, qt, dct,
                                                   h, w)),
    }


def times(device="cuda") -> dict:
    """``frame_times`` of the flat, CLI and noise frames on the card, and
    each encoder's content-dependent part, frame - flat."""
    dev = torch.device(device)
    dct, qt = codec_params([50] * 3, dev)
    t = {"flat": frame_times(flat_frame(dev), qt, dct)}
    for name, planes in frames(dev).items():
        t[name] = frame_times(planes, qt, dct)
        for k in ("K1", "K5"):
            t[name][f"{k}_content"] = t[name][k] - t["flat"][k]
    return t


def report(card: str, t: dict) -> list:
    """The JAX tool's two lines a frame, and the content-dependent part."""
    lines = []
    for frame, s in t.items():
        lines.append(
            f"[encsplit] {card} | {frame} frame {SHAPE[1]}x{SHAPE[0]} q50 "
            f"({s['stream_bytes']} stream bytes): compress_frame "
            f"{s['compress_frame_host_incl']:.4f} ms, decompress_frame "
            f"{s['decompress_frame_host_incl']:.4f} ms (host-inclusive); "
            f"K1 {s['K1']:.4f} ms, K5 {s['K5']:.4f} ms (probe.cuda_ms, "
            f"inputs in device memory)" + (
                f"; content-dependent: K1 - K1(flat) {s['K1_content']:.4f} "
                f"ms, K5 - K5(flat) {s['K5_content']:.4f} ms"
                if "K1_content" in s else ""))
    return lines


def main(argv=None) -> int:
    out = common.run_tool(run, times, __doc__, argv)
    if "times" in out:
        print("\n".join(report(out["card"], out["times"])))
    return 0 if out["exact"] and out["flat_one_symbol"] else 1


if __name__ == "__main__":
    sys.exit(main())
