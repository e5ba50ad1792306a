"""Per-quality rate-distortion points and device throughput of the port: the
counterpart of ``tools/rd_device_sweep.py``.

Run from the repository root::

    python3 -m myyuv_tpu_torch.tools.rd_sweep [--device cuda|cpu]

Prints one JSON line with two tables of ``engine/sweep.py::quality_sweep``
at qualities 10, 30, 50, 70 and 90, the rate from K1's stream
(``entropy_backend="device"``):

* ``rd_points``: a 992x736 ``probe.smooth_picture`` converted to IYUV (X1
  on ``--device``), the RD curve. The JAX tool's source, the original
  992x736 picture of the reference image set, is not in the repository;
* ``throughput_4k``: the same kind of picture at 4032x3008, the frame of
  ``chip_smoke.py``'s CLI phase. On a CUDA card (``--device cuda``, the
  default) each point carries ``device_encode_fps`` and
  ``device_roundtrip_fps`` (``probe.cuda_ms``, host work left out) and
  ``device_decode_fps`` (``probe.host_inclusive_ms``, host work included),
  and the line the card's name and power limit. On the CPU the table has
  no rates: a CPU run measures no device.

It writes no file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Sequence, Tuple

import numpy as np
import torch

from myyuv_tpu_torch.engine import sweep
from myyuv_tpu_torch.engine.pipeline import resolve_device
from myyuv_tpu_torch.kernels import convert, probe

QUALITIES = (10, 30, 50, 70, 90)
RD_SHAPE = (736, 992)
THROUGHPUT_SHAPE = (3008, 4032)


def picture_planes(rng: np.random.Generator, shape: Tuple[int, int],
                   dev: torch.device):
    """(y, u, v) numpy planes of a ``probe.smooth_picture`` of ``shape``
    converted on ``dev``."""
    px = torch.from_numpy(probe.smooth_picture(rng, *shape)).to(dev)
    return [p.cpu().numpy() for p in convert.bgrx_to_iyuv(px)]


def run(device="cuda", rd_shape=RD_SHAPE,
        throughput_shape=THROUGHPUT_SHAPE,
        qualities: Sequence[int] = QUALITIES) -> dict:
    """The two tables (and, on a CUDA device, the card) as one dict."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    timed = dev.type == "cuda"
    out = {"metric": "rd_device_entropy", "device": (
        torch.cuda.get_device_name(dev) if timed else "cpu")}
    if timed:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    for table, shape, time_device, what in (
            ("rd_points", rd_shape, False, "smooth_picture"),
            ("throughput_4k", throughput_shape, timed,
             "smooth_picture (chip_smoke's CLI frame)")):
        h, w = shape
        out[table] = {
            "source": f"{w}x{h} probe.{what}, seed 0, IYUV by X1",
            "points": sweep.quality_sweep(
                picture_planes(rng, shape, dev), qualities,
                entropy_backend="device", time_device=time_device,
                device=dev)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
