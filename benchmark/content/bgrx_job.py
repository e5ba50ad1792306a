"""A job of BGRX frames as a capture device leaves them in device memory:
a camera panning over one dead-leaves scene (``dead_leaves``), with
``dead_leaves.pan_job``'s crops and fresh sensor noise in each frame, kept
as pixels rather than converted to planes."""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import dead_leaves


def pan_bgrx(n: int, h: int, w: int, p: Dict, gen: torch.Generator, dev,
             chunk: int = 4) -> torch.Tensor:
    """``n`` h x w frames of a pan over one scene larger than the frame by
    ``p["pan"]`` = [rows, columns]: frame t is the crop at column
    t * columns // n and at a row that swings once through the rows, as in
    ``dead_leaves.pan_job``. Returns uint8 BGRX [n, h, w, 4] on ``dev``;
    ``chunk`` frames get their noise at a time, which bounds the float
    buffers beside the job."""
    pad_y, pad_x = p["pan"]
    colour, _ = dead_leaves.scene(h + pad_y, w + pad_x, p, gen, dev)
    noise = dead_leaves.noise_level(p, gen, dev)
    job = torch.empty((n, h, w, 4), dtype=torch.uint8, device=dev)
    for s in range(0, n, chunk):
        crops = []
        for t in range(s, min(n, s + chunk)):
            ox = t * pad_x // n
            oy = round(pad_y / 2 * (1 - math.cos(2 * math.pi * t / n)))
            oy = min(oy, pad_y)
            crops.append(colour[oy:oy + h, ox:ox + w])
        job[s:s + len(crops)] = dead_leaves.to_bgrx(torch.stack(crops),
                                                    noise, gen)
    return job
