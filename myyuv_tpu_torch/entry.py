"""The port's counterpart of the repository's ``__graft_entry__.entry``.

``entry(device)`` returns the flagship step, the batched transform round
trip with RD statistics (``engine/batch.py::roundtrip_step``: K3, K4 on a
CUDA device), and example arguments on ``device``: the same seed-0 numpy
draws as ``__graft_entry__._example_batch(2, 64, 128)`` and the three q50
tables. ``__graft_entry__.dryrun_multichip`` waits for the multi-device
port.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import batch
from .engine.pipeline import resolve_device


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
