"""A cell's inputs, made on the device from the seed."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.content import dead_leaves
from benchmark.reference.convert import bgrx_to_iyuv


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def stills(config: Dict, n: int, seed: int, device: torch.device
           ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``n`` distinct stills of the configuration's size, as (y, u, v)
    uint8 planes on ``device``."""
    gen = generator(seed, device)
    h, w = config["height"], config["width"]
    return [bgrx_to_iyuv(dead_leaves.still(h, w, config["content"], gen,
                                           device)) for _ in range(n)]


def video(config: Dict, n: int, seed: int, device: torch.device):
    """A job of ``n`` panning frames: (Y [n, H, W], U, V [n, H/2, W/2])
    uint8 on ``device``."""
    gen = generator(seed, device)
    return dead_leaves.pan_job(n, config["height"], config["width"],
                               config["content"], gen, device, bgrx_to_iyuv)
