"""The comparisons that decide ``correct``, and the seeded sample of
answers they are made on."""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``
    (reservoir sampling: the number of items need not be known ahead)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 0x5a3])
        self.items: List[Any] = []
        self.seen = 0

    def claim(self) -> Optional[int]:
        """Count one more item and draw, before it is made, whether the
        sample keeps it: the slot to ``put`` it in, or None. A caller keeps
        what an item needs for the check only when the item is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            return len(self.items)
        j = int(self.rng.integers(self.seen))
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item

    def offer(self, item) -> None:
        slot = self.claim()
        if slot is not None:
            self.put(slot, item)


def bytes_off(got: bytes, want: bytes) -> int:
    """Bytes in which ``got`` differs from ``want``; each byte by which the
    lengths differ counts as one."""
    a = np.frombuffer(got, np.uint8)
    b = np.frombuffer(want, np.uint8)
    n = min(a.size, b.size)
    return int((a[:n] != b[:n]).sum()) + abs(a.size - b.size)


def elements_off(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements in which ``got`` differs from ``want`` (flattened); each by
    which the sizes differ counts as one."""
    a = got.reshape(-1).to(want.device)
    b = want.reshape(-1)
    n = min(a.numel(), b.numel())
    diff = int((a[:n].to(torch.int64) != b[:n].to(torch.int64)).sum())
    return diff + abs(a.numel() - b.numel())
