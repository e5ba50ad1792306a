"""The (data, block) device mesh of the sharded codec.

Port of ``myyuv_tpu/parallel/mesh.py::make_mesh`` (:25-39). Frames batch
over the ``data`` axis, and the block rows of a frame's planes shard over
the ``block`` axis (``engine/sharded_stream.py`` shards them over the whole
mesh, ``engine/batch.py::make_sharded_roundtrip`` over ``block``). PyTorch
runs eagerly, so the mesh is only a grid of ``torch.device``s that the
sharded entry points walk; the JAX package's ``NamedSharding`` /
``PartitionSpec`` helpers have no counterpart.

A device may appear more than once: one card then stands for several
shards, as the JAX package's tests let 8 virtual CPU devices stand for 8
chips.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
BLOCK_AXIS = "block"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` is the device of data row i, block column j."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: ClassVar[Tuple[str, str]] = (DATA_AXIS, BLOCK_AXIS)

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        """The devices in row-major order (data, then block): shard d of
        the flattened mesh lies on ``flat[d]``."""
        return tuple(d for row in self.devices for d in row)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, block) mesh over ``devices`` (``torch.device``s or
    their names), by default every visible CUDA device.

    Default shape: all devices on the data axis, block axis size 1. Raises
    RuntimeError when no devices are given and there is no CUDA device (no
    CPU mesh is built unasked), ValueError when the shape does not hold
    the devices.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "for a mesh of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices), 1)
    rows, cols = shape
    if rows <= 0 or cols <= 0 or rows * cols != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(devices)} "
                         "devices")
    return Mesh(tuple(tuple(devices[r * cols:(r + 1) * cols])
                      for r in range(rows)))
