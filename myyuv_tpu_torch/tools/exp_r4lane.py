"""Four lane operations on int32 rows (T3): the counterpart of
``tools/exp_r4lane.py``, which probed which lane-stride primitives Mosaic
compiles.

Run from the repository root::

    python3 -m myyuv_tpu_torch.tools.exp_r4lane [--device cuda|cpu]

``lane_probe(x, op)`` launches ``csrc/lane_probes.cu`` on a CUDA tensor and
runs ``lane_probe_plain`` on a CPU tensor. The ops (``OPS``), on x [R, C]
(C a multiple of 8):

* ``s1`` strided read, ``x[:, 0::2] + x[:, 1::2]`` (the tool's
  ``k_sliceread``);
* ``s2`` strided write: the two halves of each row interleaved
  (``k_slicewrite``);
* ``s3`` the pair sum through a [R, C / 2, 2] reshape (``k_reshape``), the
  same function as s1;
* ``s4`` ``x + roll(x, -1, 1)`` (``k_roll``; the tool's
  ``pltpu.roll(t, -1, 1)`` raises on current JAX, a roll's shift must be
  non-negative: this is what it means).

On the tool's input (``arange(R * C)`` as [512, 8192]) it checks each op
against its plain version; on a card it prints each op's time beside the
plain version's, the PyTorch call that computes it (the slicing sum, a
stack of the halves, the reshape's sum, ``torch.roll``) and its bound, each
call reading its input from device memory, not from the L2 (the input,
16.8 MB, would stay there between calls), with the card's name and power
limit, as one JSON line.
"""

from __future__ import annotations

import sys

import torch

from ..kernels import build
from . import common

I32 = torch.int32
R, C = 512, 8192
OPS = {"s1": 1, "s2": 2, "s3": 3, "s4": 4}


def lane_probe_plain(x: torch.Tensor, op: str) -> torch.Tensor:
    """The plain PyTorch version of T3's op ``op``."""
    r, c = x.shape
    if op == "s1":
        return x[:, 0::2] + x[:, 1::2]
    if op == "s2":
        out = torch.empty_like(x)
        out[:, 0::2] = x[:, :c // 2]
        out[:, 1::2] = x[:, c // 2:]
        return out
    if op == "s3":
        t = x.reshape(r, c // 2, 2)
        return t[:, :, 0] + t[:, :, 1]
    if op == "s4":
        return x + torch.cat([x[:, 1:], x[:, :1]], dim=1)
    raise ValueError(f"unknown lane op {op!r}")


def library_call(x: torch.Tensor, op: str) -> torch.Tensor:
    """One PyTorch call per op that computes the same function."""
    r, c = x.shape
    if op == "s1":
        return x[:, 0::2] + x[:, 1::2]
    if op == "s2":
        return torch.stack([x[:, :c // 2], x[:, c // 2:]], dim=2).view(r, c)
    if op == "s3":
        return x.view(r, c // 2, 2).sum(dim=2, dtype=I32)
    return x + torch.roll(x, -1, 1)


def lane_probe(x: torch.Tensor, op: str) -> torch.Tensor:
    """T3's op ``op`` (``OPS``) on x i32 [R, C], C a multiple of 8."""
    r, c = x.shape
    if op not in OPS:
        raise ValueError(f"unknown lane op {op!r}")
    build.check_tensors(x.device, ("x", x, (r, c), I32))
    if build.on_cpu(x.device, "lane_probes"):
        return lane_probe_plain(x, op)
    if c % 8:
        raise ValueError(f"lane ops take rows of a multiple of 8, not {c}")
    build.check_aligned("x", x)
    out = torch.empty((r, c // 2 if op in ("s1", "s3") else c), dtype=I32,
                      device=x.device)
    build.launch("lane_probes", x.device, x.data_ptr(), r, c, OPS[op],
                 out.data_ptr())
    return out


def tool_input(dev, shape=(R, C)) -> torch.Tensor:
    """The tool's input, ``arange(R * C)`` as [R, C] i32, on ``dev``."""
    r, c = shape
    return torch.arange(r * c, dtype=I32, device=dev).reshape(r, c)


def run(device="cuda", shape=(R, C)) -> dict:
    """The tool's checks on ``device``."""
    x = tool_input(torch.device(device), shape)
    pairs = {op: (lane_probe(x, op), lane_probe_plain(x, op)) for op in OPS}
    return {"tool": "exp_r4lane", "shape": list(shape),
            "exact": {op: bool(torch.equal(*pair))
                      for op, pair in pairs.items()},
            "max_abs_err": common.max_abs_err(pairs.values())}


def times(device="cuda") -> dict:
    """Each op's time on the card beside its plain version's, its PyTorch
    call and its bound (``common.times``: each call reads its input from
    device memory)."""
    x = tool_input(torch.device(device))
    return {op: common.times(
        lambda t, op=op: lane_probe(t, op),
        lambda t, op=op: lane_probe_plain(t, op),
        lambda t, op=op: library_call(t, op), args=[x],
        nbytes=4 * (x.numel() + (x.numel() // 2 if op in ("s1", "s3")
                                 else x.numel()))) for op in OPS}


def main(argv=None) -> int:
    out = common.run_tool(run, times, __doc__, argv)
    return 0 if all(out["exact"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
