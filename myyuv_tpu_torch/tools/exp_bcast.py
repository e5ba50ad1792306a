"""A per-row scale broadcast across float32 rows (T2), o = x * q[row]: the
counterpart of ``tools/exp_bcast.py``.

Run from the repository root::

    python3 -m myyuv_tpu_torch.tools.exp_bcast [--device cuda|cpu]

``bcast_mul`` launches ``csrc/bcast_mul.cu`` on CUDA tensors (the port of
the JAX tool's ``kern``, which probed whether Mosaic broadcasts a [8, 1]
column across an [8, TP] tile) and runs ``bcast_mul_plain`` on CPU
tensors. On the tool's inputs (x [64, 256] uniform in [0, 1) from seed 0,
q = 1..64 a row) it checks the result against the plain version and
against the float64 product rounded to float32 (a float32 product is
correctly rounded); on a card it prints the kernel's time beside the plain
version's, PyTorch's ``x * q`` and its bound, which is below a launch's
cost, with the card's name and power limit, as one JSON line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels import build
from . import common

F32 = torch.float32
TP = 256


def bcast_mul_plain(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of T2."""
    return x * q


def bcast_mul(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x f32 [R, C] (C a multiple of 4) times q f32 [R, 1], row by row."""
    r, c = x.shape
    build.check_tensors(x.device, ("x", x, (r, c), F32),
                        ("q", q, (r, 1), F32))
    if build.on_cpu(x.device, "bcast_mul"):
        return bcast_mul_plain(x, q)
    if c % 4:
        raise ValueError(f"bcast_mul takes rows of a multiple of 4, not {c}")
    build.check_aligned("x", x)
    out = torch.empty_like(x)
    build.launch("bcast_mul", x.device, x.data_ptr(), q.data_ptr(), r, c,
                 out.data_ptr())
    return out


def inputs(dev):
    """The JAX tool's x [64, 256] and q [64, 1] on ``dev``."""
    x = np.random.default_rng(0).random((64, TP), np.float32)
    q = np.arange(64, dtype=np.float32).reshape(64, 1) + 1
    return torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev)


def run(device="cuda") -> dict:
    """The tool's check on ``device``."""
    x, q = inputs(torch.device(device))
    got, plain = bcast_mul(x, q), bcast_mul_plain(x, q)
    want = (x.double() * q.double()).float()
    return {"tool": "exp_bcast", "shape": list(x.shape),
            "exact": bool(torch.equal(got.view(torch.int32),
                                      plain.view(torch.int32))
                          and torch.equal(got, want)),
            "max_abs_err": common.max_abs_err([(got, plain)])}


def times(device="cuda") -> dict:
    """The kernel's time on the card beside the plain version's, ``x * q``
    and its bound (``common.times``)."""
    x, q = inputs(torch.device(device))
    return {"bcast_mul": common.times(
        bcast_mul, bcast_mul_plain, torch.mul, args=[x, q],
        nbytes=2 * x.numel() * 4 + q.numel() * 4, ops=x.numel())}


def main(argv=None) -> int:
    out = common.run_tool(run, times, __doc__, argv)
    return 0 if out["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
