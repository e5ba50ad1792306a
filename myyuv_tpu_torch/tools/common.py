"""What the probe tools share: the H100's peak rates, the least time a call
could take, the card's name and power limit, the ``--device`` argument and
the timing of a kernel beside its plain version and a PyTorch call.

Peak rates of one NVIDIA H100 SXM at its 700 W limit: device memory 3.35
TB/s and float32 outside the tensor cores 67 TFLOP/s (NVIDIA's data
sheet); 32-bit integer operations 33.4e12 a second, the most the SMs
issue (the Hopper architecture white paper: each of an SM's four
partitions issues one warp instruction a clock, to its INT32 lanes or, as
IMAD, to its FMA lanes; 132 SMs at the 1.98 GHz boost clock). Its L2 holds
50 MB.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import subprocess
from typing import Callable, Optional, Sequence

import torch

from ..engine.pipeline import resolve_device
from ..kernels import probe

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT_OP_PER_S = 128 * 132 * 1.98e9
L2_BYTES = 50e6


def bound_ms(nbytes: float, ops: float = 0,
             op_rate: float = F32_FLOP_PER_S):
    """(least time in ms, "bytes" or "operations") on an H100 SXM: the
    larger of the bytes over the memory rate and the operations over
    ``op_rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def device_from_args(doc: str, argv: Optional[Sequence[str]]
                     ) -> torch.device:
    """The ``--device cuda|cpu`` argument (default cuda) of a tool whose
    module docstring is ``doc``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return resolve_device(ap.parse_args(argv).device)


def run_tool(run: Callable, times: Callable, doc: str,
             argv: Optional[Sequence[str]]) -> dict:
    """A tool's ``main``: ``run(device)`` on the ``--device`` of ``argv``
    and, on a card, the card's name and power limit and ``times(device)``;
    prints the result as one JSON line and returns it."""
    dev = device_from_args(doc, argv)
    out = run(dev)
    if dev.type == "cuda":
        out["card"] = card()
        out["times"] = times(dev)
    print(json.dumps(out))
    return out


def max_abs_err(pairs) -> float:
    """The largest |got - want| over pairs of tensors of one shape (in
    float64; 0 for pairs of empty tensors)."""
    return max((float((g.double() - w.double()).abs().max())
                for g, w in pairs if g.numel()), default=0.0)


def cold(fn: Callable, args: Sequence[torch.Tensor]) -> Callable:
    """``fn(*args)`` as a call without arguments that finds its inputs in
    device memory, not in the L2: each call takes the next of n copies of
    ``args`` in turn, n such that the other copies exceed twice the L2
    (reading them evicts it), and its output is kept until that copy's
    next turn, so the outputs rotate over n buffers too."""
    size = sum(a.numel() * a.element_size() for a in args)
    n = int(2 * L2_BYTES // size) + 2
    turn = itertools.cycle([[a.clone() for a in args] for _ in range(n)])
    kept = collections.deque(maxlen=n - 1)

    def call():
        kept.append(fn(*next(turn)))
    return call


def times(kernel: Callable, plain: Callable,
          library: Optional[Callable] = None, args: Sequence = (),
          nbytes: float = 0, ops: float = 0,
          op_rate: float = F32_FLOP_PER_S, plain_syncs: bool = False
          ) -> dict:
    """``kernel(*args)``'s time beside ``plain(*args)``'s,
    ``library(*args)``'s (or None) and its bound, in ms on the card:
    ``probe.cuda_ms`` (calls queued behind a busy card, the host's work
    left out), and ``probe.host_inclusive_ms`` for a plain version that
    synchronises or queues more launches than the card's queue holds
    (``plain_syncs``). Each call finds its inputs in device memory
    (``cold``), as the bound by bytes assumes. Raises when the kernel beat
    its bound: such a reading is wrong."""
    b, by = bound_ms(nbytes, ops, op_rate)
    t = {"ms": probe.cuda_ms(cold(kernel, args)),
         "plain_ms": (probe.host_inclusive_ms if plain_syncs
                      else probe.cuda_ms)(cold(plain, args)),
         "plain_timer": "host-inclusive" if plain_syncs else "cuda_ms",
         "library_ms": (probe.cuda_ms(cold(library, args)) if library
                        else None),
         "bound_ms": b, "bound_by": by}
    if t["ms"] < b:
        raise RuntimeError(f"a kernel ran in {t['ms']} ms, under its bound "
                           f"of {b} ms: the reading is wrong")
    return t
