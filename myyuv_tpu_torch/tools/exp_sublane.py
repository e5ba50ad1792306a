"""The refill chain of a bit-window decoder on two layouts of per-block
state (T6): the counterpart of ``tools/exp_sublane.py``, which measured on
the TPU whether packing 8 blocks' state per lane column beats one block per
lane.

Run from the repository root::

    python3 -m myyuv_tpu_torch.tools.exp_sublane [--device cuda|cpu]

``consume_chain(words, rows)`` launches ``csrc/consume_chain.cu`` on a
CUDA tensor and runs ``consume_chain_plain`` on a CPU tensor: ``STEPS``
steps of the JAX tool's synthetic chain (a 64-bit window shifted by 0..7
bits a step, refilled from the block's table of ``CW`` words when 32 or
fewer valid bits are left) on each block, with the word table in one of the
tool's layouts:

* rows = 1: [CW, NB], word w of block c at [w, c], output [1, NB];
* rows = 8: [8 CW, NB / 8], word w of block (r, c) at [8 w + r, c], output
  [8, NB / 8].

The JAX tool's four runs (rows/tile 1/1024, 8/128, 8/512, 8/1024) differ in
layout and TPU tile; on the card the tile has no counterpart, so the tool
runs the two layouts at the JAX tool's NBLOCKS = 189,504 (about one 4K luma
plane), on one table (seed 0) held both ways (``to_rows8``: block (r, c) of
rows = 8 is block 8 c + r of rows = 1), checks each against its plain
version and the two against each other, and on a card prints each
layout's time beside the plain version's and its bound (the larger of the
chain's integer operations at the card's integer issue rate and the words
it reads and writes, both counted from this table's refills; no PyTorch
call computes it), each call reading its table from device memory, with
the card's name and power limit, as one JSON line.
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

from ..kernels import build
from . import common

I32 = torch.int32
STEPS = 64
CW = 16
NBLOCKS = 189504
# The integer operations the chain needs, not what its C++ spells out
# (the range checks of shifts by 32, the loop's own count): a step 6,
# s = (W0 >> 28) & 7 (2), the window shifted by s, a funnel shift and a
# shift (2), valid -= s and valid <= 32 (2); a refill 9, widx < CW and the
# word's address (2), the word shifted into both halves (v >> valid,
# 32 - valid, v << that: 3) and or-ed in (2), valid += 32 and widx += 1
# (2); a block 3, the ors of its output.
OPS_STEP, OPS_REFILL, OPS_BLOCK = 6, 9, 3


def _shl(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x << s, 0 for s < 0 or s >= 32 (the JAX tool's ``_shl``)."""
    return torch.where((s < 0) | (s >= 32), 0, x << s.clamp(0, 31))


def _shr_l(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The logical x >> s, 0 for s < 0 or s >= 32 (``_shr_l``)."""
    ux = x & 0x7FFFFFFF
    top = (x >> 31) & 1
    r = (ux >> s.clamp(0, 31)) | _shl(top, 31 - s)
    return torch.where((s < 0) | (s >= 32), 0, torch.where(s == 0, x, r))


def _chain_plain(words: torch.Tensor, rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output i32 [rows, ncols], refills i32 [rows, ncols])."""
    ncols = words.shape[1]
    w0 = words[:rows].clone()
    w1 = torch.zeros_like(w0)
    valid = torch.full_like(w0, 33)
    widx = torch.zeros_like(w0)
    tab = words.reshape(-1, rows, ncols)        # [CW, rows, ncols]
    cw = tab.shape[0]
    for _ in range(STEPS):
        s = (w0 >> 28) & 7
        w0 = _shl(w0, s) | _shr_l(w1, 32 - s)
        w1 = _shl(w1, s)
        valid = valid - s
        need = valid <= 32
        v = tab.gather(0, widx.clamp(max=cw - 1).long()[None])[0]
        v = torch.where(need & (widx < cw), v, 0)
        w0 = w0 | torch.where(need, _shr_l(v, valid), 0)
        w1 = w1 | torch.where(need, _shl(v, 32 - valid), 0)
        valid = valid + 32 * need.to(I32)
        widx = widx + need.to(I32)
    return w0 | w1 | valid | widx, widx


def consume_chain_plain(words: torch.Tensor, rows: int) -> torch.Tensor:
    """The plain PyTorch version of T6."""
    return _chain_plain(words, rows)[0]


def consume_chain(words: torch.Tensor, rows: int) -> torch.Tensor:
    """words i32 [rows * CW, ncols] in layout ``rows`` (1 or 8) -> the
    chain's output i32 [rows, ncols] (W0 | W1 | valid | widx a block)."""
    if rows not in (1, 8):
        raise ValueError(f"rows must be 1 or 8, not {rows}")
    ncols = words.shape[1] if words.dim() == 2 else -1
    build.check_tensors(words.device,
                        ("words", words, (rows * CW, ncols), I32))
    if build.on_cpu(words.device, "consume_chain"):
        return consume_chain_plain(words, rows)
    out = torch.empty((rows, ncols), dtype=I32, device=words.device)
    build.launch("consume_chain", words.device, words.data_ptr(), rows,
                 ncols, CW, STEPS, out.data_ptr())
    return out


def to_rows8(words: torch.Tensor) -> torch.Tensor:
    """A rows = 1 table [CW, NB] as rows = 8 [8 CW, NB / 8]: block (r, c)
    is block 8 c + r."""
    cw, nb = words.shape
    return words.reshape(cw, nb // 8, 8).transpose(1, 2).reshape(
        8 * cw, nb // 8).contiguous()


def rows8_order(out8: torch.Tensor) -> torch.Tensor:
    """A rows = 8 output [8, NB / 8] in rows = 1 block order [1, NB]."""
    return out8.t().reshape(1, -1)


def table(dev, nblocks: int = NBLOCKS) -> torch.Tensor:
    """The word table [CW, nblocks] (rows = 1 layout), seed 0, words in
    [0, 2^30) as the JAX tool draws them."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 1 << 30, (CW, nblocks),
                                         dtype=np.int32)).to(dev)


def run(device="cuda", nblocks: int = NBLOCKS) -> dict:
    """Both layouts of the tool's table on ``device``, each against its
    plain version and against each other."""
    w1 = table(torch.device(device), nblocks)
    w8 = to_rows8(w1)
    o1, o8 = consume_chain(w1, 1), consume_chain(w8, 8)
    pairs = [(o1, consume_chain_plain(w1, 1)),
             (o8, consume_chain_plain(w8, 8))]
    return {"tool": "exp_sublane", "nblocks": nblocks, "steps": STEPS,
            "cw": CW, "exact": all(torch.equal(*p) for p in pairs),
            "layouts_equal": bool(torch.equal(rows8_order(o8), o1)),
            "max_abs_err": common.max_abs_err(pairs)}


def times(device="cuda") -> dict:
    """Each layout's time on the card beside its plain version's
    (host-inclusive: it queues thousands of small launches) and its bound:
    the integer operations this table's chains need (``OPS_*``) at the
    card's integer issue rate, or the bytes of the words they read (word 0
    and one a refill, which rereads word 0 first) and of the output."""
    w1 = table(torch.device(device))
    refills = _chain_plain(w1, 1)[1]
    ops = ((OPS_STEP * STEPS + OPS_BLOCK) * NBLOCKS
           + OPS_REFILL * int(refills.sum()))
    nbytes = 4 * (int(refills.clamp(min=1).sum()) + NBLOCKS)
    return {f"rows{rows}": common.times(
        lambda w, rows=rows: consume_chain(w, rows),
        lambda w, rows=rows: consume_chain_plain(w, rows), args=[words],
        nbytes=nbytes, ops=ops, op_rate=common.INT_OP_PER_S,
        plain_syncs=True)
        for rows, words in ((1, w1), (8, to_rows8(w1)))}


def main(argv=None) -> int:
    out = common.run_tool(run, times, __doc__, argv)
    return 0 if out["exact"] and out["layouts_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
