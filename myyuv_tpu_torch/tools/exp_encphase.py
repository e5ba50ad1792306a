"""Phase split of K1 on the card: the counterpart of ``tools/exp_encphase.py``.

Run from the repository root on a machine with a CUDA card::

    python3 -m myyuv_tpu_torch.tools.exp_encphase [--device cuda|cpu]
        [--quality Q]

K1's encoder is timed stage by stage by ablation, as the JAX tool does: K1's
measurement instances (``csrc/dct_encode_phases.cu`` through
``encode.dct_encode_phase``) each leave one stage of the encoder out and
keep every loop bound and tensor shape, so K1's time less an instance's time
is that stage's time. On ``exp_r3stage.frames``' two 4032x3008 frames
(``cli``, smooth, and ``noise``) at quality Q (default 50) it times, with
``probe.cuda_ms`` on inputs in device memory (``common.cold``): ``full``
(K1), each instance, and ``dct`` (K3 alone); and prints, in ms, what the JAX
tool prints: each stage's delta, full - instance; ``front+DCT``, the
``frontonly`` instance's own time; ``dct alone`` and ``front`` = frontonly -
dct; and the residual, full - front+DCT - the deltas (what no instance
leaves out: the per-length table, the header, the zeroing and the lane's
store past the zero lane that ``frontonly`` stores). K3 writes its
coefficients to device memory, which K1 keeps in shared memory, so ``front``
is low by about that write.

The JAX tool's variants and the port's stages (``csrc/block_huffman.cuh``,
``EncodePhase``, names each stage and the stand-in it leaves in its place):

* ``frontonly`` (front: value sort, run scans, leaf-key sort): stages 1-2
  and stage 3's weight ranks, the port's two sorting networks (the
  message's value keys, then the symbols' weight keys) and the scans
  between them, as JAX sorts;
* ``merge``: ``huffman_tree``, the two-queue merge and the depth sweep;
* ``groups`` (the per-length code and group table): stage 5's first loop,
  the code of each symbol and the tree section, whose bits it writes
  itself: in the port the tree section is written where its groups are
  formed, so its writes count here and not under ``serial``;
* ``lut`` (each message position's code and length): the per-position
  lookups of the symbol index, length and code;
* ``serial`` (the serialization machine): the payload's bit writes, with
  its scan of the code lengths kept;
* ``cansort`` (the canonical bitonic sort): none. The port takes the
  canonical order from popcount ranks of per-length masks and runs no
  sort; the tool reports it as ``CANSORT``.

``front_widths``: for each frame, the share of K1's warps (4 blocks each)
whose front runs each network width, the least power of two >= the warp's
longest message (``value``) and >= its most symbols (``weight``), from
K3's coefficients on the host side of the kernel: the hot kernel counts
nothing.

Before timing, every instance is held to its plain version on both frames
(``encode.dct_encode_phase_plain``), and each output to what its stand-in
implies of K1's (``stand_in_holds``). On the CPU it runs the plain versions,
checks the stand-ins and times nothing. One JSON line, with the card's name
and power limit.
"""

from __future__ import annotations

import sys

import torch

from ..engine import device_stream
from ..engine.pipeline import codec_params
from ..entropy import decode, encode
from ..entropy.device import ZIGZAG
from ..kernels import probe, transform
from . import common
from .exp_r3stage import SHAPE, frames

# the networks' widths, and the blocks of a warp of K1 (8 lanes a block)
WIDTHS = (1, 2, 4, 8, 16, 32, 64)
WARP_BLOCKS = 4
CANSORT = ("n/a: the port has no canonical sort; it takes the canonical "
           "order from popcount ranks of per-length masks")
# f32 operations a block of K1's DCT: two 8-term chains and the quantize
DCT_FLOP = 2 * 64 * 15 + 64
_PAST_INT16 = 1 << 16


def message_stats(coeffs: torch.Tensor):
    """(msg_len, n_sym) i32 [N] of each block's zigzag message, trailing
    zeros trimmed (an all-zero block: one 0), from sorted messages."""
    m = coeffs.to(torch.int32)[:, torch.as_tensor(ZIGZAG,
                                                  device=coeffs.device)]
    pos = torch.arange(1, 65, device=m.device, dtype=torch.int32)
    mlen = torch.where(m != 0, pos, 0).amax(dim=1).clamp(min=1)
    s = torch.where(pos[None, :] <= mlen[:, None], m, _PAST_INT16).sort(
        dim=1).values
    runs = (s[:, 1:] != s[:, :-1]) & (s[:, 1:] < _PAST_INT16)
    return mlen.to(torch.int32), 1 + runs.sum(dim=1, dtype=torch.int32)


def front_widths(coeffs: torch.Tensor) -> dict:
    """{"value": {width: share}, "weight": {width: share}} of K1's warps on
    the coefficient rows ``coeffs`` (see the module docstring); a warp's
    groups past the last block code a one-symbol message."""
    mlen, n_sym = message_stats(coeffs)
    pad = -mlen.numel() % WARP_BLOCKS
    out = {}
    for name, per_block in (("value", mlen), ("weight", n_sym)):
        most = torch.nn.functional.pad(per_block, (0, pad), value=1).view(
            -1, WARP_BLOCKS).amax(dim=1)
        width = torch.full_like(most, WIDTHS[-1])
        for k in reversed(WIDTHS):
            width = torch.where(most <= k, k, width)
        out[name] = {str(k): float((width == k).sum()) / width.numel()
                     for k in WIDTHS}
    return out


def _decoded(lanes: torch.Tensor, sizes: torch.Tensor):
    """(coefficients, err) of the chunks in ``lanes`` (K6 on a card)."""
    stream = device_stream.compact_chunks(lanes, sizes)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    return decode.decode_blocks(stream, sizes, offsets)


def stand_in_holds(variant: str, got, full, coeffs: torch.Tensor) -> bool:
    """Whether an instance's (lanes, sizes, err) are what its stand-in
    makes of K1's ``full``: ``frontonly`` size n_sym and a zero lane;
    ``merge`` a stream that decodes to what K1's decodes to (a frame's
    coefficients: symbols are stored as 11 bits); ``groups`` K1's
    sizes and header and zeros after it; ``lut`` K1's tree section and
    size 3 + tree + ceil(msg_len / 8); ``serial`` K1's sizes and tree
    section and a zero payload."""
    if variant not in encode.PHASE_VARIANTS:
        raise ValueError(f"unknown encoder phase variant {variant!r}")
    lanes, sizes, err = got
    mlen, n_sym = message_stats(coeffs)
    tree = full[0][:, 2].to(torch.int32)
    col = torch.arange(lanes.shape[1], device=lanes.device)[None, :]
    in_tree = col < 3 + tree[:, None]
    ok = not err.any()
    if variant == "frontonly":
        return ok and torch.equal(sizes, n_sym) and not lanes.any()
    if variant == "merge":
        back, derr = _decoded(lanes, sizes)
        want, _ = _decoded(*full[:2])
        return ok and not derr.any() and torch.equal(back, want)
    if variant == "groups":
        return (ok and torch.equal(sizes, full[1])
                and torch.equal(lanes[:, :3], full[0][:, :3])
                and not lanes[:, 3:].any())
    if variant == "lut":
        return (ok and torch.equal(sizes, 3 + tree + (mlen + 7) // 8)
                and torch.equal(torch.where(in_tree, lanes, 0)[:, 3:],
                                torch.where(in_tree, full[0], 0)[:, 3:]))
    return (ok and torch.equal(sizes, full[1])  # serial
            and torch.equal(lanes, torch.where(in_tree, full[0], 0)))


def run(device="cuda", shape=SHAPE, quality=50) -> dict:
    """Every instance on both frames at ``quality`` on ``device``: against
    its plain version (on a card) and its stand-in; and the frames'
    ``front_widths``."""
    dev = torch.device(device)
    dct, qt = codec_params([quality] * 3, dev)
    out = {"tool": "exp_encphase", "shape": list(shape), "quality": quality,
           "cansort": CANSORT, "front_widths": {}}
    errs = []
    for name, planes in frames(dev, shape).items():
        full = encode.dct_encode_blocks(*planes, qt, dct)
        coeffs = transform.dct_quantize_blocks(*planes, qt, dct)
        res = {}
        for var in encode.PHASE_VARIANTS:
            got = encode.dct_encode_phase(*planes, qt, dct, var)
            # on the CPU the wrapper ran the plain version
            want = (encode.dct_encode_phase_plain(*planes, qt, dct, var)
                    if dev.type == "cuda" else got)
            res[var] = {"exact": all(torch.equal(a, b)
                                     for a, b in zip(got, want)),
                        "stand_in": stand_in_holds(var, got, full, coeffs)}
            errs.append(common.max_abs_err(zip(got, want)))
        out[name] = res
        out["front_widths"][name] = front_widths(coeffs)
    out["max_abs_err"] = max(errs)
    return out


def split(planes, qt: torch.Tensor, dct: torch.Tensor) -> dict:
    """One frame's phase split on the card, in ms (see the module
    docstring): K1, K3 and each instance on inputs in device memory, the
    instances beside their plain versions (host-inclusive) and bounds."""
    h, w = planes[0].shape
    n = transform.frame_blocks(h, w)
    args = [*planes, qt, dct]
    npx = h * w * 3 // 2
    tables = (qt.numel() + dct.numel()) * 4
    t = {"full": probe.cuda_ms(common.cold(encode.dct_encode_blocks, args)),
         "dct": probe.cuda_ms(common.cold(transform.dct_quantize_blocks,
                                          args)),
         "variants": {}}
    for var in encode.PHASE_VARIANTS:
        sizes = encode.dct_encode_phase(*args, var)[1]
        t["variants"][var] = common.times(
            lambda *a, var=var: encode.dct_encode_phase(*a, var),
            lambda *a, var=var: encode.dct_encode_phase_plain(*a, var),
            args=args, nbytes=npx + tables + int(sizes.sum()) + n * 8,
            ops=n * DCT_FLOP, plain_syncs=True)
    ms = {var: v["ms"] for var, v in t["variants"].items()}
    t["deltas"] = {var: t["full"] - ms[var]
                   for var in ("serial", "lut", "merge", "groups")}
    t["front_dct"] = ms["frontonly"]
    t["front"] = ms["frontonly"] - t["dct"]
    t["residual"] = t["full"] - ms["frontonly"] - sum(t["deltas"].values())
    return t


def times(device="cuda", quality=50) -> dict:
    """``split`` of both frames at ``quality`` on the card."""
    dev = torch.device(device)
    dct, qt = codec_params([quality] * 3, dev)
    return {name: split(planes, qt, dct)
            for name, planes in frames(dev).items()}


def report(card: str, t: dict, quality=50) -> list:
    """The JAX tool's lines (:129-142) for ``times``' result at
    ``quality``."""
    lines = []
    for frame, s in t.items():
        lines.append(f"[encphase] {card} | {frame} frame {SHAPE[1]}x"
                     f"{SHAPE[0]} q{quality}, probe.cuda_ms on inputs in "
                     f"device memory: full (K1) {s['full']:.4f} ms; "
                     + ", ".join(
                         f"{var} {v['ms']:.4f}"
                         for var, v in s["variants"].items()))
        lines.append("  phase deltas vs full: " + ", ".join(
            f"{var} {d:.4f}" for var, d in s["deltas"].items())
            + "; cansort n/a (no canonical sort in the port)")
        lines.append(f"  front+DCT : {s['front_dct']:.4f} ms (the frontonly "
                     f"variant's absolute time)")
        lines.append(f"  dct alone : {s['dct']:.4f} ms (K3); front = "
                     f"frontonly - dct = {s['front']:.4f} ms")
        lines.append(f"  residual  : {s['residual']:.4f} ms (full - "
                     f"front+DCT - the deltas)")
    return lines


def main(argv=None) -> int:
    out = common.run_tool(run, times, __doc__, argv, quality=50)
    if "times" in out:
        print("\n".join(report(out["card"], out["times"], out["quality"])))
    return 0 if all(r["exact"] and r["stand_in"]
                    for frame in ("cli", "noise")
                    for r in out[frame].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
