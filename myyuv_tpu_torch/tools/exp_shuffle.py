"""The lane bit-permutation of int32 rows (T1) and the packed-8 pixel-word
relayout built on it: the counterpart of ``tools/exp_shuffle.py``.

Run from the repository root::

    python3 -m myyuv_tpu_torch.tools.exp_shuffle [--device cuda|cpu]

``lane_shuffle`` launches ``csrc/lane_shuffle.cu`` on a CUDA tensor (the
port of the JAX tool's ``make_shuffle_kernel``, a gather by computed index
instead of roll-and-select stages) and runs ``lane_shuffle_plain`` on a CPU
tensor. ``pack_plane_fast`` / ``unpack_plane_fast`` are the JAX tool's
relayouts of a luma-geometry plane ([H, W] u8, (W / 8) % 8 == 0) to the JAX
package's [128, N / 8] i32 quad words and back
(``myyuv_tpu/kernels/pallas_dct8.py::pack_pixel_words``): PyTorch reshapes
around the kernel. The port itself has no word layout; the relayout is kept
as the probe's workload.

The tool checks, on a uniform random 3008x4032 plane (seed 0), that the
packed words equal the plain version's and that unpacking gives the plane
back; on a card it then prints the times of pack, unpack and the kernel
alone beside the plain version, the PyTorch gather ``x[:, src]`` and the
kernel's bound (each call reading its inputs from device memory), with the
card's name and power limit, as one JSON line.
The JAX tool's TPU times are not the port's.
"""

from __future__ import annotations

import sys
from typing import Sequence, Tuple

import numpy as np
import torch

from ..kernels import build, probe
from . import common

I32 = torch.int32
SHAPE = (3008, 4032)


def bitperm_swaps(perm: Sequence[int]):
    """perm[i] = source bit feeding target bit i -> position swaps (p, q)
    whose left-to-right composition realises the permutation on lane
    indices (the JAX kernel's stages)."""
    cur = list(range(len(perm)))
    ops = []
    for tgt, want in enumerate(perm):
        pos = cur.index(want)
        if pos != tgt:
            ops.append((min(pos, tgt), max(pos, tgt)))
            cur[pos], cur[tgt] = cur[tgt], cur[pos]
    return ops


def pack_perm(nbits: int) -> Tuple[int, ...]:
    """Pack: l = 16 g' + 2 s + wj -> l_out = (wj << (G + 3)) | (s << G) | g'
    (G = nbits - 4). perm[i] = source bit of target bit i."""
    return tuple([4 + i for i in range(nbits - 4)] + [1, 2, 3] + [0])


def unpack_perm(nbits: int) -> Tuple[int, ...]:
    """The inverse of ``pack_perm(nbits)``."""
    inv = [0] * nbits
    for i, s in enumerate(pack_perm(nbits)):
        inv[s] = i
    return tuple(inv)


def _nbits(p: int, perm: Sequence[int]) -> int:
    nbits = p.bit_length() - 1
    if p != 1 << nbits or sorted(perm) != list(range(nbits)):
        raise ValueError(f"perm {tuple(perm)} is no bit permutation of "
                         f"{p} lanes")
    return nbits


def source_lanes(perm: Sequence[int], device) -> torch.Tensor:
    """i64 [2^len(perm)]: the input lane of each output lane (bit perm[i] of
    it is bit i of the output lane)."""
    j = torch.arange(1 << len(perm), device=device)
    src = torch.zeros_like(j)
    for i, s in enumerate(perm):
        src |= ((j >> i) & 1) << s
    return src


def lane_shuffle_plain(x: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version of T1: out[..., l_out] = x[..., l], as the
    JAX tool's numpy oracle ``apply_perm_np`` writes it."""
    l = torch.arange(x.shape[-1], device=x.device)
    l_out = torch.zeros_like(l)
    for i, s in enumerate(perm):
        l_out |= ((l >> s) & 1) << i
    out = torch.empty_like(x)
    out[..., l_out] = x
    return out


def lane_shuffle(x: torch.Tensor, perm: Sequence[int]) -> torch.Tensor:
    """[R, P] i32 (P = 2^len(perm), 4 <= P <= 8192) -> [R, P] with each
    row's lanes bit-permuted: out[r, l_out] = x[r, l], bit i of l_out equal
    to bit perm[i] of l."""
    r, p = x.shape
    nbits = _nbits(p, perm)
    build.check_tensors(x.device, ("x", x, (r, p), I32))
    if build.on_cpu(x.device, "lane_shuffle"):
        return lane_shuffle_plain(x, perm)
    if not 2 <= nbits <= 13:
        raise ValueError(f"lane_shuffle takes 4 to 8192 lanes, not {p}")
    build.check_aligned("x", x)
    out = torch.empty_like(x)
    code = sum(s << (4 * i) for i, s in enumerate(perm))
    build.launch("lane_shuffle", x.device, x.data_ptr(), r, nbits, code,
                 out.data_ptr())
    return out


def _geometry(w: int):
    wd = w // 4
    p = 1 << (wd - 1).bit_length()
    return wd, p, p.bit_length() - 1, 1 << (p.bit_length() - 5)


def pack_plane_fast(plane: torch.Tensor) -> torch.Tensor:
    """[H, W] u8 plane -> [128, N / 8] i32 quad words, luma geometry
    ((W / 8) % 8 == 0)."""
    h, w = plane.shape
    wd, p, nbits, ng = _geometry(w)
    v = plane.contiguous().view(I32)
    if p != wd:
        v = torch.nn.functional.pad(v, (0, p - wd))
    y = lane_shuffle(v, pack_perm(nbits))
    t = y.reshape(h // 8, 8, 2, 8, ng)[..., :wd // 16]
    return t.permute(1, 2, 3, 0, 4).reshape(128, -1)


def unpack_plane_fast(xw: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """[128, N / 8] i32 quad words -> [ph, pw] u8 plane (luma geometry)."""
    wd, p, nbits, ng = _geometry(pw)
    t = xw.reshape(8, 2, 8, ph // 8, wd // 16).permute(3, 0, 1, 2, 4)
    if ng != wd // 16:
        t = torch.nn.functional.pad(t, (0, ng - wd // 16))
    y = lane_shuffle(t.reshape(ph, p), unpack_perm(nbits))[:, :wd]
    return y.contiguous().view(torch.uint8).reshape(ph, pw)


def plane(dev, shape=SHAPE) -> torch.Tensor:
    """The tool's uniform random u8 plane (seed 0) on ``dev``."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(dev)


def padded_words(px: torch.Tensor):
    """A plane's rows as i32 words padded to a power of two, and the pack
    permutation of that width: the lane shuffle of ``pack_plane_fast``."""
    wd, p, nbits, _ = _geometry(px.shape[1])
    return (torch.nn.functional.pad(px.view(I32), (0, p - wd)),
            pack_perm(nbits))


def run(device="cuda", shape=SHAPE) -> dict:
    """Pack and unpack the tool's plane on ``device``: the lane shuffle of
    the pack against the plain version, the unpacked plane against the
    plane."""
    px = plane(torch.device(device), shape)
    h, w = shape
    v, perm = padded_words(px)
    got, want = lane_shuffle(v, perm), lane_shuffle_plain(v, perm)
    return {"tool": "exp_shuffle", "shape": [h, w],
            "pack_exact": bool(torch.equal(got, want)),
            "unpack_exact": bool(torch.equal(
                unpack_plane_fast(pack_plane_fast(px), h, w), px)),
            "max_abs_err": common.max_abs_err([(got, want)])}


def times(device="cuda") -> dict:
    """pack and unpack, and the lane shuffle alone beside its plain
    version, the gather ``x[:, src]`` and its bound, on the card, each
    call on inputs in device memory (``common.cold``)."""
    px = plane(torch.device(device))
    h, w = px.shape
    words = pack_plane_fast(px)
    v, perm = padded_words(px)
    src = source_lanes(perm, px.device)
    return {"pack_ms": probe.cuda_ms(common.cold(pack_plane_fast, [px])),
            "unpack_ms": probe.cuda_ms(common.cold(
                lambda x: unpack_plane_fast(x, h, w), [words])),
            "lane_shuffle": common.times(
                lambda x: lane_shuffle(x, perm),
                lambda x: lane_shuffle_plain(x, perm), lambda x: x[:, src],
                args=[v], nbytes=2 * v.numel() * 4)}


def main(argv=None) -> int:
    out = common.run_tool(run, times, __doc__, argv)
    return 0 if out["pack_exact"] and out["unpack_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
