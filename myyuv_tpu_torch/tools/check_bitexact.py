"""Bit-exactness on the card: the port's kernels against their plain
versions, and the contraction sentinel T7, the counterpart of
``tools/check_tpu_bitexact.py``.

Run from the repository root::

    python3 -m myyuv_tpu_torch.tools.check_bitexact [--device cuda|cpu]

On the JAX tool's inputs (seed 7, drawn in its order) it holds:

* K3 (``transform.dct_quantize_blocks``) and K4
  (``transform.dequantize_idct_blocks``) on 4,096 random pixel blocks and
  4,096 random coefficient blocks in [-1024, 1024), at q 1, 10, 37, 50,
  60, 77, 90, 95, 100, each with the luma (plane 0) and the chroma (plane
  1) table: the blocks are the Y plane of a 256x1024 frame whose three
  tables are that plane's;
* X1 (``convert.bgrx_to_iyuv``) on a random 992x736 BGRX frame and X2
  (``convert.iyuv_to_bgrx``) on its planes;
* T7, ``dct_chain``: the 8-term float32 chain of DCT row 1 on [64, 1024]
  (``csrc/dct_chain.cu``, written with plain ``*`` and ``+``, so that only
  the build flag ``-fmad=false`` keeps it from contracting), against its
  plain version and the host's double-rounded numpy sequence, bit for
  bit;
* K3 on ``probe.contraction_probe_blocks()`` (the JAX tool's
  production-kernel probe, :105-181: blocks whose quantized coefficients
  change if the DCT chains are contracted), tiled to 1,024 blocks.

Each kernel is held against its plain PyTorch version (which the CPU tests
hold to the JAX package's scalar oracle). The JAX tool's golden-image part
(:44-60, the reference image set's chef frame) waits until that image set
is in the machine; it is not in the repository. On the CPU every wrapper
runs its plain version, so only the chain's check against the host means
something there. It prints one JSON line and exits 1 on any failure.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..engine.pipeline import codec_params
from ..kernels import build, convert, probe, transform
from ..kernels import device as kdev
from ..kernels.constants import DCT_MATRIX8
from . import common

F32 = torch.float32
QUALITIES = (1, 10, 37, 50, 60, 77, 90, 95, 100)
FRAME = (256, 1024)  # its Y plane holds the 4,096 blocks


def dct_chain_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of T7: each product and each sum its own
    float32 op, so each is rounded."""
    acc = c[0] * x[0:8]
    for k in range(1, 8):
        acc = acc + c[k] * x[8 * k:8 * k + 8]
    return acc


def dct_chain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x f32 [64, cols] (cols a multiple of 4), c f32 [8] -> f32 [8, cols]:
    acc = c[0] * x[0:8], then acc = acc + c[k] * x[8k:8k+8]."""
    cols = x.shape[1] if x.dim() == 2 else -1
    build.check_tensors(x.device, ("x", x, (64, cols), F32),
                        ("c", c, (8,), F32))
    if build.on_cpu(x.device, "dct_chain"):
        return dct_chain_plain(x, c)
    if cols % 4:
        raise ValueError(f"dct_chain takes a multiple of 4 columns, not "
                         f"{cols}")
    build.check_aligned("x", x)
    out = torch.empty((8, cols), dtype=F32, device=x.device)
    build.launch("dct_chain", x.device, x.data_ptr(), cols, c.data_ptr(),
                 out.data_ptr())
    return out


def host_chain(xs: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The host's double-rounded chain in numpy float32."""
    acc = c[0] * xs[0:8]
    for k in range(1, 8):
        acc = acc + c[k] * xs[8 * k:8 * k + 8]
    return acc


def _frame_of(blocks: torch.Tensor, rest: torch.Tensor, shape):
    """A frame whose Y plane holds ``blocks`` [n, 8, 8] in raster order and
    whose U, V planes are filled from ``rest``."""
    h, w = shape
    y = kdev.blocks_to_plane(blocks, h, w)
    u = rest[:h * w // 4].reshape(h // 2, w // 2)
    v = rest[h * w // 4:h * w // 2].reshape(h // 2, w // 2)
    return y, u.contiguous(), v.contiguous()


def inputs(dev):
    """The JAX tool's random inputs, drawn in its order (seed 7)."""
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 256, size=(4096, 8, 8), dtype=np.uint8)
    coeffs = rng.integers(-1024, 1024, size=(4096, 8, 8), dtype=np.int16)
    px = rng.integers(0, 256, size=(736, 992, 4), dtype=np.uint8)
    xs = rng.standard_normal((64, 1024)).astype(np.float32) * 128
    return {"blocks": torch.from_numpy(blocks).to(dev),
            "coeffs": torch.from_numpy(coeffs).to(dev),
            "px": torch.from_numpy(px).to(dev), "xs": xs}


def run(device="cuda") -> dict:
    dev = torch.device(device)
    inp = inputs(dev)
    h, w = FRAME
    fill = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, h * w // 2, np.uint8)).to(dev)
    frame = _frame_of(inp["blocks"], fill, FRAME)
    ncoef = transform.frame_blocks(h, w)
    coeffs = torch.cat([inp["coeffs"].reshape(-1, 64), torch.from_numpy(
        np.random.default_rng(9).integers(-1024, 1024, (ncoef - 4096, 64),
                                          dtype=np.int16)).to(dev)])
    failed = []
    for q in QUALITIES:
        dct, qts = codec_params([q] * 3, dev)
        for p in (0, 1):
            qt = qts[p].expand(3, 8, 8).contiguous()
            k3 = transform.dct_quantize_blocks(*frame, qt, dct)
            k4 = transform.dequantize_idct_blocks(coeffs, qt, dct, h, w)
            if not torch.equal(k3, transform.dct_quantize_blocks_plain(
                    *frame, qt, dct)):
                failed.append(f"K3 q{q} plane {p}")
            if not all(torch.equal(a, b) for a, b in zip(
                    k4, transform.dequantize_idct_blocks_plain(
                        coeffs, qt, dct, h, w))):
                failed.append(f"K4 q{q} plane {p}")
    planes = convert.bgrx_to_iyuv(inp["px"])
    if not all(torch.equal(a, b) for a, b in zip(
            planes, kdev.bgrx_to_iyuv(inp["px"]))):
        failed.append("X1")
    if not torch.equal(convert.iyuv_to_bgrx(*planes),
                       kdev.iyuv_to_bgrx(*planes)):
        failed.append("X2")
    x, c = chain_inputs(dev)
    chain, plain = dct_chain(x, c), dct_chain_plain(x, c)
    if not torch.equal(chain.view(torch.int32), plain.view(torch.int32)):
        failed.append("T7 chain != its plain version")
    host = host_chain(inp["xs"], c.cpu().numpy())
    if not np.array_equal(chain.cpu().numpy().view(np.uint32),
                          host.view(np.uint32)):
        failed.append("T7 chain != host double-rounded")
    pb = probe.contraction_probe_blocks()
    n = 1024
    tiles = torch.from_numpy(np.resize(pb, (n, 8, 8))).to(dev)
    pframe = _frame_of(tiles, torch.full((n * 64 // 2,), 128,
                                         dtype=torch.uint8, device=dev),
                       (64, 1024))
    dct, qt50 = codec_params([50] * 3, dev)
    if not torch.equal(transform.dct_quantize_blocks(*pframe, qt50, dct),
                       transform.dct_quantize_blocks_plain(*pframe, qt50,
                                                           dct)):
        failed.append("K3 on the contraction-probe blocks")
    return {"tool": "check_bitexact", "probe_blocks": int(pb.shape[0]),
            "failed": failed,
            "max_abs_err": common.max_abs_err([(chain, plain)])}


def chain_inputs(dev):
    """T7's x [64, 1024] (the tool's draw) and DCT row 1 on ``dev``."""
    x = torch.from_numpy(inputs("cpu")["xs"]).to(dev)
    return x, torch.from_numpy(np.asarray(DCT_MATRIX8, np.float32)[1]).to(dev)


def times(device="cuda") -> dict:
    """The chain's time on the card beside its plain version's and its
    bound (no single PyTorch call computes the chain)."""
    x, c = chain_inputs(torch.device(device))
    return {"dct_chain": common.times(
        dct_chain, dct_chain_plain, args=[x, c],
        nbytes=4 * (x.numel() + c.numel() + 8 * x.shape[1]),
        ops=15 * 8 * x.shape[1])}


def main(argv=None) -> int:
    out = common.run_tool(run, times, __doc__, argv)
    return 1 if out["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
