"""K1 and K5 wrappers: the fused frame encode and the coefficient encode.

``dct_encode_blocks`` launches ``csrc/dct_encode.cu`` (the port of
``myyuv_tpu/entropy/pallas_encode8.py::_dct_encode_kernel8``);
``encode_blocks`` launches ``csrc/huffman_encode.cu`` (the port of
``pallas_encode8.py::_encode_kernel8`` and of its entry point
``entropy/pallas_encode.py::_encode_kernel``); ``dct_encode_phase``
launches ``csrc/dct_encode_phases.cu``, K1 with one stage of its encoder
left out (the port of ``_dct_encode_kernel8``'s ``ablate`` bodies), for
``tools/exp_encphase.py``'s time split. They run on tensors on a CUDA
device and run their plain PyTorch versions on tensors on the CPU. There
is no fallback: a CUDA tensor launches the kernel or raises.

Output contract of both: (lanes u8 [N, 256], sizes i32 [N], err i32 [N]);
lane b holds chunk b's on-disk bytes, zero past ``sizes[b]``; ``err[b]`` is
1 only for a chunk the u8 size field cannot hold (its lane is then zero).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build
from ..kernels import transform
from . import device as edev

Lanes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# the stages K1's measurement instances leave out, in the order of their
# variant numbers 1..5 (csrc/block_huffman.cuh::EncodePhase)
PHASE_VARIANTS = ("frontonly", "merge", "groups", "lut", "serial")


def _outputs(n: int, dev: torch.device) -> Lanes:
    return (torch.empty((n, edev.LANE), dtype=torch.uint8, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))


def dct_encode_blocks_plain(y, u, v, qtables, dct) -> Lanes:
    """The plain PyTorch version of K1 (same contract)."""
    return edev.encode_lanes(
        transform.dct_quantize_blocks_plain(y, u, v, qtables, dct))


def dct_encode_blocks(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      qtables: torch.Tensor, dct: torch.Tensor) -> Lanes:
    """Frame -> per-block Huffman chunks.

    ``y`` [H, W], ``u``/``v`` [H/2, W/2] uint8 (H, W multiples of 16);
    ``qtables`` [3, 8, 8] float32 (Y, U, V); ``dct`` [8, 8] float32.
    Returns (lanes, sizes, err) over the N = Y, then U, then V raster
    blocks: K3 followed by K5 in one kernel.
    """
    h, w = transform.check_frame(y, u, v, qtables, dct)
    if build.on_cpu(y.device, "dct_encode"):
        return dct_encode_blocks_plain(y, u, v, qtables, dct)
    lanes, sizes, err = _outputs(transform.frame_blocks(h, w), y.device)
    build.launch("dct_encode", y.device, y.data_ptr(), u.data_ptr(),
                 v.data_ptr(), h, w, qtables.data_ptr(), dct.data_ptr(),
                 lanes.data_ptr(), sizes.data_ptr(), err.data_ptr())
    return lanes, sizes, err


def dct_encode_phase_plain(y, u, v, qtables, dct, variant: str) -> Lanes:
    """The plain PyTorch version of K1's ``variant`` instance."""
    _check_variant(variant)
    return edev.encode_lanes(
        transform.dct_quantize_blocks_plain(y, u, v, qtables, dct),
        skip=variant)


def dct_encode_phase(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     qtables: torch.Tensor, dct: torch.Tensor,
                     variant: str) -> Lanes:
    """``dct_encode_blocks`` with the encoder stage ``variant`` (one of
    ``PHASE_VARIANTS``) left out, as ``entropy/device.py::encode_lanes``'s
    ``skip`` describes: a measurement body, not a codec. Same arguments and
    output shapes; raises ValueError for another variant."""
    _check_variant(variant)
    h, w = transform.check_frame(y, u, v, qtables, dct)
    if build.on_cpu(y.device, "dct_encode_phases"):
        return dct_encode_phase_plain(y, u, v, qtables, dct, variant)
    lanes, sizes, err = _outputs(transform.frame_blocks(h, w), y.device)
    build.launch("dct_encode_phases", y.device, y.data_ptr(), u.data_ptr(),
                 v.data_ptr(), h, w, qtables.data_ptr(), dct.data_ptr(),
                 lanes.data_ptr(), sizes.data_ptr(), err.data_ptr(),
                 PHASE_VARIANTS.index(variant) + 1)
    return lanes, sizes, err


def _check_variant(variant: str) -> None:
    if variant not in PHASE_VARIANTS:
        raise ValueError(f"unknown encoder phase variant {variant!r}; "
                         f"one of {PHASE_VARIANTS}")


def encode_blocks(coeffs: torch.Tensor) -> Lanes:
    """Coefficient rows -> per-block Huffman chunks.

    ``coeffs`` int16 [N, 64] in natural row-major 8x8 order (zigzag is
    applied here). Distinct symbols are the full int16 values, each stored
    as its low 11 bits, as the native coder does. Returns (lanes, sizes,
    err).
    """
    n = coeffs.shape[0] if coeffs.dim() == 2 else -1
    build.check_tensors(coeffs.device,
                        ("coeffs", coeffs, (n, 64), torch.int16))
    build.check_aligned("coeffs", coeffs)
    if build.on_cpu(coeffs.device, "huffman_encode"):
        return edev.encode_lanes(coeffs)
    lanes, sizes, err = _outputs(n, coeffs.device)
    build.launch("huffman_encode", coeffs.device, coeffs.data_ptr(), n,
                 lanes.data_ptr(), sizes.data_ptr(), err.data_ptr())
    return lanes, sizes, err
