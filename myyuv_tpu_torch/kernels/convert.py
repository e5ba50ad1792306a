"""X1 and X2 wrappers: the colour conversions BGRX -> IYUV and IYUV -> BGRX.

``bgrx_to_iyuv`` launches ``csrc/bgrx_to_iyuv.cu`` (the port of
``myyuv_tpu/kernels/device.py::bgrx_to_iyuv`` / ``bgrx_to_iyuv_vals``);
``iyuv_to_bgrx`` launches ``csrc/iyuv_to_bgrx.cu`` (the port of
``device.py::iyuv_to_bgrx``). Both take their device from their input: a
CUDA tensor launches the kernel or raises, a CPU tensor runs the plain
PyTorch version in ``kernels/device.py``, any other device raises. There
is no fallback.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import build
from . import device as kdev

U8 = torch.uint8


def bgrx_to_iyuv(pixels: torch.Tensor,
                 out: Optional[Sequence[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., H, W, 4] uint8 BGRX (top-down, contiguous, H and W even) ->
    (Y [..., H, W], U, V [..., H/2, W/2]) uint8 planes on the same device,
    new ones or ``out``'s, written in place. Raises ValueError on other
    shapes."""
    if pixels.dim() < 3 or pixels.shape[-3] % 2 or pixels.shape[-2] % 2:
        raise ValueError("BGRX pixels must be [..., H, W, 4] with H and W "
                         "even")
    *lead, h, w, _ = pixels.shape
    dev = pixels.device
    luma, chroma = (*lead, h, w), (*lead, h // 2, w // 2)
    build.check_tensors(dev, ("pixels", pixels, (*lead, h, w, 4), U8))
    if out is not None:
        build.check_tensors(dev, *((name, t, shape, U8) for name, t, shape
                                   in zip("yuv", out,
                                          (luma, chroma, chroma))))
    if build.on_cpu(dev, "bgrx_to_iyuv"):
        planes = kdev.bgrx_to_iyuv(pixels)
        if out is None:
            return planes
        for dst, src in zip(out, planes):
            dst.copy_(src)
        return tuple(out)
    if out is None:
        out = [torch.empty(s, dtype=U8, device=dev)
               for s in (luma, chroma, chroma)]
    y, u, v = out
    if y.numel():
        build.launch("bgrx_to_iyuv", dev, pixels.data_ptr(), y.numel() // w,
                     w, y.data_ptr(), u.data_ptr(), v.data_ptr())
    return y, u, v


def iyuv_to_bgrx(y: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """(Y [..., H, W], U, V [..., ceil(H/2), ceil(W/2)]) uint8, contiguous
    -> [..., H, W, 4] uint8 BGRX preview on the same device. Raises
    ValueError on other shapes."""
    if y.dim() < 2:
        raise ValueError("y must be [..., H, W]")
    *lead, h, w = y.shape
    dev = y.device
    chroma = (*lead, (h + 1) // 2, (w + 1) // 2)
    build.check_tensors(dev, ("y", y, y.shape, U8), ("u", u, chroma, U8),
                        ("v", v, chroma, U8))
    if build.on_cpu(dev, "iyuv_to_bgrx"):
        return kdev.iyuv_to_bgrx(y, u, v)
    out = torch.empty((*lead, h, w, 4), dtype=U8, device=dev)
    if out.numel():
        build.launch("iyuv_to_bgrx", dev, y.data_ptr(), u.data_ptr(),
                     v.data_ptr(), y.numel() // (h * w), h, w,
                     out.data_ptr())
    return out
