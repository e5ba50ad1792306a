"""Plain reference of the BGRX -> IYUV conversion (myyuv_yuv.cpp:34-52,
88-127): float32 luma with a truncating cast; chroma as a truncating cast
plus 128, wrapped to 8 bits; 4:2:0 chroma as the sum of the per-sample
``(c + 2) >> 2`` over each 2x2 quad, wrapped to 8 bits."""

from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def bgrx_to_iyuv(pixels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., H, W, 4] uint8 BGRX (H, W even) -> (Y [..., H, W], U, V
    [..., H/2, W/2]) uint8."""
    if pixels.shape[-3] % 2 or pixels.shape[-2] % 2:
        raise ValueError("IYUV needs an even height and width")

    def f32(x):
        return torch.full((), x, dtype=F32, device=pixels.device)

    b, g, r = (pixels[..., i].to(F32) for i in range(3))
    yf = (f32(0.299) * r + f32(0.587) * g) + f32(0.114) * b
    y = torch.trunc(yf).to(torch.int32)
    cb = (torch.trunc((b - yf) * f32(0.564)).to(torch.int32) + 128) & 255
    cr = (torch.trunc((r - yf) * f32(0.713)).to(torch.int32) + 128) & 255

    def quad(c):
        q = (c + 2) >> 2
        return (q[..., 0::2, 0::2] + q[..., 0::2, 1::2]
                + q[..., 1::2, 0::2] + q[..., 1::2, 1::2]) & 255

    return (y.to(torch.uint8), quad(cb).to(torch.uint8),
            quad(cr).to(torch.uint8))
