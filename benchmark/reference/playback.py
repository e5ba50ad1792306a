"""Plain reference of the playback path: a source frame's ``.myyuv``
reconstruction shown as BGRX pixels, as the reference's viewer shows it.

The reference's viewer (``myyuv_opengl_viewer image.myyuv``) decompresses
the file (viewer_yuv.cpp:24-26) and converts YUV to RGB in its fragment
shader (frag_yuv.glsl; viewer_yuv.cpp:54-71): with U' = U - 128 and
V' = V - 128 of the chroma sample that covers the pixel's 2x2 quad,
R = Y + 1.403 V', G = Y - 0.714 V' - 0.344 U', B = Y + 1.773 U'. Here in
float32 in the codec's own order: each product and each sum rounded on its
own (separate elementwise operations, never a fused multiply-add), G's two
subtractions left to right, then each channel rounded half to even and
clamped to [0, 255]; alpha 255; the bytes of a pixel B, G, R, X.

Departures from the viewer: its vertical flip belongs to the texture
coordinates and is left out (rows run top-down, as the codec's planes do);
the shader hands the display 0..1 in the GPU's float, where this rounds to
bytes.

A decoder's right answer is the reconstruction of the reference's own
coefficients of the source (``codec.frame_coefficients`` of
``convert.bgrx_to_iyuv``, then ``codec.reconstruct``): the reference has no
Huffman decoder, and the streams a decoder reads are held to the reference's
encoder on their own (``capture.frame_streams``). Plain PyTorch and NumPy in
float32, TF32 off while a frame is worked out. Imports nothing of the
program under test, nor JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import codec, container
from .capture import _no_tf32
from .convert import bgrx_to_iyuv

F32 = torch.float32


def iyuv_to_bgrx(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
    """(Y [H, W], U, V [H/2, W/2]) uint8 -> BGRX uint8 [H, W, 4]."""
    def f32(x):
        return torch.full((), x, dtype=F32, device=y.device)

    def centred(c):
        full = c.repeat_interleave(2, -2).repeat_interleave(2, -1)
        return full.to(F32) - f32(128.0)

    uu, vv = centred(u), centred(v)
    yf = y.to(F32)
    r = yf + f32(1.403) * vv
    g = (yf - f32(0.714) * vv) - f32(0.344) * uu
    b = yf + f32(1.773) * uu

    def channel(x):
        return torch.round(x).clamp(0, 255).to(torch.uint8)

    alpha = torch.full_like(y, 255)
    return torch.stack([channel(b), channel(g), channel(r), alpha], -1)


def frame_bgrx(pixels: torch.Tensor, quality: Sequence[int]) -> torch.Tensor:
    """One BGRX source frame (uint8 [H, W, 4], H and W multiples of 16) ->
    the BGRX pixels its ``.myyuv`` stream at ``quality`` decodes to."""
    h, w = pixels.shape[:2]
    with _no_tf32():
        coeffs = codec.frame_coefficients(bgrx_to_iyuv(pixels), quality)
        planes = codec.reconstruct(coeffs, quality,
                                   container.plane_shapes(h, w))
        return iyuv_to_bgrx(*planes)
