"""Plain PyTorch codec transforms, bit-exact with the reference.

Port of ``myyuv_tpu/kernels/device.py``. Every function runs on whatever
device its input tensors lie on and, with ``precision="exact"`` (the
default), reproduces the reference's scalar float32 arithmetic bit for
bit:

* the 8x8 DCT-II chains are sequential elementwise f32 ops, one multiply
  and one add per k step, k ascending, each rounded (DCT.cpp:232-277).
  Separate PyTorch ops never contract a multiply into an add, so no
  runtime-zero guard is needed; matmul/einsum/addcmul must not be used;
* quantize is the division-free ``_exact_quantize``, equal to
  ``int16(round_half_away(RN(coef / q)))`` whatever the device's divide;
* pixel reconstruction rounds half away from zero; the preview
  conversion ``iyuv_to_bgrx`` rounds half to even (``torch.round``).

``precision="fast"`` (the JAX package's MXU einsums, ``_mxu_transform``)
computes the two 8x8 products as the fast kernels F1 and F2 do, float32
FMA chains over k ascending (``_fma_product``: broadcast products and
sums, not ``torch.matmul``, so no TF32 or matmul precision flag governs
it), and quantizes with a plain division: coefficients and pixels within
+-1 of exact, off only where a value lies within a few ulps of a rounding
tie.

These are the plain versions of the transform halves of the two CUDA
kernels (``entropy/encode.py``, ``entropy/decode.py``) and of the two
colour-conversion kernels (``kernels/convert.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .constants import DCT_MATRIX8

F32 = torch.float32


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to float32, as a scalar on ``like``'s device (a
    fill, not a copy from the host, so a CUDA caller does not wait)."""
    return torch.full((), value, dtype=F32, device=like.device)


def dct_matrix(device) -> torch.Tensor:
    """The [8, 8] float32 DCT-II matrix on ``device``."""
    return torch.as_tensor(DCT_MATRIX8, device=device)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Exact float32 std::round (half away from zero) — DCT.cpp:273,358.

    trunc + fractional compare; ``x - trunc(x)`` is exact in IEEE f32.
    """
    r = torch.trunc(x)
    f = x - r
    return r + torch.where(f.abs() >= 0.5, torch.sign(x), torch.zeros_like(x))


def _seq_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] @ [..., 8, 8], rounded after every multiply and add,
    k ascending, the first product not added to 0 (DCT.cpp:232-242)."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, 8):
        acc = acc + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return acc


def is_fast(precision: str) -> bool:
    """True for ``"fast"``, False for ``"exact"``. Any other value raises
    ValueError (the JAX package reads every string but "exact" as fast;
    the port takes the two names only)."""
    if precision not in ("exact", "fast"):
        raise ValueError(f"precision must be 'exact' or 'fast', got "
                         f"{precision!r}")
    return precision == "fast"


def _fma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor
         ) -> torch.Tensor:
    """float32 a * b + acc rounded once, as CUDA's ``__fmaf_rn``. The
    product of two floats is exact in float64; TwoSum gives the sum
    exactly as s + err; s rounded to odd (nudged one float64 ulp towards
    err when inexact and even) then rounds to the nearest float32 as the
    exact sum would (Boldo and Melquiond: 53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    c = acc.double()
    s = p + c
    bp = s - c
    err = (c - (s - bp)) + (p - bp)
    even = (s.view(torch.int64) & 1) == 0
    nudged = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf)
                             .to(s.dtype))
    return torch.where((err != 0) & even, nudged, s).float()


def _fma_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] @ [..., 8, 8] as F1's and F2's chains: the first
    product rounded, then one float32 FMA (``_fma``) a step, k ascending."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, 8):
        acc = _fma(acc, a[..., :, k:k + 1], b[..., k:k + 1, :])
    return acc


def _exact_quantize(coef: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """int16 RHA(RN_f32(coef / q)) with exact boundary semantics.

    The division-free boundary test of ``myyuv_tpu/kernels/device.py``
    (:93): the approximate quotient only seeds an integer candidate, and
    both adjacent half-integer boundaries are re-decided with products
    that are exact in f32, so the result does not depend on whether the
    device's divide is correctly rounded.
    """
    q = qtable.to(F32)
    a = coef.abs()
    sign = torch.where(coef < 0, -1, 1).to(torch.int32)
    n0 = torch.trunc(a / q + 0.5)

    def ge_tie(b: torch.Tensor) -> torch.Tensor:
        p1 = b * q                                # exact: <= 20 bits
        bits = b.view(torch.int32)
        exp = (bits >> 23) & 0xFF
        is_pow2 = (bits & 0x7FFFFF) == 0
        half_ulp_exp = exp - 24 - is_pow2.to(torch.int32)
        half_ulp = (half_ulp_exp << 23).view(F32)
        p2 = half_ulp * q                         # exact: 1 x 8 bits
        c1 = a - p1                               # exact near the tie
        even = (bits & 1) == 0                    # B mantissa parity
        return (c1 > -p2) | (even & (c1 == -p2))

    lo = ge_tie(n0 - 0.5)
    hi = ge_tie(n0 + 0.5)
    n = (n0.to(torch.int32) - 1 + lo.to(torch.int32) + hi.to(torch.int32))
    return (sign * n).to(torch.int16)


def dct_quantize(blocks_u8: torch.Tensor, qtable: torch.Tensor,
                 dct: torch.Tensor | None = None,
                 precision: str = "exact") -> torch.Tensor:
    """[..., 8, 8] uint8 pixels -> [..., 8, 8] int16 quantized coefficients.

    applyDCTBlock (DCT.cpp:269-277): centre by -128, C.B, then (C.B).C^T,
    divide by the table, round half away from zero. ``precision="fast"``:
    the products by ``_fma_product`` and ``round_half_away(coef / q)``
    (within +-1 of exact).
    """
    c = dct_matrix(blocks_u8.device) if dct is None else dct
    x = blocks_u8.to(F32) - 128.0
    if is_fast(precision):
        coef = _fma_product(_fma_product(c, x), c.t())
        return round_half_away(coef / qtable.to(F32)).to(torch.int16)
    t = _seq_matmul(c, x)
    coef = _seq_matmul(t, c.t())
    return _exact_quantize(coef, qtable)


def dequantize_idct(coeffs: torch.Tensor, qtable: torch.Tensor,
                    dct: torch.Tensor | None = None,
                    precision: str = "exact") -> torch.Tensor:
    """[..., 8, 8] int16 coefficients -> [..., 8, 8] uint8 pixels.

    restoreDCTBlock (DCT.cpp:325-335): dequantize, C^T.X, then (C^T.X).C,
    then clamp(round(x) + 128, 0, 255) (DCT.cpp:358-361).
    ``precision="fast"``: the products by ``_fma_product`` (within +-1 of
    exact).
    """
    c = dct_matrix(coeffs.device) if dct is None else dct
    x = coeffs.to(F32) * qtable.to(F32)
    if is_fast(precision):
        pix = _fma_product(_fma_product(c.t(), x), c)
    else:
        pix = _seq_matmul(_seq_matmul(c.t(), x), c)
    r = round_half_away(pix).to(torch.int32) + 128
    return r.clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Plane <-> raster-ordered 8x8 blocks (DCT.cpp:308,355 block indexing)
# ---------------------------------------------------------------------------

def plane_block_counts(h: int, w: int) -> Tuple[int, int, int]:
    """8x8 block counts of the Y, U and V planes of an h x w IYUV frame;
    frame-level tensors order their blocks Y, then U, then V, each raster
    (DCT.cpp:112-173)."""
    nc = (h // 16) * (w // 16)
    return (h // 8) * (w // 8), nc, nc


def plane_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H/8 * W/8, 8, 8] raster-ordered tiles."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)
    return x.reshape(*lead, (h // 8) * (w // 8), 8, 8)


def blocks_to_plane(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., N, 8, 8] -> [..., H, W]."""
    *lead, _, _, _ = blocks.shape
    x = blocks.reshape(*lead, h // 8, w // 8, 8, 8).transpose(-3, -2)
    return x.reshape(*lead, h, w)


# ---------------------------------------------------------------------------
# RGB <-> IYUV
# ---------------------------------------------------------------------------

def bgrx_to_iyuv(pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """[..., H, W, 4] uint8 BGRX (top-down) -> (Y, U, V) uint8 planes
    [..., H, W] and 2x [..., H/2, W/2].

    Bit-exact model of the IYUV converter (myyuv_yuv.cpp:34-52,88-127):
    float32 luma with a truncating cast, chroma as truncating cast + 128
    with wraparound, and 4:2:0 chroma equal to the sum of per-sample
    divide_roundnearest(c, 4) over each 2x2 quad (myyuv_yuv.cpp:114-121).
    Raises ValueError on an odd H or W, as the scalar oracle asserts.
    """
    if pixels.dim() < 3 or pixels.shape[-3] % 2 or pixels.shape[-2] % 2:
        raise ValueError("BGRX pixels must be [..., H, W, 4] with H and W "
                         "even")
    b = pixels[..., 0].to(F32)
    g = pixels[..., 1].to(F32)
    r = pixels[..., 2].to(F32)
    yf = (_f32(0.299, b) * r + _f32(0.587, b) * g) + _f32(0.114, b) * b
    y = torch.trunc(yf).to(torch.int32)
    cb = (torch.trunc((b - yf) * _f32(0.564, b)).to(torch.int32) + 128) & 255
    cr = (torch.trunc((r - yf) * _f32(0.713, b)).to(torch.int32) + 128) & 255

    def quad_sum(c: torch.Tensor) -> torch.Tensor:
        q = (c + 2) >> 2
        return (q[..., 0::2, 0::2] + q[..., 0::2, 1::2]
                + q[..., 1::2, 0::2] + q[..., 1::2, 1::2]) & 255

    return (y.to(torch.uint8), quad_sum(cb).to(torch.uint8),
            quad_sum(cr).to(torch.uint8))


def iyuv_to_bgrx(y: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """IYUV planes -> [..., H, W, 4] uint8 BGRX preview.

    ``y`` is [..., H, W], ``u`` and ``v`` [..., ceil(H/2), ceil(W/2)]: each
    chroma sample covers the 2x2 pixels (2i..2i+1, 2j..2j+1) of its own
    frame, cropped at an odd edge. The RGB export math of the reference's
    fragment shader (myyuv_opengl/viewer/frag_yuv.glsl): R = Y + 1.403 V',
    G = Y - 0.714 V' - 0.344 U', B = Y + 1.773 U', chroma centred, rounded
    half to even; alpha 255.
    """
    h, w = y.shape[-2:]

    def up(c: torch.Tensor) -> torch.Tensor:
        c2 = c.repeat_interleave(2, -2).repeat_interleave(2, -1)
        return c2[..., :h, :w].to(F32) - 128.0

    uu, vv = up(u), up(v)
    yf = y.to(F32)
    r = yf + _f32(1.403, yf) * vv
    g = (yf - _f32(0.714, yf) * vv) - _f32(0.344, yf) * uu
    b = yf + _f32(1.773, yf) * uu
    alpha = torch.full_like(yf, 255.0)
    out = torch.stack([b, g, r, alpha], dim=-1)
    return torch.round(out).clamp(0, 255).to(torch.uint8)
