"""RGB export: the viewer-equivalent output path.

The port's own copy of ``myyuv_tpu/viewer/export.py`` (numpy only; the JAX
package's module cannot be imported without JAX). The reference ships three
GUI viewers (SDL3, OpenGL viewer, spinning cube) whose display math is a
fragment-shader YUV->RGB conversion (myyuv_opengl/viewer/frag_yuv.glsl).
A machine without a display server gets (a) the YUV->RGB kernel X2
(kernels/convert.iyuv_to_bgrx — same shader math), (b) this BMP writer for
the result, and (c) viewer/terminal.py for in-terminal ANSI display.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Union

import numpy as np


def ensure_bgrx(pixels: np.ndarray) -> np.ndarray:
    """Accept [H, W, 3] BGR24 or [H, W, 4] BGRX pixels; return BGRX.

    The reference SDL3 viewer displays 24-bit BMPs directly
    (myyuv_sdl3/main.cpp:20-38 maps bit_count 24 to SDL_PIXELFORMAT_BGR24);
    the export/preview equivalents here widen BGR24 to BGRX with a zero X
    byte so every downstream consumer sees one layout.
    """
    if pixels.ndim != 3 or pixels.shape[2] not in (3, 4):
        raise ValueError("expected [H, W, 3|4] pixel array")
    if pixels.shape[2] == 4:
        return pixels
    h, w = pixels.shape[:2]
    out = np.zeros((h, w, 4), np.uint8)
    out[:, :, :3] = pixels
    return out


def write_bgrx_bmp(path: Union[str, Path], bgrx: np.ndarray) -> None:
    """Write [H, W, 4] uint8 BGRX pixels as a 32-bit bottom-up BMP.

    Emits the same BITMAPINFOHEADER+alpha layout the reference BMP loader
    accepts (myyuv_bmp.cpp:127-139: 32-bit BI_BITFIELDS with the standard
    XRGB masks), so exported files round-trip through both frameworks.
    """
    h, w = bgrx.shape[:2]
    if bgrx.shape[2] != 4:
        raise ValueError("expected [H, W, 4] BGRX pixels")
    # BITMAPV4-ish: 54-byte core + 84-byte color header (masks + sRGB tag),
    # matching the reference's expected header sizes (myyuv_bmp.hpp:12-43).
    data_pos = 14 + 40 + 84
    img_size = w * h * 4
    file_size = data_pos + img_size
    core = struct.pack("<2sIHHI", b"BM", file_size, 0, 0, data_pos)
    info = struct.pack("<IiiHHIIiiII", 124, w, h, 1, 32, 3, img_size,
                       2835, 2835, 0, 0)
    # color header: RGBA masks + "sRGB" colorspace tag + 13 reserved u32
    color = struct.pack("<4I4s", 0x00FF0000, 0x0000FF00, 0x000000FF,
                        0xFF000000, b"BGRs") + b"\x00" * 64
    flipped = np.ascontiguousarray(bgrx[::-1])  # bottom-up row order
    with open(path, "wb") as f:
        f.write(core)
        f.write(info)
        f.write(color)
        f.write(flipped.tobytes())
