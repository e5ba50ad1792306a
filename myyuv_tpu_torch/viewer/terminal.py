"""Terminal (ANSI truecolor) image preview.

The port's own copy of ``myyuv_tpu/viewer/terminal.py`` (numpy only). The
display-server-free analog of the reference's SDL3/OpenGL viewers: the
image is decoded with the same fragment-shader math (kernels/convert.
iyuv_to_bgrx) and rendered as 24-bit ANSI half-block cells, two pixel rows
per text row.
"""

from __future__ import annotations

import os

import numpy as np


def render_ansi(bgrx: np.ndarray, max_cols: int = 0) -> str:
    """[H, W, 4] uint8 BGRX -> ANSI truecolor half-block string."""
    if max_cols <= 0:
        try:
            max_cols = os.get_terminal_size().columns
        except OSError:
            max_cols = 80
    h, w = bgrx.shape[:2]
    step = max(1, (w + max_cols - 1) // max_cols)
    # box-filter downsample by `step` (trim the remainder)
    hh, ww = (h // (2 * step)) * 2 * step, (w // step) * step
    small = bgrx[:hh, :ww, :3].reshape(
        hh // step, step, ww // step, step, 3).mean(axis=(1, 3))
    small = small.astype(np.uint8)
    top = small[0::2]
    bot = small[1::2]
    rows = []
    for tr, br in zip(top, bot):
        cells = []
        for (tb, tg, trd), (bb, bg, brd) in zip(tr, br):
            cells.append(f"\x1b[38;2;{trd};{tg};{tb}m"
                         f"\x1b[48;2;{brd};{bg};{bb}m▀")
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)
