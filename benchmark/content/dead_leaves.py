"""Photograph-like test content from a seed: the dead-leaves model.

The dead-leaves model is the synthetic natural-image target of camera
texture tests (ISO 19567-2, IEEE 1858 CPIQ): opaque discs dropped one on
another, radii drawn with density proportional to r^-3 between ``r_min`` and
``r_max`` (which makes the picture look alike at every scale, as natural
images do), each disc with its own colour and a smooth shading ramp, then
mild sensor noise. Everything is drawn from a ``torch.Generator`` on the
device the picture is made on, in a few large calls: the same seed on the
same kind of device gives the same picture.

Parameters (a dict, as a configuration file gives them):
``r_min``, ``r_max`` (pixels), ``coverage`` (mean number of discs over a
pixel), ``lum`` ([low, high] of the luminance), ``chroma`` (standard
deviation of the colour difference), ``shade`` (standard deviation of the
ramp's slope, levels a pixel), ``noise`` (standard deviation of the sensor
noise, levels), ``spread`` (log2 range by which each picture scales
``r_min`` and ``noise``, so that the detail varies across a pool).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# disc boxes are rendered in bands of sides growing by this factor
_BAND = 1.25
# pixels a scatter call handles at most
_CHUNK = 1 << 24


def _uniform(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=dev, dtype=torch.float32)


def scene(h: int, w: int, p: Dict, gen: torch.Generator, dev
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An h x w dead-leaves scene -> (colour float32 [h, w, 3] as B, G, R
    before noise, disc id int32 [h, w], -1 where no disc lies)."""
    spread = float(p.get("spread", 0.0))
    scale = 2.0 ** (spread * (2 * float(_uniform(1, gen, dev)) - 1))
    r_min, r_max = p["r_min"] * scale, float(p["r_max"])
    z = r_min ** -2 - r_max ** -2
    mean_area = math.pi * 2 * math.log(r_max / r_min) / z
    # centres over the picture grown by r_max on every side, so that every
    # part of the picture sees the same process; discs that miss it go
    ext_h, ext_w = h + 2 * r_max, w + 2 * r_max
    n = max(1, math.ceil(p["coverage"] * ext_h * ext_w / mean_area))

    u = torch.rand((5, n), generator=gen, device=dev, dtype=torch.float64)
    normal = torch.randn((3, n), generator=gen, device=dev,
                         dtype=torch.float64)
    r = (r_min ** -2 - u[0] * z) ** -0.5
    cx, cy = u[1] * ext_w - r_max, u[2] * ext_h - r_max
    keep = (cx + r > 0) & (cx - r < w) & (cy + r > 0) & (cy - r < h)
    u, normal, r, cx, cy = u[:, keep], normal[:, keep], r[keep], cx[keep], \
        cy[keep]
    n = r.numel()
    lo, hi = p["lum"]
    lum = lo + (hi - lo) * u[3]
    theta = 2 * math.pi * u[4]
    slope = p["shade"] * normal[0]
    cb, cr = p["chroma"] * normal[1], p["chroma"] * normal[2]

    ids = _paint(h, w, r, cx, cy, dev)
    # disc n: the background, a flat mid grey
    pick = torch.where(ids < 0, n, ids).long()

    def at(v: torch.Tensor, fill: float) -> torch.Tensor:
        return torch.cat([v, v.new_full((1,), fill)])[pick]

    ys = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    ramp = at(slope, 0.0) * ((xs - at(cx, 0.0)) * torch.cos(at(theta, 0.0))
                             + (ys - at(cy, 0.0)) * torch.sin(at(theta, 0.0)))
    y = at(lum, 0.5 * (lo + hi)) + ramp
    b_ = at(cb, 0.0)
    r_ = at(cr, 0.0)
    colour = torch.stack([y + 1.773 * b_,
                          y - 0.714 * r_ - 0.344 * b_,
                          y + 1.403 * r_], dim=-1)
    return colour.float(), ids


def _paint(h: int, w: int, r, cx, cy, dev) -> torch.Tensor:
    """Id of the topmost disc over each pixel (the last drawn), int32
    [h, w], -1 where none lies: each disc's box scattered with ``amax``
    into an id buffer, discs grouped in bands of box sides."""
    n = r.numel()
    ids = torch.full((h * w + 1,), -1, dtype=torch.int32, device=dev)
    half = torch.ceil(r).to(torch.int64)
    band = torch.floor(torch.log(half.double()) / math.log(_BAND)).long()
    order = torch.argsort(band)
    band_sorted = band[order]
    edges = torch.unique_consecutive(band_sorted, return_counts=True)[1]
    start = 0
    for count in edges.tolist():
        sel = order[start:start + count]
        start += count
        reach = int(half[sel].max())
        side = 2 * reach + 1
        off = torch.arange(-reach, reach + 1, device=dev)
        dy = off.repeat_interleave(side)
        dx = off.repeat(side)
        step = max(1, _CHUNK // (side * side))
        for s in range(0, sel.numel(), step):
            d = sel[s:s + step]
            x0 = torch.floor(cx[d]).long()
            y0 = torch.floor(cy[d]).long()
            px = x0[:, None] + dx[None, :]
            py = y0[:, None] + dy[None, :]
            inside = (((px.double() + 0.5 - cx[d, None]) ** 2
                       + (py.double() + 0.5 - cy[d, None]) ** 2)
                      <= r[d, None] ** 2)
            inside &= (px >= 0) & (px < w) & (py >= 0) & (py < h)
            lin = torch.where(inside, py * w + px, h * w)
            src = d.to(torch.int32)[:, None].expand(lin.shape)
            ids.scatter_reduce_(0, lin.reshape(-1), src.reshape(-1), "amax")
    return ids[:h * w].view(h, w)


def to_bgrx(colour: torch.Tensor, noise: float,
            gen: torch.Generator) -> torch.Tensor:
    """float [..., 3] colour -> uint8 [..., 4] BGRX with Gaussian noise of
    ``noise`` levels added per sample, rounded and clamped."""
    z = torch.randn(colour.shape, generator=gen, device=colour.device,
                    dtype=torch.float32)
    px = torch.round(colour + noise * z).clamp(0, 255).to(torch.uint8)
    alpha = torch.full((*px.shape[:-1], 1), 255, dtype=torch.uint8,
                       device=px.device)
    return torch.cat([px, alpha], dim=-1)


def noise_level(p: Dict, gen: torch.Generator, dev) -> float:
    """This picture's sensor noise: ``noise`` scaled within ``spread``."""
    spread = float(p.get("spread", 0.0))
    return p["noise"] * 2.0 ** (spread * (2 * float(_uniform(1, gen, dev))
                                          - 1))


def still(h: int, w: int, p: Dict, gen: torch.Generator, dev
          ) -> torch.Tensor:
    """One h x w still: uint8 BGRX [h, w, 4]."""
    colour, _ = scene(h, w, p, gen, dev)
    return to_bgrx(colour, noise_level(p, gen, dev), gen)


def pan_job(n: int, h: int, w: int, p: Dict, gen: torch.Generator, dev,
            convert, chunk: int = 32):
    """``n`` h x w frames of a camera panning over one dead-leaves scene
    larger than the frame by ``p["pan"]`` = [rows, columns]: frame t is
    the crop at column t * columns // n and at a row that swings once
    through the rows, with fresh sensor noise, so every frame differs.
    ``convert`` maps BGRX [k, h, w, 4] to (Y, U, V). Returns (Y [n, h, w],
    U, V [n, h/2, w/2]) uint8 on ``dev``."""
    pad_y, pad_x = p["pan"]
    colour, _ = scene(h + pad_y, w + pad_x, p, gen, dev)
    noise = noise_level(p, gen, dev)
    y = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
    u = torch.empty((n, h // 2, w // 2), dtype=torch.uint8, device=dev)
    v = torch.empty_like(u)
    for s in range(0, n, chunk):
        crops = []
        for t in range(s, min(n, s + chunk)):
            ox = t * pad_x // n
            oy = round(pad_y / 2 * (1 - math.cos(2 * math.pi * t / n)))
            oy = min(oy, pad_y)
            crops.append(colour[oy:oy + h, ox:ox + w])
        k = len(crops)
        planes = convert(to_bgrx(torch.stack(crops), noise, gen))
        y[s:s + k], u[s:s + k], v[s:s + k] = planes
    return y, u, v
