"""What each timed entry should produce, worked out by the plain reference
from the inputs the benchmark made, for the output check."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import codec, container

NUM_SYMBOLS = 2048


def still_files(planes: Sequence[torch.Tensor], quality: Sequence[int]):
    """(compressed file bytes, decompressed file bytes) of one frame's
    (y, u, v) planes: compress then decompress through the file format."""
    h, w = planes[0].shape
    coeffs = codec.frame_coefficients(planes, quality)
    streams = []
    for c in coeffs:
        sizes, content = codec.encode_stream(c)
        streams.append((sizes.cpu().numpy().astype(np.uint8),
                        content.cpu().numpy()))
    packed = container.dct_file(w, h, quality, streams)
    rec = codec.reconstruct(coeffs, quality, container.plane_shapes(h, w))
    return packed, container.raw_file([p.cpu().numpy() for p in rec])


def batch_stream(planes: Sequence[torch.Tensor], quality: Sequence[int]):
    """A batch's ([B, H, W] + 2x [B, H/2, W/2]) plane-major stream and
    reconstruction: (sizes i32 [N], content u8 [T], (y, u, v) planes)."""
    b, h, w = planes[0].shape
    coeffs = codec.frame_coefficients(planes, quality)
    sizes, content = zip(*(codec.encode_stream(c) for c in coeffs))
    rec = codec.reconstruct(coeffs, quality, container.plane_shapes(h, w))
    return torch.cat(sizes), torch.cat(content), rec


def batch_roundtrip(planes: Sequence[torch.Tensor], quality: Sequence[int]):
    """A batch's round trip: ((y, u, v) reconstructed, total stream
    bytes)."""
    b, h, w = planes[0].shape
    coeffs = codec.frame_coefficients(planes, quality)
    total = sum(int(codec.encode_stream(c)[0].sum(dtype=torch.int64))
                for c in coeffs)
    rec = codec.reconstruct(coeffs, quality, container.plane_shapes(h, w))
    return rec, total


def rd_points(planes: Sequence[torch.Tensor], qualities: Sequence[int]
              ) -> List[Dict]:
    """Per-quality RD point of one frame, unrounded: quality, PSNR of each
    plane (dB, float64 from exact integer squared-error sums), the DCT
    payload's bytes (as the file holds it), bits a pixel over all three
    planes, the Shannon entropy (bits a symbol) of the global histogram
    of coefficients c in [-1024, 1023], and beside them the reconstructed
    (y, u, v) planes (``reconstruction``) and that histogram
    (``symbol_hist``, int64 [2048])."""
    h, w = planes[0].shape
    shapes = container.plane_shapes(h, w)
    npix = sum(a * b for a, b in shapes)
    out = []
    for q in qualities:
        quality = [q] * 3
        coeffs = codec.frame_coefficients(planes, quality)
        rec = codec.reconstruct(coeffs, quality, shapes)
        point = {"quality": int(q)}
        for name, p, r, (ph, pw) in zip("yuv", planes, rec, shapes):
            d = p.to(torch.int64) - r.to(torch.int64)
            mse = int((d * d).sum()) / (ph * pw)
            point[f"psnr_{name}_db"] = 10 * math.log10(
                255.0 ** 2 / max(mse, 1e-12))
        comp = 12
        hist = torch.zeros(NUM_SYMBOLS, dtype=torch.int64,
                           device=planes[0].device)
        for c in coeffs:
            sizes, _ = codec.encode_stream(c)
            comp += int(sizes.sum(dtype=torch.int64)) + sizes.numel() + 8
            v = c.reshape(-1).to(torch.int64) + 1024
            v = v[(v >= 0) & (v < NUM_SYMBOLS)]
            hist += torch.bincount(v, minlength=NUM_SYMBOLS)
        p = hist.double() / max(int(hist.sum()), 1)
        nz = p[p > 0]
        point["compressed_bytes"] = comp
        point["bits_per_pixel"] = 8 * comp / npix
        point["entropy_bits_per_symbol"] = float(-(nz * torch.log2(nz)).sum())
        point["reconstruction"] = rec
        point["symbol_hist"] = hist
        out.append(point)
    return out
