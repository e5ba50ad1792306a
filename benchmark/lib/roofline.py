"""Peaks of the card and the work of each measured call, counted from shapes.

The work of a call is what its algorithm needs, whatever the kernels that
serve it read again or keep in between:

* bytes: every input byte read once and every output byte written once. A
  frame's planes are H*W + 2 * (H/2 * W/2) bytes. A coded stream counts as
  its chunk bytes plus one int32 size a block; the 256-byte lanes of the
  present encoder are its own business and never counted.
* operations: 1,984 float32 operations an 8x8 block and direction. Forward:
  two 8x8 by 8x8 products, each 64 outputs of 8 multiplies and 7 adds
  (2 * 960), and 64 divides by the table (1,920 + 64). Inverse: 64
  multiplies by the table and the same two products. Huffman coding is
  integer work and adds none here.

The least time of a call is the larger of bytes over the memory bandwidth
and operations over the float32 rate (outside the tensor cores); a share of
the roofline is that least time over the device time the call took.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

OPS_PER_BLOCK = 1984

# NVIDIA's data sheet, H100 SXM5 (dense, at the 700 W power limit)
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_per_s": 67e12},
}


def peak(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(device_name)


def blocks(h: int, w: int, frames: int = 1) -> int:
    """8x8 blocks of ``frames`` h x w IYUV frames (Y, then U and V)."""
    return frames * ((h // 8) * (w // 8) + 2 * (h // 16) * (w // 16))


def plane_bytes(h: int, w: int, frames: int = 1) -> int:
    return frames * (h * w + 2 * (h // 2) * (w // 2))


def encode(h: int, w: int, frames: int, chunk_bytes: int) -> Tuple[int, int]:
    """(bytes, operations) of coding ``frames`` frames to a stream."""
    n = blocks(h, w, frames)
    return plane_bytes(h, w, frames) + chunk_bytes + 4 * n, OPS_PER_BLOCK * n


def decode(h: int, w: int, frames: int, chunk_bytes: int) -> Tuple[int, int]:
    """(bytes, operations) of decoding a stream to ``frames`` frames."""
    return encode(h, w, frames, chunk_bytes)


def roundtrip(h: int, w: int, frames: int) -> Tuple[int, int]:
    """(bytes, operations) of coding and decoding ``frames`` frames with the
    reconstruction, the stream's total (int64) and an ok flag as outputs."""
    n = blocks(h, w, frames)
    return 2 * plane_bytes(h, w, frames) + 9, 2 * OPS_PER_BLOCK * n


def transform_step(h: int, w: int, frames: int) -> Tuple[int, int]:
    """(bytes, operations) of the transform round trip with its statistics:
    reconstruction, three float32 squared-error sums, a 2,048-bin int32
    histogram and a float32 entropy as outputs."""
    n = blocks(h, w, frames)
    return (2 * plane_bytes(h, w, frames) + 12 + 4 * 2048 + 4,
            2 * OPS_PER_BLOCK * n)


def least_seconds(nbytes: float, ops: float, pk: Dict[str, float]
                  ) -> Tuple[float, str]:
    """(least time, "bytes" or "operations", whichever bounds it)."""
    tb, to = nbytes / pk["bytes_per_s"], ops / pk["f32_per_s"]
    return (tb, "bytes") if tb >= to else (to, "operations")
