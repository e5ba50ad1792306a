"""The work of decoding one frame's stream to BGRX pixels, counted from
shapes as ``roofline.py`` counts the codec's calls:

* bytes: the stream read once, as the file holds it (its chunk bytes and
  one byte a block for its size), and the BGRX pixels written once (4 a
  pixel). The planes between the decoder and the conversion are the
  program's own business. The upload of the stream crosses PCIe, not the
  card's memory, and is left out (``push_ms`` reads it).
* operations: ``roofline.OPS_PER_BLOCK`` float32 operations a block for
  the dequantisation and inverse transform, and 8 a pixel for the
  conversion (four products and four sums or differences).
"""

from __future__ import annotations

from typing import Tuple

from benchmark.lib import roofline

CONVERT_OPS_PER_PIXEL = 8


def playback(h: int, w: int, chunk_bytes: int) -> Tuple[int, int]:
    """(bytes, operations) of decoding one h x w frame's stream of
    ``chunk_bytes`` chunk bytes to BGRX pixels."""
    n = roofline.blocks(h, w)
    return (chunk_bytes + n + 4 * h * w,
            roofline.OPS_PER_BLOCK * n + CONVERT_OPS_PER_PIXEL * h * w)
