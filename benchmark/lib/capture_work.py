"""The work of coding one BGRX frame to its stream, counted from shapes as
``roofline.py`` counts the codec's calls:

* bytes: the BGRX pixels read once (4 a pixel) and the stream written once
  (its chunk bytes plus one int32 size a block). The planes between the
  conversion and the transform, and the encoder's lanes, are the
  program's own business. The pull of the stream to the host crosses
  PCIe, not the card's memory, and is left out.
* operations: ``roofline.OPS_PER_BLOCK`` float32 operations a block for
  the forward transform and quantisation, and 9 a pixel for the
  conversion (three products and two adds of the luma, a subtraction and
  a product for each chroma difference).
"""

from __future__ import annotations

from typing import Tuple

from benchmark.lib import roofline

CONVERT_OPS_PER_PIXEL = 9


def capture(h: int, w: int, chunk_bytes: int) -> Tuple[int, int]:
    """(bytes, operations) of coding one h x w BGRX frame to a stream of
    ``chunk_bytes`` chunk bytes."""
    n = roofline.blocks(h, w)
    return (4 * h * w + chunk_bytes + 4 * n,
            roofline.OPS_PER_BLOCK * n + CONVERT_OPS_PER_PIXEL * h * w)
