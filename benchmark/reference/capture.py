"""Plain reference of the capture path: BGRX frames to the per-plane DCT
streams a ``.myyuv`` file holds.

A frame goes through the reference's own steps: the BGRX -> IYUV
conversion (``convert.bgrx_to_iyuv``), then the 8x8 DCT, quantisation and
per-block Huffman chunks of each plane (``codec.frame_coefficients``,
``codec.encode_stream``). Plain PyTorch and NumPy in float32; TF32 is
switched off while a frame is worked out, and restored after. Imports
nothing of the program under test, nor JAX.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import codec
from .convert import bgrx_to_iyuv

# per plane: (chunk sizes u8 [N], content u8 [T])
Stream = Tuple[np.ndarray, np.ndarray]


@contextmanager
def _no_tf32():
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def frame_streams(pixels: torch.Tensor, quality: Sequence[int]
                  ) -> List[Stream]:
    """One BGRX frame (uint8 [H, W, 4], H and W multiples of 16) -> its
    (Y, U, V) streams: each plane's chunk sizes as the file stores them
    (one byte a block) and its chunks back to back in block order."""
    with _no_tf32():
        coeffs = codec.frame_coefficients(bgrx_to_iyuv(pixels), quality)
        out = []
        for c in coeffs:
            sizes, content = codec.encode_stream(c)
            out.append((sizes.cpu().numpy().astype(np.uint8),
                        content.cpu().numpy()))
        return out
