"""Plain reference of the `.myyuv` container (myyuv_yuv.hpp:13-29, DCT.cpp
16-197), for the benchmark's inputs and its output check.

Header: 64 packed bytes, "YU", u32 fourcc, u32 data_size, u16 compression,
u32 params_size, u32 params_pos, u32 width, u32 height, u32 data_pos, 32
unused bytes. A raw IYUV file is the header and the Y, U and V planes; a DCT
file is the header, the 3 quality bytes and the payload:

  payload := u32 plane_sizes[3], then per plane
             u32 n_blocks, u32 content_size, u8 sizes[n_blocks], content
"""

from __future__ import annotations

import struct
from typing import Sequence, Tuple

import numpy as np

HEADER = struct.Struct("<2s I I H I I I I I 32s")
HEADER_SIZE = 64
IYUV = int.from_bytes(b"IYUV", "little")
NONE, DCT = 0, 1


def raw_file(planes: Sequence[np.ndarray]) -> bytes:
    """An uncompressed IYUV file of (y, u, v) uint8 planes."""
    h, w = planes[0].shape
    data = b"".join(np.ascontiguousarray(p, np.uint8).tobytes()
                    for p in planes)
    head = HEADER.pack(b"YU", IYUV, len(data), NONE, 0, 0, w, h,
                       HEADER_SIZE, bytes(32))
    return head + data


def payload(plane_streams: Sequence[Tuple[np.ndarray, np.ndarray]]) -> bytes:
    """The DCT payload of per-plane (chunk sizes u8, content u8)."""
    parts = []
    for sizes, content in plane_streams:
        parts.append(struct.pack("<II", sizes.size, content.size)
                     + sizes.astype(np.uint8).tobytes()
                     + content.astype(np.uint8).tobytes())
    head = struct.pack("<III", *(len(p) for p in parts))
    return head + b"".join(parts)


def dct_file(width: int, height: int, quality: Sequence[int],
             plane_streams) -> bytes:
    """A DCT-compressed IYUV file."""
    data = payload(plane_streams)
    head = HEADER.pack(b"YU", IYUV, len(data), DCT, 3, HEADER_SIZE, width,
                       height, HEADER_SIZE + 3, bytes(32))
    return head + bytes(int(q) for q in quality) + data


def plane_shapes(h: int, w: int):
    """(H, W) of the Y, U and V planes of an h x w IYUV frame."""
    return [(h, w), (h // 2, w // 2), (h // 2, w // 2)]


def raw_planes(raw: bytes):
    """(y, u, v) uint8 arrays of an uncompressed IYUV file."""
    fields = HEADER.unpack(raw[:HEADER_SIZE])
    w, h, data_pos = fields[6], fields[7], fields[8]
    data = np.frombuffer(raw, np.uint8, offset=data_pos)
    out, pos = [], 0
    for ph, pw in plane_shapes(h, w):
        out.append(data[pos:pos + ph * pw].reshape(ph, pw))
        pos += ph * pw
    return out
