"""Compressed DCT payload containers: the serialized on-disk layout.

Port of ``myyuv_tpu/formats/dct_stream.py`` (parse and serialize), the
reference's compressed-image layout (``myyuv_lib/myyuv_DCT/DCT.cpp:16-197``):

  payload  := u32 planes_sizes[3], then 3x Plane
  Plane    := u32 chunks_sizes_size (= number of 8x8 blocks in the plane),
              u32 content_size,
              u8  chunks_sizes[chunks_sizes_size],
              u8  content[content_size]
  block k's chunk starts at the exclusive prefix sum of chunks_sizes[:k]
  (``DCTYUVPlane::getContentPos``, DCT.cpp:21-33).

The port's device path never expands this layout into fixed-width lanes on
the host: the decode kernel reads ``content`` as it is, at offsets computed
on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..runtime import trace
from ..runtime.errors import BitstreamError


@dataclasses.dataclass
class DCTPlaneStream:
    """One plane's compressed stream: per-block chunk sizes + packed chunks."""

    chunk_sizes: np.ndarray  # uint8 [num_blocks]
    content: np.ndarray      # uint8 [content_size]

    @property
    def num_blocks(self) -> int:
        return int(self.chunk_sizes.size)

    def total_size(self) -> int:
        # u32 chunks_sizes_size + u32 content_size + sizes + content
        return 8 + self.chunk_sizes.size + self.content.size

    @classmethod
    def parse(cls, data: np.ndarray) -> "DCTPlaneStream":
        """Parse one serialized plane (DCTYUVPlane::load, DCT.cpp:39-62)."""
        if data.size <= 8:
            raise BitstreamError("DCTYUVPlane load bad size")
        nblk = int(data[:4].view(np.uint32)[0])
        csize = int(data[4:8].view(np.uint32)[0])
        if nblk <= 0:
            raise BitstreamError("DCTYUVPlane load chunks_sizes_size bad size")
        if csize <= 0:
            raise BitstreamError("DCTYUVPlane load content_size bad size")
        if data.size < 8 + nblk + csize:
            raise BitstreamError("DCTYUVPlane load bad size")
        return cls(chunk_sizes=data[8: 8 + nblk].copy(),
                   content=data[8 + nblk: 8 + nblk + csize].copy())

    def serialize(self) -> np.ndarray:
        out = np.empty(self.total_size(), np.uint8)
        out[:4] = np.frombuffer(
            np.uint32(self.num_blocks).tobytes(), np.uint8)
        out[4:8] = np.frombuffer(
            np.uint32(self.content.size).tobytes(), np.uint8)
        out[8: 8 + self.num_blocks] = self.chunk_sizes
        out[8 + self.num_blocks:] = self.content
        return out


@dataclasses.dataclass
class DCTStream:
    """Full 3-plane compressed payload (DCTYUV, DCT.cpp:112-197)."""

    planes: List[Optional[DCTPlaneStream]]

    @classmethod
    def parse(cls, data: np.ndarray) -> "DCTStream":
        """Parse a full payload (DCTYUV::load, DCT.cpp:130-159)."""
        with trace.span("dct_stream.parse"):
            if data.size <= 12:
                raise BitstreamError("DCTYUV load bad size")
            sizes = data[:12].view(np.uint32).astype(np.int64)
            if data.size < 12 + int(sizes.sum()):
                raise BitstreamError("DCTYUV load bad size")
            planes: List[Optional[DCTPlaneStream]] = []
            pos = 12
            for i in range(3):
                if sizes[i] != 0:
                    planes.append(
                        DCTPlaneStream.parse(data[pos: pos + sizes[i]]))
                    pos += int(sizes[i])
                else:
                    planes.append(None)
            return cls(planes)

    def serialize(self) -> np.ndarray:
        with trace.span("dct_stream.serialize"):
            chunks = [None, None, None]
            sizes = np.zeros(3, np.uint32)
            for i, p in enumerate(self.planes):
                if p is not None:
                    chunks[i] = p.serialize()
                    sizes[i] = chunks[i].size
            out = [np.frombuffer(sizes.tobytes(), np.uint8)]
            out += [c for c in chunks if c is not None]
            return np.concatenate(out)
