"""BMP (XRGB8888 / RGB24) container: byte-exact reader/writer.

Port of ``myyuv_tpu/formats/bmp.py`` (numpy, unchanged in behaviour), the
re-design of the reference BMP container (``myyuv_lib/myyuv_bmp.{hpp,cpp}``):
the raw header fields live in a dataclass and the pixel payload in a NumPy
array, so the conversion path can hand a contiguous ``[H, W, 4]`` uint8 array
straight to a torch tensor.

Format contract (reference citations):
  * ``BMPHeader`` is the packed 54-byte file+info header
    (myyuv_bmp.hpp:12-31); ``BMPColorHeader`` is the packed 84-byte
    mask/colour-space block only present for 32-bit images
    (myyuv_bmp.hpp:36-43, myyuv_bmp.cpp:148-150).
  * Validity rules mirror ``BMP::isValidHeader`` (myyuv_bmp.cpp:127-139):
    "BM" magic, width % 4 == 0, bit_count > 0, compression in {0, 3},
    BGRA masks, sRGB colour space.
  * ``pixels_topdown`` mirrors ``BMP::colorData`` (myyuv_bmp.cpp:80-103):
    rows are returned with a top-left origin regardless of the sign
    convention stored in the header.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Union

import numpy as np

from ..runtime.errors import FormatError

_HDR = struct.Struct("<2s I H H I I i i H H I I i i I I")
assert _HDR.size == 54

_COLOR_HDR = struct.Struct("<IIIII 64s")
assert _COLOR_HDR.size == 84

SRGB = 0x73524742  # 'BGRs' little-endian, myyuv_bmp.hpp:41


@dataclasses.dataclass
class BMPHeader:
    """Packed BMP file+info header (myyuv_bmp.hpp:12-31)."""

    file_size: int = 0
    reserved1: int = 0
    reserved2: int = 0
    data_pos: int = 0
    header_size: int = 40
    width: int = 0
    height: int = 0
    planes: int = 1
    bit_count: int = 0
    compression: int = 0
    size_image_for_compression: int = 0
    x_pixels_per_meter: int = 0
    y_pixels_per_meter: int = 0
    colors_used: int = 0
    colors_important: int = 0

    def pack(self) -> bytes:
        return _HDR.pack(
            b"BM", self.file_size, self.reserved1, self.reserved2,
            self.data_pos, self.header_size, self.width, self.height,
            self.planes, self.bit_count, self.compression,
            self.size_image_for_compression, self.x_pixels_per_meter,
            self.y_pixels_per_meter, self.colors_used, self.colors_important,
        )

    @classmethod
    def unpack(cls, raw: bytes) -> "BMPHeader":
        (magic, file_size, r1, r2, data_pos, header_size, width, height,
         planes, bit_count, compression, size_image, xppm, yppm,
         colors_used, colors_important) = _HDR.unpack(raw[:54])
        if magic != b"BM":
            raise FormatError("not a BMP file (bad magic)")
        return cls(file_size, r1, r2, data_pos, header_size, width, height,
                   planes, bit_count, compression, size_image, xppm, yppm,
                   colors_used, colors_important)


@dataclasses.dataclass
class BMPColorHeader:
    """Packed BMP v4 colour header (myyuv_bmp.hpp:36-43)."""

    red_mask: int = 0x00FF0000
    green_mask: int = 0x0000FF00
    blue_mask: int = 0x000000FF
    alpha_mask: int = 0xFF000000
    color_space: int = SRGB
    unused: bytes = b"\x00" * 64

    def pack(self) -> bytes:
        return _COLOR_HDR.pack(self.red_mask, self.green_mask, self.blue_mask,
                               self.alpha_mask, self.color_space, self.unused)

    @classmethod
    def unpack(cls, raw: bytes) -> "BMPColorHeader":
        r, g, b, a, cs, unused = _COLOR_HDR.unpack(raw[:84])
        return cls(r, g, b, a, cs, unused)


@dataclasses.dataclass
class BMPImage:
    """A loaded BMP image: header + raw pixel payload (file byte order)."""

    header: BMPHeader
    color_header: BMPColorHeader
    data: np.ndarray  # uint8, raw payload exactly as stored in the file

    # -- geometry (myyuv_bmp.cpp:67-78) ------------------------------------
    @property
    def true_width(self) -> int:
        return abs(self.header.width)

    @property
    def true_height(self) -> int:
        return abs(self.header.height)

    @property
    def image_size(self) -> int:
        return self.true_width * self.true_height * self.header.bit_count // 8

    # -- validation (myyuv_bmp.cpp:127-139) --------------------------------
    def is_valid_header(self) -> bool:
        h, c = self.header, self.color_header
        return (
            h.width % 4 == 0
            and h.bit_count > 0
            and h.header_size > 0
            and h.compression in (0, 3)
            and h.colors_used == 0 and h.colors_important == 0
            and c.red_mask == 0x00FF0000 and c.green_mask == 0x0000FF00
            and c.blue_mask == 0x000000FF
            and c.alpha_mask in (0xFF000000, 0)
            and c.color_space == SRGB
        )

    def is_valid(self) -> bool:
        return self.data is not None and self.is_valid_header()

    # -- pixel access --------------------------------------------------------
    def pixels_topdown(self) -> np.ndarray:
        """Pixel bytes with top-left origin, shape [H, W, bytes_per_pixel].

        Mirrors ``BMP::colorData`` (myyuv_bmp.cpp:80-103): positive height
        means the file stores rows bottom-up and they are flipped here.
        """
        if not self.is_valid():
            raise FormatError("BMP data is invalid")
        w, h = self.true_width, self.true_height
        bpp = self.header.bit_count // 8
        arr = self.data[: w * h * bpp].reshape(h, w, bpp)
        if self.header.width > 0 and self.header.height < 0:
            return arr
        if self.header.width > 0 and self.header.height > 0:
            return arr[::-1]
        if self.header.width < 0 and self.header.height > 0:
            # full byte-reversal per pixel group (myyuv_bmp.cpp:89-94)
            flat = self.data[: w * h * bpp].reshape(-1, bpp)
            return flat[::-1].reshape(h, w, bpp)
        raise FormatError("Unaccounted width and height sign")

    # -- I/O (myyuv_bmp.cpp:141-181) ----------------------------------------
    @classmethod
    def load(cls, path: Union[str, Path]) -> "BMPImage":
        raw = Path(path).read_bytes()
        header = BMPHeader.unpack(raw)
        if header.bit_count == 32:
            color_header = BMPColorHeader.unpack(raw[54:])
        else:
            color_header = BMPColorHeader()
        data_pos = header.data_pos
        # loader re-normalizes positions like myyuv_bmp.cpp:151-159
        header.data_pos = 54 + (84 if header.bit_count == 32 else 0)
        img = cls(header, color_header, np.empty(0, np.uint8))
        size = img.image_size
        header.file_size = header.data_pos + size
        if not img.is_valid_header():
            raise FormatError(f"bad BMP header: {path}")
        img.data = np.frombuffer(raw[data_pos: data_pos + size], np.uint8).copy()
        if img.data.size != size:
            raise FormatError(f"truncated BMP payload: {path}")
        return img

    def dump(self, path: Union[str, Path]) -> None:
        with open(path, "wb") as f:
            f.write(self.header.pack())
            if self.header.bit_count == 32:
                f.write(self.color_header.pack())
            f.write(self.data[: self.image_size].tobytes())

    @classmethod
    def from_pixels(cls, pixels: np.ndarray) -> "BMPImage":
        """Create a 32-bit XRGB8888 BMP from a top-down [H, W, 4] BGRA array."""
        h, w, bpp = pixels.shape
        if bpp != 4:
            raise FormatError("from_pixels expects [H, W, 4] BGRA bytes")
        header = BMPHeader(width=w, height=h, bit_count=32,
                           data_pos=54 + 84, header_size=40,
                           file_size=54 + 84 + w * h * 4)
        # store bottom-up (positive height) like common writers
        data = np.ascontiguousarray(pixels[::-1]).reshape(-1)
        return cls(header, BMPColorHeader(), data)
