"""``.myyuv`` container + the port's own fourcc/codec registry.

Port of ``myyuv_tpu/formats/yuv.py`` (the reference's
``myyuv_lib/myyuv_yuv.{hpp,cpp}``). The container is a host-side dataclass
over NumPy byte arrays. The registry is this module's own: nothing here
touches ``myyuv_tpu``'s tables, and importing the module registers no
codec. ``FORMATS`` holds IYUV (``register_format`` adds a format);
``BMP_TO_YUV``, ``COMPRESSORS`` and ``DECOMPRESSORS`` start empty and are
filled by ``engine.pipeline.register_engine_codecs`` (the CLI calls it).
``is_implemented`` answers from these tables as the JAX package's does.

File format contract (myyuv_yuv.hpp:13-29):
  64-byte packed header: "YU" magic, u32 fourcc, u32 data_size (payload bytes),
  u16 compression, u32 params_size, u32 params_pos, u32 width, u32 height,
  u32 data_pos, 32 unused bytes. On write params sit at offset 64 and data at
  64 + params_size; the loader re-normalizes positions (myyuv_yuv.cpp:500-502).
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from ..runtime import trace
from ..runtime.errors import FormatError, UnsupportedError
from .bmp import BMPImage

_YUV_HDR = struct.Struct("<2s I I H I I I I I 32s")
assert _YUV_HDR.size == 64
HEADER_SIZE = 64


def fourcc(code: str) -> int:
    """fourcc string -> little-endian u32 (e.g. 'IYUV' -> 0x56555949)."""
    assert len(code) == 4
    return int.from_bytes(code.encode("ascii"), "little")


class FourccFormats:
    """Known fourcc formats (myyuv_yuv.hpp:56-59)."""

    UNKNOWN = 0
    IYUV = fourcc("IYUV")


class Compressions:
    """Known compressions (myyuv_yuv.hpp:69-72)."""

    NONE = 0
    DCT = 1


class FormatGroup:
    """Plane layout classes (myyuv_yuv.hpp:46)."""

    UNKNOWN = 0
    PACKED = 1
    PLANAR = 2
    SEMI_PLANAR = 3


@dataclasses.dataclass(frozen=True)
class FormatDescriptor:
    """Geometry of one fourcc format (myyuv_yuv.cpp:74-86 in one record)."""

    fourcc: int
    name: str
    group: int
    num_planes: int
    resolution_fraction: Tuple[int, int]  # chroma (w_div, h_div)


IYUV = FormatDescriptor(fourcc=FourccFormats.IYUV, name="IYUV",
                        group=FormatGroup.PLANAR, num_planes=3,
                        resolution_fraction=(2, 2))

FORMATS: Dict[int, FormatDescriptor] = {FourccFormats.IYUV: IYUV}
# fourcc -> converter(BMPImage) -> YUVImage
BMP_TO_YUV: Dict[int, Callable[[BMPImage], "YUVImage"]] = {}
# (compression, fourcc) -> compress(YUVImage, params: bytes) -> YUVImage
COMPRESSORS: Dict[Tuple[int, int], Callable] = {}
# (compression, fourcc) -> decompress(YUVImage) -> YUVImage
DECOMPRESSORS: Dict[Tuple[int, int], Callable] = {}


def register_format(desc: FormatDescriptor,
                    bmp_to_yuv: Optional[Callable] = None) -> None:
    """Add a format's geometry and, if given, its BMP converter."""
    FORMATS[desc.fourcc] = desc
    if bmp_to_yuv is not None:
        BMP_TO_YUV[desc.fourcc] = bmp_to_yuv


def register_codec(compression: int, fcc: int,
                   compressor: Callable, decompressor: Callable) -> None:
    COMPRESSORS[(compression, fcc)] = compressor
    DECOMPRESSORS[(compression, fcc)] = decompressor


def is_implemented(fcc: int, compression: int = Compressions.NONE) -> bool:
    """Mirrors YUV::isImplementedFormat (myyuv_yuv.cpp:264-276): the format
    and its BMP converter are registered and, for a compression other than
    NONE, its compressor and decompressor."""
    if fcc not in FORMATS or fcc not in BMP_TO_YUV:
        return False
    if compression != Compressions.NONE:
        return ((compression, fcc) in COMPRESSORS
                and (compression, fcc) in DECOMPRESSORS)
    return True


@dataclasses.dataclass
class YUVHeader:
    """Packed 64-byte .myyuv header (myyuv_yuv.hpp:17-28)."""

    fourcc_format: int = 0
    data_size: int = 0
    compression: int = 0
    compression_params_size: int = 0
    compression_params_pos: int = 0
    width: int = 0
    height: int = 0
    data_pos: int = 0
    unused: bytes = b"\x00" * 32

    def pack(self) -> bytes:
        return _YUV_HDR.pack(b"YU", self.fourcc_format, self.data_size,
                             self.compression, self.compression_params_size,
                             self.compression_params_pos, self.width,
                             self.height, self.data_pos, self.unused)

    @classmethod
    def unpack(cls, raw: bytes) -> "YUVHeader":
        if len(raw) < HEADER_SIZE:
            raise FormatError("not a .myyuv file (short header)")
        (magic, fcc, data_size, compression, params_size, params_pos,
         width, height, data_pos, unused) = _YUV_HDR.unpack(raw[:64])
        if magic != b"YU":
            raise FormatError("not a .myyuv file (bad magic)")
        return cls(fcc, data_size, compression, params_size, params_pos,
                   width, height, data_pos, unused)


@dataclasses.dataclass
class YUVImage:
    """A .myyuv image: header + compression params + payload bytes."""

    header: YUVHeader
    compression_params: Optional[np.ndarray] = None  # uint8 or None
    data: Optional[np.ndarray] = None                # uint8 payload

    @property
    def width(self) -> int:
        return self.header.width

    @property
    def height(self) -> int:
        return self.header.height

    def is_compressed(self) -> bool:
        return self.header.compression != Compressions.NONE

    @property
    def descriptor(self) -> FormatDescriptor:
        try:
            return FORMATS[self.header.fourcc_format]
        except KeyError:
            raise UnsupportedError(
                f"format 0x{self.header.fourcc_format:08x} not registered")

    # -- validity (myyuv_yuv.cpp:248-262) ------------------------------------
    def is_valid_header(self) -> bool:
        h = self.header
        known = h.fourcc_format in FORMATS and (
            h.compression == Compressions.NONE
            or h.compression == Compressions.DCT)
        return (known and h.width > 0 and h.height > 0
                and h.data_pos >= HEADER_SIZE + h.compression_params_size
                and h.data_size > 0)

    # -- geometry (myyuv_yuv.cpp:309-381) ------------------------------------
    def plane_shape(self, channel: int) -> Tuple[int, int]:
        """(width, height) of plane `channel` (myyuv_yuv.cpp:309-325)."""
        if channel in (1, 2):
            fw, fh = self.descriptor.resolution_fraction
            return (self.width // fw, self.height // fh)
        return (self.width, self.height)

    def image_size(self) -> int:
        """Uncompressed payload size (myyuv_yuv.cpp:374-381)."""
        return sum(w * h for w, h in
                   (self.plane_shape(i)
                    for i in range(self.descriptor.num_planes)))

    def planes(self):
        """Per-plane [ph, pw] uint8 views of an uncompressed planar payload
        (getYUVPlanes, myyuv_yuv.cpp:383-427)."""
        if self.is_compressed():
            raise FormatError("cannot take planes of a compressed image")
        out, pos = [], 0
        for i in range(self.descriptor.num_planes):
            pw, ph = self.plane_shape(i)
            out.append(self.data[pos: pos + pw * ph].reshape(ph, pw))
            pos += pw * ph
        return out

    # -- codec dispatch (myyuv_yuv.cpp:454-483) -------------------------------
    def compress(self, compression: int, params: bytes) -> "YUVImage":
        if self.is_compressed():
            raise FormatError("Error already compressed")
        key = (compression, self.header.fourcc_format)
        if key not in COMPRESSORS:
            raise UnsupportedError("compression unimplemented for this format")
        return COMPRESSORS[key](self, params)

    def decompress(self) -> "YUVImage":
        """Decompressed image; a copy when the image is not compressed
        (myyuv_yuv.cpp:469-483)."""
        if not self.is_compressed():
            return self.copy()
        key = (self.header.compression, self.header.fourcc_format)
        if key not in DECOMPRESSORS:
            raise UnsupportedError(
                "decompression unimplemented for this format")
        return DECOMPRESSORS[key](self)

    def copy(self) -> "YUVImage":
        params = (None if self.compression_params is None
                  else self.compression_params.copy())
        data = None if self.data is None else self.data.copy()
        return YUVImage(dataclasses.replace(self.header), params, data)

    # -- I/O (myyuv_yuv.cpp:485-536) ------------------------------------------
    @classmethod
    def load(cls, path: Union[str, Path]) -> "YUVImage":
        raw = Path(path).read_bytes()
        return cls.from_bytes(raw, name=str(path))

    @classmethod
    def from_bytes(cls, raw: bytes, name: str = "<bytes>") -> "YUVImage":
        with trace.span("yuv.from_bytes"):
            header = YUVHeader.unpack(raw)
            img = cls(header)
            if not img.is_valid_header():
                raise FormatError(f"bad .myyuv header: {name}")
            params = None
            if header.compression_params_size > 0:
                p0 = header.compression_params_pos
                params = np.frombuffer(
                    raw[p0: p0 + header.compression_params_size],
                    np.uint8).copy()
            d0 = header.data_pos
            # re-normalize positions like the reference
            # (myyuv_yuv.cpp:500-502)
            header.compression_params_pos = HEADER_SIZE
            header.data_pos = HEADER_SIZE + header.compression_params_size
            img.compression_params = params
            if header.compression == Compressions.NONE:
                header.data_size = img.image_size()
            img.data = np.frombuffer(raw[d0: d0 + header.data_size],
                                     np.uint8).copy()
            if img.data.size != header.data_size:
                raise FormatError(f"truncated .myyuv payload: {name}")
            return img

    def to_bytes(self) -> bytes:
        with trace.span("yuv.to_bytes"):
            out = [self.header.pack()]
            if self.compression_params is not None:
                out.append(self.compression_params.tobytes())
            out.append(self.data.tobytes())
            return b"".join(out)

    def dump(self, path: Union[str, Path]) -> None:
        Path(path).write_bytes(self.to_bytes())

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_planes(cls, fcc: int, planes, width: int,
                    height: int) -> "YUVImage":
        """Build an uncompressed image from per-plane uint8 arrays."""
        with trace.span("yuv.from_planes"):
            desc = FORMATS[fcc]
            data = np.concatenate([
                np.ascontiguousarray(planes[i], np.uint8).reshape(-1)
                for i in range(desc.num_planes)])
            header = YUVHeader(fourcc_format=fcc, data_size=data.size,
                               width=width, height=height,
                               data_pos=HEADER_SIZE)
            return cls(header, None, data)

    @classmethod
    def from_bmp(cls, bmp: BMPImage, fcc: int) -> "YUVImage":
        """Convert a BMP image (myyuv_yuv.cpp:512-523 dispatch)."""
        if not bmp.is_valid():
            raise FormatError("BMP is invalid")
        if fcc not in BMP_TO_YUV:
            raise UnsupportedError("Incorrect format")
        return BMP_TO_YUV[fcc](bmp)
