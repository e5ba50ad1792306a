"""Codec entry points: the IYUV DCT codec and the BMP conversion.

Port of ``myyuv_tpu/engine/pipeline.py`` (``compress_dct``,
``streams_to_compressed``, ``decompress_dct``, ``bmp_to_iyuv``,
``iyuv_to_bgrx``, ``register_engine_codecs``) plus the two checks of
``myyuv_tpu/engine/host_codec.py`` (:19-34). Every entry takes the
``device`` it runs on: "cuda" runs the CUDA kernels (K1 and K2 for the
codec, F1 then K5 and K6 then F2 with ``precision="fast"``, X1 and X2 for
the conversions), "cpu" their plain PyTorch versions; there is no
fallback from one to the other. As in the JAX package, ``precision`` is a
parameter of ``compress_dct`` and ``decompress_dct`` only: the CLI and the
registry code exactly.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..formats import dct_stream, yuv
from ..formats.bmp import BMPImage
from ..kernels import constants, convert
from ..runtime import trace
from ..runtime.errors import GeometryError, MyYUVError
from . import device_stream


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MyYUVError("device 'cuda' requested but no CUDA device is "
                         "available")
    if dev.type not in ("cuda", "cpu"):
        raise MyYUVError(f"unsupported device {device!r}")
    return dev


def _check_geometry(img: yuv.YUVImage) -> None:
    fw, fh = img.descriptor.resolution_fraction
    if img.width % (8 * fw) != 0:
        raise GeometryError(f"width must be divisible by {8 * fw}")
    if img.height % (8 * fh) != 0:
        raise GeometryError(f"height must be divisible by {8 * fh}")


def _check_quality(params: bytes) -> np.ndarray:
    if len(params) != 3:
        raise MyYUVError(
            "Error compression: incorrect parameters count. "
            "3 parameters required")
    q = np.frombuffer(params, np.uint8)
    if ((q < 1) | (q > 100)).any():
        raise MyYUVError("Level of quality must be between 1 and 100")
    return q


def codec_params(qualities: Sequence[int], device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codec's weights on ``device``: (DCT matrix f32 [8, 8],
    quality-scaled tables f32 [3, 8, 8] for Y, U, V)."""
    with trace.span("pipeline.codec_params"):
        qt = np.stack([constants.quality_scaled_qtable(
            constants.PLANE_Q50[i], int(qualities[i])) for i in range(3)])
        return codec_params_from_jax(constants.DCT_MATRIX8, list(qt), device)


def codec_params_from_jax(dct_matrix_np: np.ndarray,
                          qtables_np: List[np.ndarray], device
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carry the JAX package's weights over: its ``DCT_MATRIX8`` and the
    three [8, 8] tables its ``pipeline._qtables`` returns (as numpy) ->
    the port's (dct [8, 8], qtables [3, 8, 8]) float32 tensors on
    ``device``."""
    dct = np.asarray(dct_matrix_np, np.float32).copy()
    qt = np.stack([np.asarray(q, np.float32).reshape(8, 8)
                   for q in qtables_np])
    return tuple(device_stream.to_device([dct, qt], resolve_device(device)))


def compress_dct(img: yuv.YUVImage, params: bytes, device="cuda",
                 precision: str = "exact") -> yuv.YUVImage:
    """Planar DCT compression on ``device`` (DCT.cpp:371-430 semantics).
    ``precision="fast"`` runs F1 then K5 (coefficients within +-1 of
    exact; the file is an ordinary DCT file); any value but "exact" and
    "fast" raises ValueError."""
    with trace.span("pipeline.compress_dct"):
        if img.descriptor.group != yuv.FormatGroup.PLANAR:
            raise MyYUVError("Error compressing: YUV must be planar")
        if img.is_compressed():
            raise MyYUVError("Error already compressed")
        qualities = _check_quality(params)
        _check_geometry(img)
        dct, qtables = codec_params(qualities, device)
        return streams_to_compressed(
            img, params,
            device_stream.compress_frame_to_streams(
                img.planes(), qtables, dct, precision=precision))


def streams_to_compressed(img: yuv.YUVImage, params: bytes,
                          plane_streams) -> yuv.YUVImage:
    """Assemble a compressed image from per-plane (chunk sizes, content)
    pairs: the file's header and payload, as ``compress_dct`` writes them.
    The single-file step of sharded and multi-process compression
    (``engine/sharded_stream.py``, ``parallel/distributed.py``)."""
    _check_quality(params)
    streams = [dct_stream.DCTPlaneStream(np.asarray(s, np.uint8),
                                         np.asarray(c, np.uint8))
               for s, c in plane_streams]
    payload = dct_stream.DCTStream(streams).serialize()
    header = yuv.YUVHeader(
        fourcc_format=img.header.fourcc_format,
        data_size=payload.size,
        compression=yuv.Compressions.DCT,
        compression_params_size=3,
        compression_params_pos=yuv.HEADER_SIZE,
        width=img.width, height=img.height,
        data_pos=yuv.HEADER_SIZE + 3)
    return yuv.YUVImage(header, np.frombuffer(params, np.uint8).copy(),
                        payload)


def _dct_streams(img: yuv.YUVImage, device):
    """A compressed image's checked per-plane (chunk sizes, content) and its
    codec weights (dct, qtables) on ``device``."""
    if img.descriptor.group != yuv.FormatGroup.PLANAR:
        raise MyYUVError("Error decompressing: YUV must be planar")
    qualities = _check_quality(img.compression_params.tobytes())
    _check_geometry(img)
    streams = dct_stream.DCTStream.parse(img.data)
    for i in range(3):
        pw, ph = img.plane_shape(i)
        s = streams.planes[i]
        expect = (pw // 8) * (ph // 8)
        if s is None or s.num_blocks != expect:
            raise MyYUVError(
                f"plane {i}: expected {expect} blocks, stream has "
                f"{0 if s is None else s.num_blocks}")
    dct, qtables = codec_params(qualities, device)
    return [(s.chunk_sizes, s.content) for s in streams.planes], dct, qtables


def decompress_dct(img: yuv.YUVImage, device="cuda",
                   precision: str = "exact") -> yuv.YUVImage:
    """Planar DCT decompression on ``device`` (DCT.cpp:432-488 semantics).
    A malformed chunk raises BitstreamError. ``precision="fast"`` runs K6
    then F2 (pixels within +-1 of exact); any value but "exact" and "fast"
    raises ValueError."""
    with trace.span("pipeline.decompress_dct"):
        streams, dct, qtables = _dct_streams(img, device)
        planes = device_stream.decompress_streams_to_frame(
            streams, qtables, dct, img.height, img.width,
            precision=precision)
        return yuv.YUVImage.from_planes(img.header.fourcc_format, planes,
                                        img.width, img.height)


def bmp_to_iyuv(bmp: BMPImage, device="cuda") -> yuv.YUVImage:
    """BMP XRGB8888 -> IYUV on ``device`` (myyuv_yuv.cpp:88-127). An odd
    width or height raises MyYUVError: 4:2:0 chroma takes whole 2x2 quads
    (the exact scalar oracle asserts even sizes,
    myyuv_tpu/kernels/scalar.py:52)."""
    if bmp.header.bit_count != 32:
        raise MyYUVError("only 32-bit XRGB8888 BMP inputs are supported")
    if bmp.true_width % 2 or bmp.true_height % 2:
        raise MyYUVError(f"IYUV needs an even width and height, got "
                         f"{bmp.true_width}x{bmp.true_height}")
    pixels = torch.from_numpy(np.ascontiguousarray(bmp.pixels_topdown()))
    planes = convert.bgrx_to_iyuv(pixels.to(resolve_device(device)))
    return yuv.YUVImage.from_planes(
        yuv.FourccFormats.IYUV, [device_stream.to_host(p) for p in planes],
        bmp.true_width, bmp.true_height)


def iyuv_to_bgrx(img: yuv.YUVImage, device="cuda") -> np.ndarray:
    """IYUV image -> [H, W, 4] uint8 BGRX preview (frag_yuv.glsl math) on
    ``device``. A compressed image is decoded there and its planes go
    straight into the conversion (K2, then X2 on the card); a malformed
    chunk raises BitstreamError."""
    dev = resolve_device(device)
    if img.is_compressed():
        streams, dct, qtables = _dct_streams(img, dev)
        content, sizes = device_stream.streams_to_device(streams, dev)
        planes = device_stream.decompress_frame(content, sizes, qtables, dct,
                                                img.height, img.width)
    else:
        planes = device_stream.to_device(img.planes(), dev)
    return device_stream.to_host(convert.iyuv_to_bgrx(*planes))


def register_engine_codecs(device="cuda") -> None:
    """Install this module's codec on ``device`` in the port's registry."""
    yuv.BMP_TO_YUV[yuv.FourccFormats.IYUV] = functools.partial(
        bmp_to_iyuv, device=device)
    yuv.register_codec(yuv.Compressions.DCT, yuv.FourccFormats.IYUV,
                       functools.partial(compress_dct, device=device),
                       functools.partial(decompress_dct, device=device))
