"""myyuv_tpu_torch: the myyuv codec on PyTorch and CUDA.

The port of ``myyuv_tpu`` (JAX on a TPU) to PyTorch and hand-written CUDA
kernels for Hopper. It imports torch and numpy and never JAX or
``myyuv_tpu``. Importing it registers nothing: the CLI fills the codec
registry with ``engine.pipeline.register_engine_codecs(device)``.

Layout (each module is the counterpart of ``myyuv_tpu``'s of that name):
  formats/  byte-exact BMP / .myyuv / DCT-stream containers (numpy)
  kernels/  constants, plain PyTorch transforms, the nvcc build of csrc/,
            the K3/K4 and X1/X2 (colour conversion) wrappers
  entropy/  plain PyTorch Huffman coder; K1/K2, K5/K6 kernel wrappers
  engine/   frame codec on the device, ingest/preview, streaming drivers
            (compress_stream and decompress_stream on CUDA graphs),
            K-frame scans, the RD
            statistics step and quality sweep; codec entry points and
            registry; the frame codec and round trip step sharded over a
            device mesh
  parallel/ the (data, block) device mesh; the gloo process group
  viewer/   BMP export and terminal preview (numpy); the spinning-shapes
            demo (numpy camera, PyTorch rasteriser)
  runtime/  structured errors
  csrc/     the CUDA kernels (K1-K6, X1 bgrx_to_iyuv.cu, X2 iyuv_to_bgrx.cu)
  tools/    measurement scripts (kernel A/B, the RD sweep)
  entry.py  ``entry(device)``: the flagship step and example arguments;
            ``dryrun_multichip(n, device)``: the sharded path, checked
  cli.py    ``python -m myyuv_tpu_torch`` (-info/-to_yuv/-compress/
            -decompress/-rgb/-preview/-cube, --device cuda|cpu)
"""

from .formats.bmp import BMPImage
from .formats.yuv import (Compressions, FourccFormats, YUVImage, fourcc,
                          is_implemented)

__all__ = ["BMPImage", "YUVImage", "FourccFormats", "Compressions", "fourcc",
           "is_implemented"]

__version__ = "0.1.0"
