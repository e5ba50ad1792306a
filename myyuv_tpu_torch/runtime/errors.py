"""Structured error types.

The reference signals user errors with ``std::runtime_error`` and internal
invariants with ``assert`` (SURVEY.md §5). Here malformed inputs raise typed
exceptions *before* any kernel launch, so device pipelines never see invalid
shapes or truncated bitstreams. Same names as ``myyuv_tpu/runtime/errors.py``.
"""


class MyYUVError(Exception):
    """Base class for all myyuv errors."""


class FormatError(MyYUVError):
    """Malformed or unsupported container bytes (bad magic/header/sizes)."""


class BitstreamError(FormatError):
    """Malformed compressed payload (reference: DCT.cpp:41-55,130-146)."""


class UnsupportedError(MyYUVError):
    """Operation not registered for this fourcc/compression combination."""


class GeometryError(MyYUVError):
    """Width/height constraint violation (e.g. W, H not divisible by 16)."""
