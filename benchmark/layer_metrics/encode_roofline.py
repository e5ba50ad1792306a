"""Share of the roofline of the ``compress_batch`` calls: their least time from
shapes (``lib/roofline.py``) over the device time of every kernel, memcpy
and memset they launched, in %."""

from benchmark.lib.readers import roofline_pct


def read(t):
    return roofline_pct(t, "compress_batch")
