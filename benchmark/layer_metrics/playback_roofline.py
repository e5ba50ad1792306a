"""Share of the roofline of decoding a frame's stream to BGRX pixels
(``lib/playback_work.py``: the stream read once, the pixels written once,
the inverse transform's and the conversion's float32 operations) over the
device time of the kernels and memsets launched under the ``playback``
spans, in %. The uploads' memcpys cross PCIe and are left out
(``push_ms``)."""

from benchmark.lib import roofline


def read(t):
    s, w = t.span("playback"), t.work.get("playback")
    if s is None or w is None or t.peak is None:
        return None
    on_card = s.device_s - s.copy_s
    if on_card <= 0:
        return None
    least, _ = roofline.least_seconds(w[0], w[1], t.peak)
    return 100.0 * least / on_card
