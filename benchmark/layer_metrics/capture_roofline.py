"""Share of the roofline of coding a BGRX frame to its stream
(``lib/capture_work.py``: the pixels read once, the stream written once,
the transform's and the conversion's float32 operations) over the device
time of the kernels and memsets launched under the ``capture`` spans, in
%. The pulls' memcpys cross PCIe and are left out (``pull_ms``)."""

from benchmark.lib import roofline


def read(t):
    s, w = t.span("capture"), t.work.get("capture")
    if s is None or w is None or t.peak is None:
        return None
    on_card = s.device_s - s.copy_s
    if on_card <= 0:
        return None
    least, _ = roofline.least_seconds(w[0], w[1], t.peak)
    return 100.0 * least / on_card
