"""Device time of the memcpys launched under the ``capture`` spans (the
pulls of each frame's sizes, flags and stream into pinned host memory),
mean per frame, in ms."""


def read(t):
    s = t.span("capture")
    return None if s is None or not s.copy_s else s.copy_s / s.count * 1e3
