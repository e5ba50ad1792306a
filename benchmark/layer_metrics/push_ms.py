"""Device time of the memcpys launched under the ``playback`` spans, mean
per frame, in ms: each frame's upload of its sizes and chunks from pinned
host memory, and the one-byte copy of its ``ok`` flag back."""


def read(t):
    s = t.span("playback")
    return None if s is None or not s.copy_s else s.copy_s / s.count * 1e3
