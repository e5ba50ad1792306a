"""Device time of the host <-> device copies a decompress request made
(``streams_to_device``'s uploads, the planes' ``.cpu()``), mean per
request, in ms."""


def read(t):
    s = t.span("decompress")
    return None if s is None else s.copy_s / s.count * 1e3
