"""Host time of a decompress request that the device was not busy under
it: the ``decompress`` span's time less the device time of what it
launched, mean per request, in ms."""


def read(t):
    s = t.span("decompress")
    return None if s is None else (s.host_s - s.device_s) / s.count * 1e3
