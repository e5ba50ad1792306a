"""Host time of a swept frame that the device was not busy under it: the
``sweep`` span's time less the device time of what it launched, mean per
frame, in ms."""


def read(t):
    s = t.span("sweep")
    return None if s is None else (s.host_s - s.device_s) / s.count * 1e3
