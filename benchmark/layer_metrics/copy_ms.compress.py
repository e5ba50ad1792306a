"""Device time of the host <-> device copies a compress request made
(``to_device``'s upload, the ``.cpu()`` downloads), mean per request, in
ms."""


def read(t):
    s = t.span("compress")
    return None if s is None else s.copy_s / s.count * 1e3
