"""Kernels the card ran in the traced window (the program's own and
PyTorch's), per frame completed."""


def read(t):
    return t.kernels / t.frames if t.frames and t.kernels else None
