"""Does the card contract a multiply and an add into one FMA under the
port's build flags? (T4): the counterpart of ``tools/exp_fma.py``.

Run from the repository root::

    python3 -m myyuv_tpu_torch.tools.exp_fma [--device cuda|cpu]

``fma_form(a, b, c, form)`` launches ``csrc/fma_probe.cu`` on CUDA tensors
and runs ``fma_form_plain`` on CPU tensors, for three forms of y = a * b +
c (``FORMS``): ``bare`` (plain C++ ``*`` and ``+`` under
``kernels/build.py``'s flags, the JAX tool's ``_bare``), ``rounded``
(``__fadd_rn(__fmul_rn(a, b), c)``, each step rounded, the JAX tool's
``_defeated``) and ``fused`` (``__fmaf_rn``, one rounding). On the JAX
tool's inputs (seed 3, n = 2^16, products that need more than 24 mantissa
bits) it prints how many elements differ between bare and rounded (0
while ``-fmad=false`` holds), how many between fused and rounded (what a
contraction would change: 16,742 of the 65,536 on the host, by the plain
versions), and whether bare equals the host's double-rounded numpy
``a * b + c``; on a card also each form's time beside its plain version's,
``torch.addcmul`` and its bound, which is below a launch's cost, with the
card's name and power limit, as one JSON line.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels import build
from . import common

F32 = torch.float32
F64 = torch.float64
FORMS = {"bare": 0, "rounded": 1, "fused": 2}
N = 1 << 16


def fused_plain(a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding to float32. The product is exact in
    float64 (24 + 24 bits); the sum s rounds there with error e (TwoSum,
    exact), and rounding s to float32 is right unless s lies exactly
    halfway between two floats, where the sign of e decides."""
    p = a.to(F64) * b.to(F64)
    cd = c.to(F64)
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    f = s.to(F32)
    fd = f.to(F64)
    other = torch.nextafter(f, torch.where(s > fd, torch.inf, -torch.inf)
                            .to(F32))
    tie = (fd != s) & ((fd + other.to(F64)) / 2 == s) & (e != 0)
    up = torch.maximum(f, other)
    down = torch.minimum(f, other)
    return torch.where(tie, torch.where(e > 0, up, down), f)


def fma_form_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   form: str) -> torch.Tensor:
    """The plain PyTorch version of T4's form ``form``: bare and rounded
    are a product, then a sum, each rounded (separate PyTorch ops)."""
    if form == "fused":
        return fused_plain(a, b, c)
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}")
    return a * b + c


def fma_form(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             form: str) -> torch.Tensor:
    """y = a * b + c in form ``form`` (``FORMS``) over f32 tensors of one
    shape, whose element count is a multiple of 4."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}")
    build.check_tensors(a.device, ("a", a, a.shape, F32),
                        ("b", b, a.shape, F32), ("c", c, a.shape, F32))
    if build.on_cpu(a.device, "fma_probe"):
        return fma_form_plain(a, b, c, form)
    if a.numel() % 4:
        raise ValueError(f"fma_form takes a multiple of 4 elements, not "
                         f"{a.numel()}")
    for name, t in (("a", a), ("b", b), ("c", c)):
        build.check_aligned(name, t)
    out = torch.empty_like(a)
    build.launch("fma_probe", a.device, a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), a.numel(), FORMS[form], out.data_ptr())
    return out


def inputs(n: int = N):
    """The JAX tool's a, b, c (numpy f32 [n]): wide-exponent randoms times
    normals, plus small offsets."""
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(n) * np.exp2(
        rng.integers(-8, 8, n))).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * 0.001).astype(np.float32)
    return a, b, c


def differ(x: torch.Tensor, y: torch.Tensor) -> int:
    """Elements whose float32 bits differ."""
    return int((x.view(torch.int32) != y.view(torch.int32)).sum())


def tensors(dev):
    """The tool's a, b, c as f32 [n / 128, 128] tensors on ``dev``."""
    return [torch.from_numpy(x.reshape(-1, 128)).to(dev) for x in inputs()]


def run(device="cuda") -> dict:
    """The tool's counts on ``device``."""
    a, b, c = inputs()
    host = (a * b) + c
    t = tensors(torch.device(device))
    y = {form: fma_form(*t, form) for form in FORMS}
    plain = {form: fma_form_plain(*t, form) for form in FORMS}
    return {"tool": "exp_fma", "n": N,
            "bare_vs_rounded": differ(y["bare"], y["rounded"]),
            "fused_vs_rounded": differ(y["fused"], y["rounded"]),
            "bare_equals_host": differ(y["bare"].cpu(), torch.from_numpy(
                host.reshape(-1, 128))) == 0,
            "plain_exact": {form: differ(y[form], plain[form]) == 0
                            for form in FORMS},
            "max_abs_err": common.max_abs_err(
                (y[form], plain[form]) for form in FORMS)}


def times(device="cuda") -> dict:
    """Each form's time on the card beside its plain version's,
    ``torch.addcmul`` and its bound (``common.times``)."""
    t = tensors(torch.device(device))
    return {form: common.times(
        lambda a, b, c, form=form: fma_form(a, b, c, form),
        lambda a, b, c, form=form: fma_form_plain(a, b, c, form),
        lambda a, b, c: torch.addcmul(c, a, b), args=t,
        nbytes=4 * 4 * N, ops=2 * N) for form in FORMS}


def main(argv=None) -> int:
    out = common.run_tool(run, times, __doc__, argv)
    return 0 if all(out["plain_exact"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
