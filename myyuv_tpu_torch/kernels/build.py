"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"``
interface. The first call of ``load(name)`` in a process compiles it for
Hopper (``sm_90a``) into ``build/myyuv_tpu_torch/`` at the repository root,
under a file name that carries a hash of the sources and flags, so an
edited source never loads a stale library. Nothing is built at import.

Flags: ``-fmad=false`` keeps nvcc from contracting a multiply and an add
into one FMA (the kernels also spell every product and sum of the DCT
chains with ``__fmul_rn`` / ``__fadd_rn``), and there is no
``-use_fast_math``: ``__fdiv_rn`` and ``roundf`` stay IEEE-exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "myyuv_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# ctypes signatures: every pointer and the stream are c_void_p
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {
    "dct_encode": ("myyuv_dct_encode",
                   [_P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P]),
    "decode_idct": ("myyuv_decode_idct",
                    [_P, _I64, _P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P,
                     _P]),
}

_loaded: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources(name: str):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str):
    """The C entry point of kernel ``name``, built at first use."""
    fn = _loaded.get(name)
    if fn is None:
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(build(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
