"""Build, load and launch the port's CUDA kernels (nvcc -> shared library ->
ctypes).

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"``
interface. The first call of ``load(name)`` in a process compiles it for
Hopper (``sm_90a``) into ``build/myyuv_tpu_torch/`` at the repository root,
under a file name that carries a hash of the sources and flags, so an
edited source or header never loads a stale library; ``build_all`` compiles
several at once, one nvcc process each, from this checkout's ``csrc/`` or
from another source tree (``open_library`` then opens what it built).
Nothing is built at import.

Flags: ``-fmad=false`` keeps nvcc from contracting a multiply and an add
into one FMA (the kernels also spell every product and sum of the DCT
chains with ``__fmul_rn`` / ``__fadd_rn``), and there is no
``-use_fast_math``: ``__fdiv_rn`` and ``roundf`` stay IEEE-exact.
``-Xptxas -v`` reports each kernel's registers, stack frame and spills
(``build_all`` returns the reports).

The wrappers (``kernels/transform.py``, ``kernels/convert.py``,
``entropy/encode.py``, ``entropy/decode.py`` and the probes of ``tools/``)
call ``launch``, which counts every launch in
``launches``: reset the counts to see which kernels a run went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "myyuv_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]

# ctypes signatures: every pointer and the stream are c_void_p
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {
    "dct_encode": ("myyuv_dct_encode",
                   [_P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P]),
    "decode_idct": ("myyuv_decode_idct",
                    [_P, _I64, _P, _P, _I64, _I64, _P, _P, _P, _P, _P, _P,
                     _P]),
    "dct_quantize": ("myyuv_dct_quantize",
                     [_P, _P, _P, _I64, _I64, _P, _P, _P, _P]),
    "dequantize_idct": ("myyuv_dequantize_idct",
                        [_P, _I64, _I64, _P, _P, _P, _P, _P, _P]),
    "huffman_encode": ("myyuv_huffman_encode", [_P, _I64, _P, _P, _P, _P]),
    "huffman_decode": ("myyuv_huffman_decode",
                       [_P, _I64, _P, _P, _I64, _P, _P, _P]),
    "bgrx_to_iyuv": ("myyuv_bgrx_to_iyuv", [_P, _I64, _I64, _P, _P, _P, _P]),
    "iyuv_to_bgrx": ("myyuv_iyuv_to_bgrx",
                     [_P, _P, _P, _I64, _I64, _I64, _P, _P]),
    # T1-T7, the probes of myyuv_tpu_torch/tools/ and the tree stage
    "huffman_tree": ("myyuv_huffman_tree",
                     [_P, _I64, _P, _P, _I64, _P, _P, _P, _P]),
    "dct_chain": ("myyuv_dct_chain", [_P, _I64, _P, _P, _P]),
    "fma_probe": ("myyuv_fma_probe", [_P, _P, _P, _I64, _I64, _P, _P]),
    "lane_shuffle": ("myyuv_lane_shuffle", [_P, _I64, _I64, _I64, _P, _P]),
    "consume_chain": ("myyuv_consume_chain",
                      [_P, _I64, _I64, _I64, _I64, _P, _P]),
    "lane_probes": ("myyuv_lane_probes", [_P, _I64, _I64, _I64, _P, _P]),
    "bcast_mul": ("myyuv_bcast_mul", [_P, _P, _I64, _I64, _P, _P]),
}

# kernel launches per kernel name (reset the values to count a run)
launches: Dict[str, int] = {name: 0 for name in SIGNATURES}

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


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``<csrc>/<name>.cu`` is built: the name carries a hash of the
    flags, the source and every header of ``csrc``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [csrc / f"{name}.cu"] + sorted(csrc.glob("*.cuh")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str], csrc: Path = CSRC) -> Dict[str, str]:
    """Compile ``<csrc>/<name>.cu`` for every name whose library is not
    built yet, one nvcc process each, all started together. Returns
    nvcc's output, with ptxas's report (registers, stack frame, spills), of
    each library it compiled."""
    jobs = []
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(csrc / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        logs[name] = log
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def open_library(name: str, csrc: Path = CSRC):
    """The C entry point of kernel ``name`` as built from ``csrc`` by
    ``build_all``."""
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(library_path(name, csrc))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def load(name: str):
    """The C entry point of kernel ``name``, built at first use."""
    fn = _loaded.get(name)
    if fn is None:
        build_all([name])
        fn = _loaded[name] = open_library(name)
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` with ``args`` (pointers and sizes) on the
    current stream of CUDA ``device``; raise if the launch was refused;
    count it."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = load(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1


def on_cpu(device: torch.device, name: str) -> bool:
    """True for the CPU (the wrapper runs the plain version), False for a
    CUDA device (it launches kernel ``name``); raises for any other."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {device}")
    return False


def check_tensors(device: torch.device, *specs) -> None:
    """Each spec (name, tensor, shape, dtype): raise ValueError unless the
    tensor has that shape and dtype, lies on ``device`` and is
    contiguous."""
    for name, t, shape, dtype in specs:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, want {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def check_aligned(name: str, t: torch.Tensor) -> None:
    """Raise ValueError unless ``t`` starts on a 16-byte boundary (the
    kernels read coefficient rows with 16-byte vector loads)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} does not start on a 16-byte boundary")
