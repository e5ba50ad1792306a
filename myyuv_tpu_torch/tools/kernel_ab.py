"""A/B timing of the codec kernels -- K1 (``dct_encode``), K5
(``huffman_encode``), K2 (``decode_idct``), K6 (``huffman_decode``), K3
(``dct_quantize``), K4 (``dequantize_idct``) and the fast transforms F1
(``fast_dct_quantize``) and F2 (``fast_dequantize_idct``) -- across source
trees, on one CUDA card.

Run from the repository root on a machine with a CUDA card::

    python3 -m myyuv_tpu_torch.tools.kernel_ab [--other LABEL=DIR ...]
        [--timing-only LABEL=DIR ...] [--kernels NAME ...] [--cold] [--sass]

Builds the kernels with ``kernels/build.py`` (all builds in parallel)
from this checkout's ``csrc/`` (label ``this``) and from each ``DIR`` given
by ``--other`` (the ``myyuv_tpu_torch/csrc`` of another commit, unpacked
for example with ``git archive <commit> myyuv_tpu_torch/csrc | tar -x -C
build/parent``, or a copy with one edit: a variant; a tree without F1's
and F2's sources times K1-K6 only), and prints each build's ptxas
registers, stack frame and spills. On two 4032x3008 q50 frames -- ``cli``,
``probe.smooth_picture`` converted to IYUV as ``-to_yuv IYUV`` does, and
``noise``, uniform random planes -- it holds every build's outputs to the
plain versions' (the encoders' lanes, sizes and err; the decoders'
coefficients or planes and err, on the plain encoder's stream of the
frame; K3's coefficients and K4's planes of them; F1's coefficients and
F2's planes of K3's), then times every build of each kernel with
``probe.cuda_ms`` (chip_smoke's timer: back-to-back calls queued behind a
busy card, so the host's work is left out), calling the C entry points
directly: 7 rounds, the builds in turns (forward, then backward order),
one reading each. It prints the median per build, kernel and frame, with
the build's ptxas registers, beside the card's name and power limit, and
one JSON line. As a yardstick it also times ``lanes.zero_()``, the write of
the 256-byte lanes alone that both encoders' output contract costs.

``--timing-only`` trees are timed but not held to the plain versions (a
variant that computes something else on purpose, such as a division
replaced by a product, to measure that part's share): the share of output
values that differ is printed instead. ``--kernels`` times only the kernels
named. ``--cold`` also times K3, K4, F1 and F2 on inputs in device memory
(``tools/common.py::cold``: copies of inputs and outputs rotated past twice
the L2), as their bound by bytes assumes. ``--sass`` prints, for K3, K4, F1
and F2 of every build, the count of each SASS opcode in the kernel
(``cuobjdump -sass`` beside nvcc).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from myyuv_tpu_torch.engine import device_stream, pipeline
from myyuv_tpu_torch.entropy import decode, encode
from myyuv_tpu_torch.entropy import device as edev
from myyuv_tpu_torch.kernels import build, probe, transform
from myyuv_tpu_torch.kernels import device as kdev
from myyuv_tpu_torch.tools import common

H, W = 3008, 4032
REPS = 7
KERNELS = ("dct_encode", "huffman_encode", "decode_idct", "huffman_decode",
           "dct_quantize", "dequantize_idct", "fast_dct_quantize",
           "fast_dequantize_idct")
TRANSFORMS = ("dct_quantize", "dequantize_idct", "fast_dct_quantize",
              "fast_dequantize_idct")


def ptxas_summary(log: str) -> str:
    """ptxas's registers, stack frame and spills of each kernel instance in
    the library ("; " between instances)."""
    regs = re.findall(r"Used (\d+) registers", log)
    stack = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                       r"stores, (\d+) bytes spill loads", log)
    if not (regs and stack):
        return "no report (library cached)"
    return "; ".join(f"{r} registers, {s[0]} B stack, {s[1]}/{s[2]} B spill "
                     f"st/ld" for r, s in zip(regs, stack))


def sass_opcodes(library: Path) -> dict:
    """{kernel: {opcode: count}} over the SASS of each kernel instance in
    ``library``, by ``cuobjdump -sass`` beside nvcc (predicates and
    modifiers dropped)."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name = part.split(None, 1)[0]
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", part))
        counts[name] = dict(ops.most_common())
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", nargs="*", default=[], metavar="LABEL=DIR",
                    help="csrc/ of another commit, under a label")
    ap.add_argument("--timing-only", nargs="*", default=[],
                    metavar="LABEL=DIR", help="a tree timed, not held to "
                    "the plain versions")
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS),
                    choices=KERNELS, metavar="NAME")
    ap.add_argument("--cold", action="store_true",
                    help="also time K3, K4, F1, F2 on inputs in device "
                    "memory")
    ap.add_argument("--sass", action="store_true",
                    help="print the SASS opcode counts of K3, K4, F1, F2")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = common.card()
    trees = {"this": build.CSRC}
    unchecked = set()
    for spec in args.other + args.timing_only:
        label, _, path = spec.partition("=")
        trees[label] = Path(path).resolve()
        if spec in args.timing_only:
            unchecked.add(label)
    reports, regs, fns, sass = {}, {}, {}, {}
    for label, csrc in trees.items():
        names = [k for k in args.kernels if (csrc / f"{k}.cu").exists()]
        logs = build.build_all(names, csrc)
        reports[label] = {k: ptxas_summary(logs.get(k, "")) for k in names}
        regs[label] = {k: "/".join(re.findall(r"(\d+) registers",
                                              reports[label][k]))
                       for k in names}
        fns[label] = {k: build.open_library(k, csrc) for k in names}
        for name in names:
            print(f"[ptxas] {label} {name}: {reports[label][name]}")
            if args.sass and name in TRANSFORMS:
                sass[f"{label} {name}"] = sass_opcodes(
                    build.library_path(name, csrc))
                for fn, ops in sass[f"{label} {name}"].items():
                    print(f"[sass] {label} {name} {fn}: " + ", ".join(
                        f"{k} {n}" for k, n in ops.items()))

    rng = np.random.default_rng(2026)
    cli = [p.to(dev) for p in kdev.bgrx_to_iyuv(torch.from_numpy(
        probe.smooth_picture(rng, H, W)))]
    noise = [torch.from_numpy(probe.content_kind(rng, "noise", s)).to(dev)
             for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    dct, qt = pipeline.codec_params([50] * 3, dev)
    n = transform.frame_blocks(H, W)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tables = (qt.data_ptr(), dct.data_ptr())
    results, differing = {}, {}
    for frame, planes in (("cli", cli), ("noise", noise)):
        coeffs = transform.dct_quantize_blocks_plain(*planes, qt, dct)
        want = encode.dct_encode_blocks_plain(*planes, qt, dct)
        check5 = edev.encode_lanes(coeffs)
        content = device_stream.compact_chunks(want[0], want[1])
        sizes = want[1]
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        lanes = torch.empty((n, 256), dtype=torch.uint8, device=dev)
        lsizes = torch.empty(n, dtype=torch.int32, device=dev)
        err = torch.empty(n, dtype=torch.int32, device=dev)
        rows = torch.empty((n, 64), dtype=torch.int16, device=dev)
        y = torch.empty((H, W), dtype=torch.uint8, device=dev)
        u = torch.empty((H // 2, W // 2), dtype=torch.uint8, device=dev)
        v = torch.empty((H // 2, W // 2), dtype=torch.uint8, device=dev)
        ins = (content, sizes, offsets)
        enc_outs = (lanes, lsizes, err)

        def ptrs(ts):
            return [t.data_ptr() for t in ts]

        # name: (inputs, outputs, the plain version's outputs,
        #        call(entry point, inputs, outputs))
        calls = {
            "dct_encode": (planes, enc_outs, want, lambda f, i, o: f(
                *ptrs(i), H, W, *tables, *ptrs(o), stream)),
            "huffman_encode": ((coeffs,), enc_outs, check5,
                               lambda f, i, o: f(*ptrs(i), n, *ptrs(o),
                                                 stream)),
            "decode_idct": (ins, (y, u, v, err),
                            decode.decode_idct_blocks_plain(
                                content, sizes, offsets, qt, dct, H, W),
                            lambda f, i, o: f(
                                i[0].data_ptr(), i[0].numel(),
                                *ptrs(i[1:]), H, W, *tables, *ptrs(o),
                                stream)),
            "huffman_decode": (ins, (rows, err), decode.decode_blocks_plain(
                content, sizes, offsets), lambda f, i, o: f(
                i[0].data_ptr(), i[0].numel(), *ptrs(i[1:]), n, *ptrs(o),
                stream)),
            "dct_quantize": (planes, (rows,), (coeffs,), lambda f, i, o: f(
                *ptrs(i), H, W, *tables, *ptrs(o), stream)),
            "dequantize_idct": ((coeffs,), (y, u, v),
                                transform.dequantize_idct_blocks_plain(
                                    coeffs, qt, dct, H, W),
                                lambda f, i, o: f(*ptrs(i), H, W, *tables,
                                                  *ptrs(o), stream)),
            "fast_dct_quantize": (
                planes, (rows,),
                (transform.fast_dct_quantize_blocks_plain(*planes, qt,
                                                          dct),),
                lambda f, i, o: f(*ptrs(i), H, W, *tables, *ptrs(o),
                                  stream)),
            "fast_dequantize_idct": (
                (coeffs,), (y, u, v),
                transform.fast_dequantize_idct_blocks_plain(coeffs, qt, dct,
                                                            H, W),
                lambda f, i, o: f(*ptrs(i), H, W, *tables, *ptrs(o),
                                  stream)),
        }
        for name in args.kernels:
            inputs, got, plain, call = calls[name]
            labels = [label for label in trees if name in fns[label]]
            for label in labels:
                for t in got:
                    t.fill_(0xAB if t.dtype == torch.uint8 else 77)
                if call(fns[label][name], inputs, got):
                    raise SystemExit(f"{label} {name}: launch failed")
                torch.cuda.synchronize()
                if label in unchecked:
                    differing[f"{name} {frame} {label}"] = max(
                        float((g != p).double().mean())
                        for g, p in zip(got, plain))
                    continue
                for g, p in zip(got, plain):
                    if not torch.equal(g, p):
                        raise SystemExit(f"{label} {name} differs from the "
                                         f"plain version on {frame}")
            warm = {label: (lambda f=fns[label][name]: call(f, inputs, got))
                    for label in labels}
            timed = {"": warm}
            if args.cold and name in TRANSFORMS:
                timed[" cold"] = {label: common.cold(
                    lambda *ts, f=fns[label][name]: call(
                        f, ts[:len(inputs)], ts[len(inputs):]),
                    tuple(inputs) + tuple(got)) for label in labels}
            for suffix, fn in timed.items():
                times = {label: [] for label in labels}
                for r in range(REPS):
                    for label in (labels if r % 2 == 0 else labels[::-1]):
                        times[label].append(probe.cuda_ms(fn[label], 1))
                for label in labels:
                    results[f"{name}{suffix} {frame} {label}"] = (
                        statistics.median(times[label]))
            del timed
            torch.cuda.empty_cache()
        results[f"lanes.zero_ {frame} -"] = probe.cuda_ms(lanes.zero_, REPS)
        print(f"[times] {card} | {W}x{H} q50 {frame} frame "
              f"({content.numel()} stream bytes), median of {REPS}, CUDA "
              f"events: " + ", ".join(
                  f"{k.split()[0]}{' cold' * ('cold' in k)} "
                  f"{k.split()[-1]} {v:.4f} ms"
                  + (f" ({regs[k.split()[-1]][k.split()[0]]} registers)"
                     if k.split()[-1] in regs
                     and k.split()[0] in regs[k.split()[-1]] else "")
                  for k, v in results.items() if k.split()[-2] == frame),
              flush=True)
    if differing:
        print("[timing-only] share of output values differing from the "
              "plain version: " + ", ".join(
                  f"{k} {v:.3g}" for k, v in differing.items()))
    print(json.dumps({"card": card, "ms": results, "ptxas": reports,
                      "differing": differing, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
