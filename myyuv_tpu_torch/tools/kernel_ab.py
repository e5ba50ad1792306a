"""A/B timing of the codec kernels -- K1 (``dct_encode``), K5
(``huffman_encode``), K2 (``decode_idct``), K6 (``huffman_decode``), K3
(``dct_quantize``), K4 (``dequantize_idct``) and the fast transforms F1
(``fast_dct_quantize``) and F2 (``fast_dequantize_idct``) -- across source
trees, on one CUDA card.

Run from the repository root on a machine with a CUDA card::

    python3 -m myyuv_tpu_torch.tools.kernel_ab [--other LABEL=DIR ...]

Builds the kernels with ``kernels/build.py`` (all builds in parallel)
from this checkout's ``csrc/`` (label ``this``) and from each ``DIR`` given
by ``--other`` (the ``myyuv_tpu_torch/csrc`` of another commit, unpacked
for example with ``git archive <commit> myyuv_tpu_torch/csrc | tar -x -C
build/parent``; a tree without F1's and F2's sources times K1-K6 only),
and prints each build's ptxas registers, stack frame and spills. On two
4032x3008 q50 frames -- ``cli``, ``probe.smooth_picture``
converted to IYUV as ``-to_yuv IYUV`` does, and ``noise``, uniform random
planes -- it holds every build's outputs to the plain versions' (the
encoders' lanes, sizes and err; the decoders' coefficients or planes and
err, on the plain encoder's stream of the frame; K3's coefficients and
K4's planes of them; F1's coefficients and F2's planes of K3's), then
times every build of each kernel with
``probe.cuda_ms`` (chip_smoke's timer: back-to-back calls queued behind a
busy card, so the host's work is left out), calling the C entry points
directly: 7 rounds, the builds in turns (forward, then backward order),
one reading each. It prints the median per build, kernel
and frame beside the card's name and power limit, and one JSON line. As a
yardstick it also times ``lanes.zero_()``, the write of the 256-byte lanes
alone that both encoders' output contract costs.
"""

from __future__ import annotations

import argparse
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

H, W = 3008, 4032
REPS = 7
KERNELS = ("dct_encode", "huffman_encode", "decode_idct", "huffman_decode",
           "dct_quantize", "dequantize_idct", "fast_dct_quantize",
           "fast_dequantize_idct")


def ptxas_summary(log: str) -> str:
    regs = re.search(r"Used (\d+) registers", log)
    stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", log)
    if not (regs and stack):
        return "no report (library cached)"
    return (f"{regs.group(1)} registers, {stack.group(1)} B stack, "
            f"{stack.group(2)}/{stack.group(3)} B spill st/ld")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", nargs="*", default=[], metavar="LABEL=DIR",
                    help="csrc/ of another commit, under a label")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    trees = {"this": build.CSRC}
    for spec in args.other:
        label, _, path = spec.partition("=")
        trees[label] = Path(path).resolve()
    reports, fns = {}, {}
    for label, csrc in trees.items():
        names = [k for k in KERNELS if (csrc / f"{k}.cu").exists()]
        logs = build.build_all(names, csrc)
        reports[label] = {k: ptxas_summary(logs.get(k, "")) for k in names}
        fns[label] = {k: build.open_library(k, csrc) for k in names}
        for name in names:
            print(f"[ptxas] {label} {name}: {reports[label][name]}")

    rng = np.random.default_rng(2026)
    cli = [p.to(dev) for p in kdev.bgrx_to_iyuv(torch.from_numpy(
        probe.smooth_picture(rng, H, W)))]
    noise = [torch.from_numpy(probe.content_kind(rng, "noise", s)).to(dev)
             for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    dct, qt = pipeline.codec_params([50] * 3, dev)
    n = transform.frame_blocks(H, W)
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = {}
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
        outs = (lanes.data_ptr(), lsizes.data_ptr(), err.data_ptr(), stream)
        ins = (content.data_ptr(), content.numel(), sizes.data_ptr(),
               offsets.data_ptr())
        calls = {
            "dct_encode": ((lanes, lsizes, err), want, lambda f: f(
                *(p.data_ptr() for p in planes), H, W, qt.data_ptr(),
                dct.data_ptr(), *outs)),
            "huffman_encode": ((lanes, lsizes, err), check5, lambda f: f(
                coeffs.data_ptr(), n, *outs)),
            "decode_idct": ((y, u, v, err), decode.decode_idct_blocks_plain(
                content, sizes, offsets, qt, dct, H, W), lambda f: f(
                *ins, H, W, qt.data_ptr(), dct.data_ptr(), y.data_ptr(),
                u.data_ptr(), v.data_ptr(), err.data_ptr(), stream)),
            "huffman_decode": ((rows, err), decode.decode_blocks_plain(
                content, sizes, offsets), lambda f: f(
                *ins, n, rows.data_ptr(), err.data_ptr(), stream)),
            "dct_quantize": ((rows,), (coeffs,), lambda f: f(
                *(p.data_ptr() for p in planes), H, W, qt.data_ptr(),
                dct.data_ptr(), rows.data_ptr(), stream)),
            "dequantize_idct": ((y, u, v),
                                transform.dequantize_idct_blocks_plain(
                                    coeffs, qt, dct, H, W), lambda f: f(
                coeffs.data_ptr(), H, W, qt.data_ptr(), dct.data_ptr(),
                y.data_ptr(), u.data_ptr(), v.data_ptr(), stream)),
            "fast_dct_quantize": ((rows,), (
                transform.fast_dct_quantize_blocks_plain(*planes, qt, dct),),
                lambda f: f(*(p.data_ptr() for p in planes), H, W,
                            qt.data_ptr(), dct.data_ptr(), rows.data_ptr(),
                            stream)),
            "fast_dequantize_idct": (
                (y, u, v), transform.fast_dequantize_idct_blocks_plain(
                    coeffs, qt, dct, H, W), lambda f: f(
                    coeffs.data_ptr(), H, W, qt.data_ptr(), dct.data_ptr(),
                    y.data_ptr(), u.data_ptr(), v.data_ptr(), stream)),
        }
        for name, (got, plain, call) in calls.items():
            labels = [label for label in trees if name in fns[label]]
            for label in labels:
                for t in got:
                    t.fill_(0xAB if t.dtype == torch.uint8 else 77)
                if call(fns[label][name]):
                    raise SystemExit(f"{label} {name}: launch failed")
                torch.cuda.synchronize()
                for g, p in zip(got, plain):
                    if not torch.equal(g, p):
                        raise SystemExit(f"{label} {name} differs from the "
                                         f"plain version on {frame}")
            times = {label: [] for label in labels}
            for r in range(REPS):
                for label in (labels if r % 2 == 0 else labels[::-1]):
                    times[label].append(probe.cuda_ms(
                        lambda: call(fns[label][name]), 1))
            for label in labels:
                results[f"{name} {frame} {label}"] = statistics.median(
                    times[label])
        results[f"lanes.zero_ {frame} -"] = probe.cuda_ms(lanes.zero_, REPS)
        print(f"[times] {card} | {W}x{H} q50 {frame} frame "
              f"({content.numel()} stream bytes), median of {REPS}, CUDA "
              f"events: " + ", ".join(
                  f"{k.split()[0]} {k.split()[2]} {v:.4f} ms"
                  for k, v in results.items() if k.split()[1] == frame),
              flush=True)
    print(json.dumps({"card": card, "ms": results, "ptxas": reports}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
