#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``myyuv_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

It builds the two CUDA kernels from ``myyuv_tpu_torch/csrc`` (nvcc, first
use), then, each phase printing one line and any failure ending the run
with a non-zero exit code:

1. environment: Python, torch, CUDA and nvcc versions, the card;
2. build of both kernels, timed;
3. K1 (csrc/dct_encode.cu) against its plain PyTorch version on the card at
   4032x3008, q50 and q90, on five content kinds (noise, gradient, flat,
   impulse, banded) with the contraction-probe blocks in every frame:
   chunk bytes, sizes and error flags identical;
4. K2 (csrc/decode_idct.cu) against its plain version on the same streams:
   pixels and error codes identical, and corrupt chunks flagged alike;
5. the main path through the CLI (``-to_yuv IYUV``, ``-compress DCT 50``,
   ``-decompress``) on a synthetic 4032x3008 XRGB8888 BMP, with the launch
   counters of K1 and K2 reset just before and read just after; the file's
   payload must equal the plain versions' stream for the same planes and
   the decoded planes their plain decode; then the same three commands at
   1920x1088 with ``--device cuda`` and ``--device cpu`` must write
   identical files;
6. the launch counters of the main path's run are > 0;
7. times with CUDA events (median of 7): K1 and K2 against their plain
   versions at 4032x3008 q50, and end-to-end compress and decompress.

It prints a JSON line with one entry per kernel, the card's name and power
limit as ``nvidia-smi`` gives them, and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``myyuv_tpu_torch`` package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

H4K, W4K = 3008, 4032
H1K, W1K = 1088, 1920
QUALITIES = (50, 90)
REPS = 7


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms over CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int = REPS) -> float:
    """Median host-clock time of fn() in ms, each run ending in a sync."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> int:
    if not a.numel():
        return 0
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from myyuv_tpu_torch import cli
    from myyuv_tpu_torch.engine import device_stream, pipeline
    from myyuv_tpu_torch.entropy import decode, encode
    from myyuv_tpu_torch.formats import bmp, dct_stream, yuv
    from myyuv_tpu_torch.kernels import build, probe
    from myyuv_tpu_torch.kernels import device as kdev

    dev = torch.device("cuda")
    card = nvidia_smi()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(card, flush=True)

    t0 = time.perf_counter()
    for name in ("dct_encode", "decode_idct"):
        build.load(name)
    print(f"[2 build] dct_encode.cu + decode_idct.cu for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(2026)
    probe_blocks = probe.contraction_probe_blocks()
    check(probe_blocks.shape[0] > 0, "no contraction-probe content found")
    err1 = err2 = 0
    streams = []
    for kind in probe.KINDS:
        y = probe.with_probe_blocks(
            probe.content_kind(rng, kind, (H4K, W4K)), probe_blocks)
        u = probe.content_kind(rng, kind, (H4K // 2, W4K // 2))
        v = probe.content_kind(rng, kind, (H4K // 2, W4K // 2))
        planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
        for q in QUALITIES:
            dct, qt = pipeline.codec_params([q] * 3, dev)
            got = encode.dct_encode_blocks(*planes, qt, dct)
            want = encode.dct_encode_blocks_plain(*planes, qt, dct)
            check(all(g.is_cuda for g in got), "K1 output not on the card")
            for g, w_, what in zip(got, want, ("lanes", "sizes", "err")):
                err1 = max(err1, max_abs(g, w_))
                check(torch.equal(g, w_), f"K1 {what} differ: {kind} q{q}")
            check(not got[2].any(), f"K1 flagged a chunk: {kind} q{q}")
            streams.append((kind, q, planes, qt, dct, want[0], want[1]))
    print(f"[3 K1 vs plain] {len(streams)} frames {W4K}x{H4K} "
          f"(kinds {','.join(probe.KINDS)}; "
          f"q{'/'.join(map(str, QUALITIES))}; "
          f"{probe_blocks.shape[0]} probe blocks): bytes, sizes, err "
          f"identical, max_abs_err {err1}", flush=True)

    for kind, q, planes, qt, dct, lanes, sizes in streams:
        stream = device_stream.compact_chunks(lanes, sizes)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        got = decode.decode_idct_blocks(stream, sizes, offsets, qt, dct,
                                        H4K, W4K)
        want = decode.decode_idct_blocks_plain(stream, sizes, offsets, qt,
                                               dct, H4K, W4K)
        for g, w_ in zip(got, want):
            err2 = max(err2, max_abs(g, w_))
            check(torch.equal(g, w_), f"K2 differs from plain: {kind} q{q}")
        check(not got[3].any(), f"K2 rejected a valid stream: {kind} q{q}")
        if kind == "noise" and q == 50:
            bad_stream, bad_sizes = stream.clone(), sizes.clone()
    offsets = torch.cumsum(bad_sizes, 0, dtype=torch.int64) - bad_sizes
    corrupt = {7: (2, 255), 1000: (0, 0xFF), 200000: (3, 0xE0)}
    for b, (pos, val) in corrupt.items():
        bad_stream[offsets[b] + pos] = val
    bad_sizes[284000] = 2
    offsets = torch.cumsum(bad_sizes, 0, dtype=torch.int64) - bad_sizes
    offsets[284100] = bad_stream.numel() + 100  # outside the content
    dct, qt = pipeline.codec_params([50] * 3, dev)
    got = decode.decode_idct_blocks(bad_stream, bad_sizes, offsets, qt, dct,
                                    H4K, W4K)
    want = decode.decode_idct_blocks_plain(bad_stream, bad_sizes, offsets,
                                           qt, dct, H4K, W4K)
    for g, w_ in zip(got, want):
        err2 = max(err2, max_abs(g, w_))
        check(torch.equal(g, w_), "K2 differs from plain on corrupt chunks")
    flagged = torch.nonzero(got[3]).flatten().tolist()
    check(7 in flagged and 284000 in flagged and int(got[3][284000]) == 1,
          f"corrupt chunks not flagged: {flagged[:10]}")
    print(f"[4 K2 vs plain] {len(streams)} streams: pixels and err "
          f"identical, max_abs_err {err2}; corrupt chunks flagged alike at "
          f"blocks {flagged[:8]} (codes "
          f"{[int(got[3][b]) for b in flagged[:8]]})", flush=True)
    del streams

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def synthetic_bmp(h, w, path):
            yy, xx = np.mgrid[0:h, 0:w]
            px = np.empty((h, w, 4), np.uint8)
            noise = rng.integers(-6, 7, (3, h, w))
            for c, (fy, fx) in enumerate(((0.11, 0.07), (0.05, 0.13),
                                          (0.09, 0.03))):
                base = 128 + 100 * np.sin(yy * fy / 7) * np.cos(xx * fx / 9)
                px[..., c] = np.clip(base + noise[c], 0, 255).astype(np.uint8)
            px[..., 3] = 255
            bmp.BMPImage.from_pixels(px).dump(path)
            return px

        def run_cli(*args):
            rc = cli.main([str(a) for a in args])
            check(rc == 0, f"CLI failed: {' '.join(map(str, args))}")

        px = synthetic_bmp(H4K, W4K, tmp / "f.bmp")
        encode.launches = decode.launches = 0
        t0 = time.perf_counter()
        run_cli(tmp / "f.bmp", "-to_yuv", "IYUV", "-o", tmp / "f.myyuv")
        run_cli(tmp / "f.myyuv", "-compress", "DCT", "50", "-o",
                tmp / "f-c.myyuv")
        run_cli(tmp / "f-c.myyuv", "-decompress", "-o", tmp / "f-d.myyuv")
        t_cli = time.perf_counter() - t0
        launches = {"dct_encode": encode.launches,
                    "decode_idct": decode.launches}

        img = yuv.YUVImage.load(tmp / "f.myyuv")
        want_planes = kdev.bgrx_to_iyuv(torch.from_numpy(px))
        for p, w_ in zip(img.planes(), want_planes):
            check(np.array_equal(p, w_.numpy()),
                  "-to_yuv on the card differs from the CPU conversion")
        planes = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                  for p in img.planes()]
        dct, qt = pipeline.codec_params([50] * 3, dev)
        lanes, sizes, err = encode.dct_encode_blocks_plain(*planes, qt, dct)
        stream = device_stream.compact_chunks(lanes, sizes)
        plain = device_stream.split_planes(
            sizes.cpu().numpy(), stream.cpu().numpy(), H4K, W4K)
        comp = yuv.YUVImage.load(tmp / "f-c.myyuv")
        st = dct_stream.DCTStream.parse(comp.data)
        for (s, c), p in zip(plain, st.planes):
            check(np.array_equal(s, p.chunk_sizes)
                  and np.array_equal(c, p.content),
                  "compressed payload differs from the plain stream")
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        ry, ru, rv, rerr = decode.decode_idct_blocks_plain(
            stream, sizes, offsets, qt, dct, H4K, W4K)
        dec = yuv.YUVImage.load(tmp / "f-d.myyuv")
        check(not rerr.any(), "plain decode rejected the stream")
        for p, w_ in zip(dec.planes(), (ry, ru, rv)):
            check(np.array_equal(p, w_.cpu().numpy()),
                  "decompressed planes differ from the plain decode")
        yo = img.planes()[0].astype(np.float64)
        mse = float(((dec.planes()[0].astype(np.float64) - yo) ** 2).mean())
        psnr = 10 * np.log10(255.0 ** 2 / mse) if mse else float("inf")
        check(np.isfinite(mse) and psnr > 25.0, f"PSNR-Y {psnr:.2f} dB")
        ratio = img.header.data_size / comp.header.data_size
        print(f"[5 main path] CLI -to_yuv/-compress DCT 50/-decompress "
              f"--device cuda on {W4K}x{H4K}: {t_cli:.2f} s, payload == "
              f"plain stream, planes == plain decode, PSNR-Y {psnr:.2f} dB, "
              f"ratio {ratio:.2f}x", flush=True)

        synthetic_bmp(H1K, W1K, tmp / "g.bmp")
        files = {}
        for device in ("cuda", "cpu"):
            d = tmp / device
            d.mkdir()
            run_cli(tmp / "g.bmp", "-to_yuv", "IYUV", "-o", d / "a.myyuv",
                    "--device", device)
            run_cli(d / "a.myyuv", "-compress", "DCT", "50", "-o",
                    d / "c.myyuv", "--device", device)
            run_cli(d / "c.myyuv", "-decompress", "-o", d / "d.myyuv",
                    "--device", device)
            files[device] = [(d / f).read_bytes()
                             for f in ("a.myyuv", "c.myyuv", "d.myyuv")]
        check(files["cuda"] == files["cpu"],
              "--device cuda and --device cpu files differ")
        print(f"[5 main path] {W1K}x{H1K}: --device cuda and --device cpu "
              f"write identical files (to_yuv, DCT 50, decompress)",
              flush=True)

    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    print(f"[6 launches] main path: {launches}", flush=True)

    # timings on the CLI frame's planes, q50
    k1_ms = cuda_ms(lambda: encode.dct_encode_blocks(*planes, qt, dct))
    k1_plain = cuda_ms(
        lambda: encode.dct_encode_blocks_plain(*planes, qt, dct))
    k2_ms = cuda_ms(lambda: decode.decode_idct_blocks(
        stream, sizes, offsets, qt, dct, H4K, W4K))
    k2_plain = cuda_ms(lambda: decode.decode_idct_blocks_plain(
        stream, sizes, offsets, qt, dct, H4K, W4K))
    e2e_c = host_ms(lambda: pipeline.compress_dct(img, bytes([50] * 3),
                                                  device=dev))
    e2e_d = host_ms(lambda: pipeline.decompress_dct(comp, device=dev))
    print(f"[7 times] {card} | {W4K}x{H4K} q50, median of {REPS}: "
          f"K1 {k1_ms:.4f} ms (plain {k1_plain:.4f} ms), "
          f"K2 {k2_ms:.4f} ms (plain {k2_plain:.4f} ms) [CUDA events]; "
          f"compress_dct {e2e_c:.3f} ms, decompress_dct {e2e_d:.3f} ms "
          f"[host clock, file in memory to file in memory]", flush=True)

    print(json.dumps({"kernels": [
        {"name": "dct_encode", "route": "cuda",
         "source": "myyuv_tpu_torch/csrc/dct_encode.cu",
         "replaces": "myyuv_tpu/entropy/pallas_encode8.py:609",
         "launches": launches["dct_encode"], "max_abs_err": err1,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "decode_idct", "route": "cuda",
         "source": "myyuv_tpu_torch/csrc/decode_idct.cu",
         "replaces": "myyuv_tpu/entropy/pallas_decode8.py:189",
         "launches": launches["decode_idct"], "max_abs_err": err2,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
