#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``myyuv_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

It builds the eight CUDA kernels from ``myyuv_tpu_torch/csrc`` (nvcc, one
process per source, all at once), then, each phase printing one line and any
failure ending the run with a non-zero exit code:

1. environment: Python, torch, CUDA and nvcc versions, the card;
2. build of the eight kernels, timed, with ptxas's registers, stack frame
   and spills per kernel instance; all eight (the lane-group encoders K1
   and K5, the warp decoders K2 and K6, the group transforms K3 and K4, the
   colour conversions X1 and X2) must use no local memory (0-byte stack
   frame, no spills);
3. on ten 4032x3008 frames (five content kinds: noise, gradient, flat,
   impulse, banded; q50 and q90; the contraction-probe blocks in every
   frame): K1 (csrc/dct_encode.cu), K3 (dct_quantize.cu) and K5
   (huffman_encode.cu) against their plain PyTorch versions, and K5(K3(x))
   against K1(x): coefficients, chunk bytes, sizes and flags identical;
   K5 on int16 coefficients no DCT produces and on the encoder families
   (``probe.encoder_families``) against its plain version;
4. on those frames' streams: K2 (decode_idct.cu), K6 (huffman_decode.cu)
   and K4 (dequantize_idct.cu) against their plain versions, K4(K6(s))
   against K2(s); on a stream with corrupt chunks and on the decoder
   families (``probe.decoder_families``: every reachable error code, valid
   edge cases, offsets outside the content), K6 and K2 against their plain
   versions and K6's error codes against K2's; X2 (iyuv_to_bgrx.cu) on the
   ten decoded frames and X1 (bgrx_to_iyuv.cu) on X2's pixels, X1 on a
   4096x4096 frame holding every 24-bit colour once and X2 on planes
   holding every (Y, U, V) triple once, against their plain versions;
5. the main path through the CLI (``-to_yuv IYUV``, ``-compress DCT 50``,
   ``-decompress``) on a synthetic 4032x3008 XRGB8888 BMP, the launch counts
   set to 0 just before and read just after; the file's payload must equal
   the plain versions' stream and the decoded planes their plain decode;
   ``-rgb`` and ``-preview`` of the compressed file, counts set to 0 before
   each, the BMP's pixels equal to plain X2 of the plain decode; then the
   same five commands at 1920x1088 with ``--device cuda`` and ``--device
   cpu`` must write identical files;
6. the staged route (``compress_frame_to_streams`` and
   ``decompress_streams_to_frame`` with ``fused=False``, K3 -> K5 and
   K6 -> K4) on the CLI frame at q50, counts set to 0 before and read
   after: streams and planes identical to the fused route's;
7. the batched API on 8 x 1920x1088 (``compress_batch_to_streams``,
   ``compress_batch`` + ``decompress_batch``, ``roundtrip_batch``): each
   frame's streams equal ``compress_frame_to_streams`` of that frame and the
   planes the round trip's; then ``batch.roundtrip_step`` on the same batch,
   planes equal to the plain versions' and the symbol histogram to numpy's
   ``bincount`` of the plain coefficients;
8. every kernel was launched by the path that drives it: ``-to_yuv``
   launches X1 once, ``-rgb`` and ``-preview`` of the compressed file K2
   and X2 once each and nothing else;
9. times with CUDA events (median of 7; ``probe.cuda_ms``: back-to-back
   calls queued behind a busy card, so the wrappers' host work is left
   out): the six kernels against their plain versions on the CLI frame at
   q50, and the six kernels on phase 3's noise frame at q50 (the entropy
   kernels' slowest content); K3 and K4 also with the one-call timer of
   earlier runs (``probe.host_inclusive_ms``), which the plain versions of
   K1, K2, K5 and K6 take too (the plain decoder synchronises, and the
   plain encoder queues thousands of small launches), labelled
   host-inclusive; X1 and X2 on the CLI frame against their bound; staged
   against fused compress and decompress and end-to-end
   ``compress_dct``/``decompress_dct`` on the host clock; the 8 x 1080p
   ``roundtrip_batch`` (K2 decoding K1's lanes in place) beside the same
   round trip compacting first (the route before it), and
   ``roundtrip_step``;
10. capture, playback and streaming on the CLI frame, 32 frames, 4K q50:
    ``ingest_frame`` (X1 + K1) and ``preview_frame`` (K2 + X2) against the
    frame API and the plain versions, one launch of each kernel; the
    drivers of ``engine/streaming.py`` (``roundtrip_stream``,
    ``ingest_stream``, ``preview_stream``, ``compress_stream``) with flags,
    totals and bytes equal to the frame API's and 32 launches a kernel; the
    round trip and ingest drivers queue 16 frames behind a sleep kernel
    without the card running dry (no host sync); sustained round trip,
    ingest, preview and ``compress_stream`` fps on the host clock;
11. the transcode / RD path: (a) the 4K quality fuzz, q 1, 10, 35, 50, 75,
    90 and 100 on a 4032x3008 frame of each content kind: K1 against its
    plain version and ``roundtrip_frame``'s planes, total and ok against
    the plain round trip, then one ``roundtrip_scan`` a quality over the
    five frames (K = 5, one cached CUDA graph, each call's tables copied
    in) with totals and oks equal to the frames'; (b) on the CLI frame at
    q50, the first ``roundtrip_scan`` (K = 8: the capture, the graph's
    private pool measured around it), then ``sustained_scan_fps`` (K = 8,
    112 frames) beside ``sustained_roundtrip_fps`` (112 frames), the
    launches a replay makes, and the scan, its copy of the inputs, its
    replay, one ``roundtrip_frame``, K1 and K2 decoding K1's lanes in
    place timed with ``probe.cuda_ms``; (c)
    ``sweep.quality_sweep`` of the CLI frame at q 10, 30, 50, 70, 90: the
    K3 + K5 and K1 rate routes give the same bytes, PSNR and bytes rise
    with q, and the per-quality device rates.

It prints a JSON line with one entry per kernel (its launches on the path
that drives it, and as ``launches_scan`` and ``launches_sweep`` on phase
11's scans and untimed sweeps, counted from Python, which for the scans
is the warm body and the capture's record; ``scan_graph_launches``, the
launches a replay makes, and ``scan_replays``; max abs error against its
plain version, times on the CLI frame and, as ``noise_ms``, on the noise
frame, and the bound: the larger of the bytes it must move over 3.35 TB/s
and its float32 operations over 67 TFLOP/s, NVIDIA's H100 SXM figures; an
encoder's output counts the measured stream's chunk bytes, not the
256-byte lanes the port writes them into), the card's name and power limit
as ``nvidia-smi`` gives them, and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``myyuv_tpu_torch`` package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import re
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
BATCH = 8
QUALITIES = (50, 90)
REPS = 7
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOP_PER_S = 67e12          # H100 SXM float32, outside the tensor cores
DCT_FLOP = 2 * 64 * 15 + 64     # per block: two 8-term chains + (de)quantize
KERNELS = ("dct_encode", "decode_idct", "dct_quantize", "dequantize_idct",
           "huffman_encode", "huffman_decode", "bgrx_to_iyuv",
           "iyuv_to_bgrx")
# f32 operations a pixel: X1 3 products and 2 sums of the luma, 2
# differences and 2 products of the chroma; X2 4 products, 4 sums
CONVERT_FLOP = {"bgrx_to_iyuv": 9, "iyuv_to_bgrx": 8}
NSTREAM = 32
FUZZ_QUALITIES = (1, 10, 35, 50, 75, 90, 100)
KSCAN, NSCAN = 8, 112           # frames a scan, frames a sustained run
RD_QUALITIES = (10, 30, 50, 70, 90)
REPLACES = {
    "dct_encode": "myyuv_tpu/entropy/pallas_encode8.py:609",
    "decode_idct": "myyuv_tpu/entropy/pallas_decode8.py:189",
    "dct_quantize": "myyuv_tpu/kernels/pallas_dct8.py:256",
    "dequantize_idct": "myyuv_tpu/kernels/pallas_dct8.py:297",
    "huffman_encode": "myyuv_tpu/entropy/pallas_encode8.py:603",
    "huffman_decode": "myyuv_tpu/entropy/pallas_decode8.py:183+319",
    "bgrx_to_iyuv": "myyuv_tpu/kernels/device.py:232",
    "iyuv_to_bgrx": "myyuv_tpu/kernels/device.py:285",
}


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


def same(got, want, errs: dict, name: str, what: str) -> None:
    """Hold each tensor of ``got`` to ``want`` exactly; keep the largest
    absolute difference under ``errs[name]``."""
    for g, w_ in zip(got, want):
        errs[name] = max(errs[name], max_abs(g, w_))
        check(torch.equal(g, w_), what)


def bound_ms(nbytes: int, flops: int = 0):
    """(least time in ms, "bytes" or "operations") on an H100 SXM."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from myyuv_tpu_torch import cli
    from myyuv_tpu_torch.engine import (batch, device_stream, pipeline,
                                        streaming, sweep)
    from myyuv_tpu_torch.entropy import decode, encode
    from myyuv_tpu_torch.entropy import device as edev
    from myyuv_tpu_torch.formats import bmp, dct_stream, yuv
    from myyuv_tpu_torch.kernels import build, convert, probe, transform
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

    def reset_launches():
        for k in build.launches:
            build.launches[k] = 0

    t0 = time.perf_counter()
    logs = build.build_all(KERNELS)
    for name in KERNELS:
        build.load(name)
    print(f"[2 build] {len(KERNELS)} kernels for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in KERNELS:  # one report per kernel instance of the library
        log = logs.get(name, "")
        regs = re.findall(r"Used (\d+) registers", log)
        stack = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", log)
        print(f"[2 ptxas] {name}: "
              + ("; ".join(f"{r} registers, {s[0]} B stack, {s[1]}/{s[2]} "
                           f"B spill st/ld" for r, s in zip(regs, stack))
                 if regs and stack else "no report (library cached)"))
        check(all(st == ("0", "0", "0") for st in stack),
              f"{name} uses local memory: {stack}")

    errs = dict.fromkeys(KERNELS, 0)
    rng = np.random.default_rng(2026)
    probe_blocks = probe.contraction_probe_blocks()
    check(probe_blocks.shape[0] > 0, "no contraction-probe content found")
    streams = []
    for kind in probe.KINDS:
        y = probe.with_probe_blocks(
            probe.content_kind(rng, kind, (H4K, W4K)), probe_blocks)
        u = probe.content_kind(rng, kind, (H4K // 2, W4K // 2))
        v = probe.content_kind(rng, kind, (H4K // 2, W4K // 2))
        planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
        for q in QUALITIES:
            dct, qt = pipeline.codec_params([q] * 3, dev)
            tag = f"{kind} q{q}"
            got = encode.dct_encode_blocks(*planes, qt, dct)
            want = encode.dct_encode_blocks_plain(*planes, qt, dct)
            check(all(g.is_cuda for g in got), "K1 output not on the card")
            same(got, want, errs, "dct_encode", f"K1 differs: {tag}")
            check(not got[2].any(), f"K1 flagged a chunk: {tag}")
            coeffs = transform.dct_quantize_blocks(*planes, qt, dct)
            same([coeffs], [transform.dct_quantize_blocks_plain(
                *planes, qt, dct)], errs, "dct_quantize", f"K3 differs: {tag}")
            lanes5 = encode.encode_blocks(coeffs)
            same(lanes5, edev.encode_lanes(coeffs), errs, "huffman_encode",
                 f"K5 differs: {tag}")
            check(all(torch.equal(a, b) for a, b in zip(lanes5, got)),
                  f"K5(K3(x)) differs from K1(x): {tag}")
            streams.append((kind, q, planes, qt, dct, want[0], want[1],
                            coeffs))
            if kind == "noise" and q == 50:
                noise = (planes, qt, dct, coeffs)
    extremes = torch.from_numpy(rng.integers(-32768, 32768, (4096, 64))
                                .astype(np.int16)).to(dev)
    extremes[0], extremes[1], extremes[2] = 32767, -32768, -1024
    same(encode.encode_blocks(extremes), edev.encode_lanes(extremes), errs,
         "huffman_encode", "K5 differs on int16 extremes")
    families = probe.encoder_families(np.random.default_rng(7))
    for name, rows in families.items():
        rows = torch.from_numpy(rows).to(dev)
        same(encode.encode_blocks(rows), edev.encode_lanes(rows), errs,
             "huffman_encode", f"K5 differs on encoder family {name}")
    print(f"[3 K1/K3/K5 vs plain] {len(streams)} frames {W4K}x{H4K} "
          f"(kinds {','.join(probe.KINDS)}; "
          f"q{'/'.join(map(str, QUALITIES))}; "
          f"{probe_blocks.shape[0]} probe blocks): coefficients, bytes, "
          f"sizes, err identical; K5(K3(x)) == K1(x); K5 == plain on 4096 "
          f"int16-extreme blocks and on the {len(families)} encoder "
          f"families ({sum(len(r) for r in families.values())} rows); "
          f"max_abs_err K1 {errs['dct_encode']} "
          f"K3 {errs['dct_quantize']} K5 {errs['huffman_encode']}",
          flush=True)

    def conversions(planes, tag):
        """X2 on (y, u, v) and X1 on X2's pixels, each against its plain
        version."""
        bgrx = convert.iyuv_to_bgrx(*planes)
        same([bgrx], [kdev.iyuv_to_bgrx(*planes)], errs, "iyuv_to_bgrx",
             f"X2 differs from plain: {tag}")
        same(convert.bgrx_to_iyuv(bgrx), kdev.bgrx_to_iyuv(bgrx), errs,
             "bgrx_to_iyuv", f"X1 differs from plain: {tag}")

    for kind, q, planes, qt, dct, lanes, sizes, coeffs in streams:
        tag = f"{kind} q{q}"
        stream = device_stream.compact_chunks(lanes, sizes)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        got = decode.decode_idct_blocks(stream, sizes, offsets, qt, dct,
                                        H4K, W4K)
        same(got, decode.decode_idct_blocks_plain(
            stream, sizes, offsets, qt, dct, H4K, W4K), errs, "decode_idct",
            f"K2 differs from plain: {tag}")
        check(not got[3].any(), f"K2 rejected a valid stream: {tag}")
        k6 = decode.decode_blocks(stream, sizes, offsets)
        same(k6, decode.decode_blocks_plain(stream, sizes, offsets), errs,
             "huffman_decode", f"K6 differs from plain: {tag}")
        check(torch.equal(k6[0], coeffs), f"K6(K5(K3(x))) != K3(x): {tag}")
        k4 = transform.dequantize_idct_blocks(k6[0], qt, dct, H4K, W4K)
        same(k4, transform.dequantize_idct_blocks_plain(
            k6[0], qt, dct, H4K, W4K), errs, "dequantize_idct",
            f"K4 differs from plain: {tag}")
        check(all(torch.equal(a, b) for a, b in zip(k4, got)),
              f"K4(K6(s)) differs from K2(s): {tag}")
        conversions(got[:3], tag)
        if kind == "noise" and q == 50:
            bad_stream, bad_sizes = stream.clone(), sizes.clone()
            noise_stream = (stream, sizes, offsets)
    del streams
    offsets = torch.cumsum(bad_sizes, 0, dtype=torch.int64) - bad_sizes
    nb = bad_sizes.numel()
    corrupt = {7: (2, 255), nb // 284: (0, 0xFF), nb * 7 // 10: (3, 0xE0)}
    for b, (pos, val) in corrupt.items():
        bad_stream[offsets[b] + pos] = val
    short_b, outside_b = nb - 256, nb - 156
    bad_sizes[short_b] = 2
    offsets = torch.cumsum(bad_sizes, 0, dtype=torch.int64) - bad_sizes
    offsets[outside_b] = bad_stream.numel() + 100  # outside the content
    dct, qt = pipeline.codec_params([50] * 3, dev)
    got = decode.decode_idct_blocks(bad_stream, bad_sizes, offsets, qt, dct,
                                    H4K, W4K)
    same(got, decode.decode_idct_blocks_plain(
        bad_stream, bad_sizes, offsets, qt, dct, H4K, W4K), errs,
        "decode_idct", "K2 differs from plain on corrupt chunks")
    k6 = decode.decode_blocks(bad_stream, bad_sizes, offsets)
    same(k6, decode.decode_blocks_plain(bad_stream, bad_sizes, offsets),
         errs, "huffman_decode", "K6 differs from plain on corrupt chunks")
    check(torch.equal(k6[1], got[3]), "K6's codes differ from K2's")
    check(not k6[0][k6[1] != 0].any(), "K6 left a bad block nonzero")
    flagged = torch.nonzero(got[3]).flatten().tolist()
    check(7 in flagged and short_b in flagged and int(got[3][short_b]) == 1,
          f"corrupt chunks not flagged: {flagged[:10]}")
    dfam = probe.decoder_families(np.random.default_rng(7))
    fam_codes = set()
    layouts = [(name, arrays) for name, arrays in dfam.items()] + [
        (f"{name} back to back", probe.back_to_back(*arrays))
        for name, arrays in dfam.items()]
    for name, arrays in layouts:
        content, fsizes, foffsets = (torch.from_numpy(a).to(dev)
                                     for a in arrays)
        k6 = decode.decode_blocks(content, fsizes, foffsets)
        same(k6, decode.decode_blocks_plain(content, fsizes, foffsets), errs,
             "huffman_decode", f"K6 differs from plain on family {name}")
        check(not k6[0][k6[1] != 0].any(), f"K6 left a bad block nonzero: "
              f"{name}")
        n_f = fsizes.numel()
        fw = 16 * -(-n_f // 6)                 # 6 blocks per 16 x 16
        pad = transform.frame_blocks(16, fw) - n_f
        fsizes = torch.cat([fsizes, fsizes.new_zeros(pad)])
        foffsets = torch.cat([foffsets, foffsets.new_zeros(pad)])
        k2 = decode.decode_idct_blocks(content, fsizes, foffsets, qt, dct,
                                       16, fw)
        same(k2, decode.decode_idct_blocks_plain(
            content, fsizes, foffsets, qt, dct, 16, fw), errs,
            "decode_idct", f"K2 differs from plain on family {name}")
        check(torch.equal(k2[3][:n_f], k6[1]),
              f"K6's codes differ from K2's on family {name}")
        fam_codes |= set(k6[1].tolist())
    check(fam_codes == {0, 1, 2, 3, 4, 5, 7, 8},
          f"decoder families reached codes {sorted(fam_codes)}")
    print(f"[4 K2/K6/K4 vs plain] 10 streams: pixels, coefficients and err "
          f"identical; K4(K6(s)) == K2(s); corrupt chunks flagged alike by "
          f"K2, K6 and plain at blocks {flagged[:8]} (codes "
          f"{[int(got[3][b]) for b in flagged[:8]]}); K2 and K6 == plain "
          f"on the {len(dfam)} decoder families, with gaps and back to back "
          f"({sum(a[1].size for a in dfam.values())} chunks, codes "
          f"{sorted(fam_codes)}); max_abs_err K2 "
          f"{errs['decode_idct']} K6 {errs['huffman_decode']} K4 "
          f"{errs['dequantize_idct']}", flush=True)
    every = torch.from_numpy(probe.every_colour_bgrx(rng)).to(dev)
    same(convert.bgrx_to_iyuv(every), kdev.bgrx_to_iyuv(every), errs,
         "bgrx_to_iyuv", "X1 differs from plain on every colour")
    triples = [torch.from_numpy(p).to(dev) for p in probe.every_yuv_triple()]
    same([convert.iyuv_to_bgrx(*triples)], [kdev.iyuv_to_bgrx(*triples)],
         errs, "iyuv_to_bgrx", "X2 differs from plain on every triple")
    del every, triples
    print(f"[4 X1/X2 vs plain] X2 on the 10 decoded {W4K}x{H4K} frames and "
          f"X1 on its pixels, X1 on every 24-bit colour (4096x4096) and X2 "
          f"on every (Y, U, V) triple (4096x4096): identical; max_abs_err "
          f"X1 {errs['bgrx_to_iyuv']} X2 {errs['iyuv_to_bgrx']}",
          flush=True)

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def synthetic_bmp(h, w, path):
            px = probe.smooth_picture(rng, h, w)
            bmp.BMPImage.from_pixels(px).dump(path)
            return px

        def run_cli(*args):
            rc = cli.main([str(a) for a in args])
            check(rc == 0, f"CLI failed: {' '.join(map(str, args))}")

        px = synthetic_bmp(H4K, W4K, tmp / "f.bmp")
        reset_launches()
        t0 = time.perf_counter()
        run_cli(tmp / "f.bmp", "-to_yuv", "IYUV", "-o", tmp / "f.myyuv")
        run_cli(tmp / "f.myyuv", "-compress", "DCT", "50", "-o",
                tmp / "f-c.myyuv")
        run_cli(tmp / "f-c.myyuv", "-decompress", "-o", tmp / "f-d.myyuv")
        t_cli = time.perf_counter() - t0
        launches["main"] = dict(build.launches)

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
              f"ratio {ratio:.2f}x; launches {launches['main']}", flush=True)

        for op, out in (("rgb", "f-r.bmp"), ("preview", "f-p.txt")):
            reset_launches()
            run_cli(tmp / "f-c.myyuv", f"-{op}", "-o", tmp / out)
            launches[op] = dict(build.launches)
        rgb = bmp.BMPImage.load(tmp / "f-r.bmp").pixels_topdown()
        check(np.array_equal(rgb, kdev.iyuv_to_bgrx(ry, ru, rv).cpu().numpy()),
              "-rgb pixels differ from plain X2 of the plain decode")
        check((tmp / "f-p.txt").read_text().count("\n") > 10,
              "-preview wrote no picture")
        print(f"[5 main path] CLI -rgb/-preview --device cuda of the "
              f"compressed {W4K}x{H4K} file: BMP pixels == plain X2 of the "
              f"plain decode; launches -rgb {launches['rgb']}, -preview "
              f"{launches['preview']}", flush=True)

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
            run_cli(d / "c.myyuv", "-rgb", "-o", d / "r.bmp", "--device",
                    device)
            run_cli(d / "c.myyuv", "-preview", "-o", d / "p.txt", "--device",
                    device)
            files[device] = [(d / f).read_bytes() for f in (
                "a.myyuv", "c.myyuv", "d.myyuv", "r.bmp", "p.txt")]
        check(files["cuda"] == files["cpu"],
              "--device cuda and --device cpu files differ")
        print(f"[5 main path] {W1K}x{H1K}: --device cuda and --device cpu "
              f"write identical files (to_yuv, DCT 50, decompress, rgb, "
              f"preview)", flush=True)

    frame_np = img.planes()
    reset_launches()
    staged = device_stream.compress_frame_to_streams(frame_np, qt, dct,
                                                     fused=False)
    staged_planes = device_stream.decompress_streams_to_frame(
        staged, qt, dct, H4K, W4K, fused=False)
    launches["staged"] = dict(build.launches)
    for (gs, gc), (ws, wc) in zip(staged, plain):
        check(np.array_equal(gs, ws) and np.array_equal(gc, wc),
              "staged-route streams differ from the fused route's")
    for g, w_ in zip(staged_planes, dec.planes()):
        check(np.array_equal(g, w_),
              "staged-route planes differ from the fused route's")
    print(f"[6 staged route] compress_frame_to_streams / "
          f"decompress_streams_to_frame fused=False on {W4K}x{H4K} q50: "
          f"streams and planes == fused route; launches "
          f"{launches['staged']}", flush=True)

    kinds = [probe.KINDS[f % len(probe.KINDS)] for f in range(BATCH)]
    frames = [[probe.content_kind(rng, k, s) for s in
               ((H1K, W1K), (H1K // 2, W1K // 2), (H1K // 2, W1K // 2))]
              for k in kinds]
    stack = [np.stack([f[i] for f in frames]) for i in range(3)]
    bt = [torch.from_numpy(p).to(dev) for p in stack]
    reset_launches()
    per_frame = device_stream.compress_batch_to_streams(stack, qt, dct)
    bsizes, bcontent = device_stream.compress_batch(*bt, qt, dct)
    bdec = device_stream.decompress_batch(bcontent, bsizes, qt, dct, BATCH,
                                          H1K, W1K)
    (rby, rbu, rbv), btotal, bok = device_stream.roundtrip_batch(*bt, qt,
                                                                 dct)
    check(bool(bok), "roundtrip_batch reported a bad block")
    launches["batch"] = dict(build.launches)
    reset_launches()
    (sy, su, sv), metrics = batch.roundtrip_step(*bt, *qt, dct)
    torch.cuda.synchronize()
    launches["roundtrip_step"] = dict(build.launches)
    for f in range(BATCH):
        one = device_stream.compress_frame_to_streams(frames[f], qt, dct)
        for (gs, gc), (ws, wc) in zip(per_frame[f], one):
            check(np.array_equal(gs, ws) and np.array_equal(gc, wc),
                  f"batched streams of frame {f} differ from its own")
    for g, w_ in zip(bdec, (rby, rbu, rbv)):
        check(torch.equal(g, w_), "decompress_batch differs from the "
              "round trip")
    check(int(btotal) == bcontent.numel(), "roundtrip_batch total differs")
    tall = [p.view(-1, p.shape[-1]) for p in bt]
    pcoeffs = transform.dct_quantize_blocks_plain(*tall, qt, dct)
    pplanes = transform.dequantize_idct_blocks_plain(pcoeffs, qt, dct,
                                                     BATCH * H1K, W1K)
    for g, w_ in zip((sy, su, sv), pplanes):
        check(torch.equal(g.reshape(w_.shape), w_),
              "roundtrip_step planes differ from the plain versions'")
    sym = pcoeffs.cpu().numpy().astype(np.int32).ravel() + 1024
    counted = np.bincount(sym[(sym >= 0) & (sym < batch.NUM_SYMBOLS)],
                          minlength=batch.NUM_SYMBOLS)
    check(np.array_equal(metrics["symbol_hist"].cpu().numpy(), counted),
          "roundtrip_step histogram differs from numpy's count")
    for g, w_ in zip((sy, su, sv), (rby, rbu, rbv)):
        check(torch.equal(g, w_), "roundtrip_step planes differ from "
              "roundtrip_batch's")
    psnr_b = 10 * np.log10(255.0 ** 2 * stack[0].size
                           / max(float(metrics["sse_y"]), 1e-9))
    print(f"[7 batch] {BATCH} x {W1K}x{H1K} (kinds {','.join(kinds)}) q50: "
          f"per-frame streams == compress_frame_to_streams, "
          f"decompress_batch == roundtrip_batch planes, {int(btotal)} bytes; "
          f"roundtrip_step planes == plain, histogram == numpy's, PSNR-Y "
          f"{psnr_b:.2f} dB, entropy "
          f"{float(metrics['entropy_bits_per_symbol']):.4f} bits/symbol; "
          f"launches batch {launches['batch']}, roundtrip_step "
          f"{launches['roundtrip_step']}", flush=True)

    path_of = {"dct_encode": "main", "decode_idct": "main",
               "dct_quantize": "staged", "dequantize_idct": "staged",
               "huffman_encode": "staged", "huffman_decode": "staged",
               "bgrx_to_iyuv": "main", "iyuv_to_bgrx": "rgb"}
    for name, path in path_of.items():
        check(launches[path][name] > 0,
              f"{name} never launched on the {path} path: {launches[path]}")
    check(launches["main"]["bgrx_to_iyuv"] == 1,
          f"-to_yuv launched X1 {launches['main']['bgrx_to_iyuv']} times")
    for op in ("rgb", "preview"):
        want = dict.fromkeys(KERNELS, 0)
        want.update(decode_idct=1, iyuv_to_bgrx=1)
        check(launches[op] == want, f"-{op} launched {launches[op]}")
    for name in ("dct_encode", "decode_idct"):
        check(launches["batch"][name] > 0, f"batch path skipped {name}")
    for name in ("dct_quantize", "dequantize_idct"):
        check(launches["roundtrip_step"][name] > 0,
              f"roundtrip_step skipped {name}")
    print(f"[8 launches] main path {launches['main']}; staged route "
          f"{launches['staged']}; -rgb {launches['rgb']}; -preview "
          f"{launches['preview']}", flush=True)

    # kernel times on the CLI frame's planes, q50
    n = sum(kdev.plane_block_counts(H4K, W4K))
    npx = H4K * W4K * 3 // 2
    coeffs = transform.dct_quantize_blocks(*planes, qt, dct)
    tables = qt.numel() * 4 + dct.numel() * 4

    def queued(fn, reps):  # K3's and K4's plain versions: one call a reading
        return probe.cuda_ms(fn, reps, calls=1)

    px_dev = torch.from_numpy(px).to(dev)
    npix = H4K * W4K
    convert_bytes = npix * 4 + npix * 3 // 2  # BGRX one way, planes the other

    # kernel, plain version, the plain version's timer, bound
    runs = {
        "dct_encode": (
            lambda: encode.dct_encode_blocks(*planes, qt, dct),
            lambda: encode.dct_encode_blocks_plain(*planes, qt, dct),
            probe.host_inclusive_ms,
            bound_ms(npx + tables + stream.numel() + n * 8, n * DCT_FLOP)),
        "decode_idct": (
            lambda: decode.decode_idct_blocks(stream, sizes, offsets, qt,
                                              dct, H4K, W4K),
            lambda: decode.decode_idct_blocks_plain(stream, sizes, offsets,
                                                    qt, dct, H4K, W4K),
            probe.host_inclusive_ms,
            bound_ms(stream.numel() + n * 12 + tables + npx + n * 4,
                     n * DCT_FLOP)),
        "dct_quantize": (
            lambda: transform.dct_quantize_blocks(*planes, qt, dct),
            lambda: transform.dct_quantize_blocks_plain(*planes, qt, dct),
            queued, bound_ms(npx + tables + n * 128, n * DCT_FLOP)),
        "dequantize_idct": (
            lambda: transform.dequantize_idct_blocks(coeffs, qt, dct, H4K,
                                                     W4K),
            lambda: transform.dequantize_idct_blocks_plain(coeffs, qt, dct,
                                                           H4K, W4K),
            queued, bound_ms(n * 128 + tables + npx, n * DCT_FLOP)),
        "huffman_encode": (
            lambda: encode.encode_blocks(coeffs),
            lambda: edev.encode_lanes(coeffs),
            probe.host_inclusive_ms,
            bound_ms(n * 128 + stream.numel() + n * 8)),
        "huffman_decode": (
            lambda: decode.decode_blocks(stream, sizes, offsets),
            lambda: decode.decode_blocks_plain(stream, sizes, offsets),
            probe.host_inclusive_ms,
            bound_ms(stream.numel() + n * 12 + n * (128 + 4))),
        "bgrx_to_iyuv": (
            lambda: convert.bgrx_to_iyuv(px_dev),
            lambda: kdev.bgrx_to_iyuv(px_dev),
            probe.host_inclusive_ms, bound_ms(convert_bytes,
                             npix * CONVERT_FLOP["bgrx_to_iyuv"])),
        "iyuv_to_bgrx": (
            lambda: convert.iyuv_to_bgrx(*planes),
            lambda: kdev.iyuv_to_bgrx(*planes),
            probe.host_inclusive_ms, bound_ms(convert_bytes,
                             npix * CONVERT_FLOP["iyuv_to_bgrx"])),
    }
    one_call = {name: probe.host_inclusive_ms(runs[name][0], REPS)
                for name in ("dct_quantize", "dequantize_idct")}
    print(f"[9 times] {card} | {W4K}x{H4K} q50, median of {REPS}, the "
          f"one-call timer of earlier runs (host-inclusive): " + ", ".join(
              f"{name} {t:.4f} ms" for name, t in one_call.items()),
          flush=True)
    times = {name: (probe.cuda_ms(k, REPS), timer(p, REPS), b)
             for name, (k, p, timer, b) in runs.items()}
    print(f"[9 times] {card} | {W4K}x{H4K} q50, median of {REPS}, CUDA "
          f"events around calls queued behind a busy card: " + ", ".join(
              f"{name} {t:.4f} ms (plain {p:.4f}"
              f"{'' if runs[name][2] is queued else ' host-inclusive'}, "
              f"bound {b[0]:.4f} by {b[1]})"
              for name, (t, p, b) in times.items()), flush=True)
    nplanes, nqt, ndct, ncoeffs = noise
    nstream, nsizes, noffsets = noise_stream
    npx = convert.iyuv_to_bgrx(*nplanes)
    noise_runs = {
        "bgrx_to_iyuv": lambda: convert.bgrx_to_iyuv(npx),
        "iyuv_to_bgrx": lambda: convert.iyuv_to_bgrx(*nplanes),
        "dct_encode": lambda: encode.dct_encode_blocks(*nplanes, nqt, ndct),
        "decode_idct": lambda: decode.decode_idct_blocks(
            nstream, nsizes, noffsets, nqt, ndct, H4K, W4K),
        "dct_quantize": lambda: transform.dct_quantize_blocks(*nplanes, nqt,
                                                              ndct),
        "dequantize_idct": lambda: transform.dequantize_idct_blocks(
            ncoeffs, nqt, ndct, H4K, W4K),
        "huffman_encode": lambda: encode.encode_blocks(ncoeffs),
        "huffman_decode": lambda: decode.decode_blocks(nstream, nsizes,
                                                       noffsets),
    }
    noise_ms = {name: probe.cuda_ms(fn, REPS)
                for name, fn in noise_runs.items()}
    print(f"[9 times] {card} | phase 3's noise frame {W4K}x{H4K} q50 "
          f"({nstream.numel()} stream bytes), median of {REPS}, CUDA "
          f"events around calls queued behind a busy card: " + ", ".join(
              f"{name} {t:.4f} ms" for name, t in noise_ms.items()),
          flush=True)
    del noise, nplanes, ncoeffs, noise_stream, nstream, noise_runs, npx

    def fused_ms(fused):
        c = host_ms(lambda: device_stream.compress_frame(*planes, qt, dct,
                                                         fused=fused))
        d = host_ms(lambda: device_stream.decompress_frame(
            stream, sizes, qt, dct, H4K, W4K, fused=fused))
        return c, d

    fused_c, fused_d = fused_ms(True)
    staged_c, staged_d = fused_ms(False)
    e2e_c = host_ms(lambda: pipeline.compress_dct(img, bytes([50] * 3),
                                                  device=dev))
    e2e_d = host_ms(lambda: pipeline.decompress_dct(comp, device=dev))
    rt_ms = host_ms(lambda: device_stream.roundtrip_batch(*bt, qt, dct))

    def compacting_roundtrip():  # the round trip as it was: compact first
        y1, u1, v1 = device_stream.as_one_frame(*bt)
        csizes, ccontent, cerr = device_stream._encode(y1, u1, v1, qt, dct,
                                                       True)
        *_, derr = device_stream._decode(ccontent, csizes, qt, dct,
                                         BATCH * H1K, W1K, True)
        return ~(cerr.any() | derr.any())

    rt_compact_ms = host_ms(compacting_roundtrip)
    lanes4k, sizes4k, _ = encode.dct_encode_blocks(*planes, qt, dct)
    mask_ms = host_ms(lambda: device_stream.compact_chunks(lanes4k, sizes4k))
    scatter_ms = host_ms(lambda: device_stream.scatter_chunks(lanes4k,
                                                              sizes4k))
    del lanes4k
    step_ms = host_ms(lambda: batch.roundtrip_step(*bt, *qt, dct))
    print(f"[9 times] {card} | host clock, median of {REPS}: {W4K}x{H4K} "
          f"q50 compress_frame fused {fused_c:.3f} ms staged "
          f"{staged_c:.3f} ms; decompress_frame fused {fused_d:.3f} ms "
          f"staged {staged_d:.3f} ms; compress_dct {e2e_c:.3f} ms, "
          f"decompress_dct {e2e_d:.3f} ms [file in memory to file in "
          f"memory]; {BATCH} x {W1K}x{H1K} q50 roundtrip_batch "
          f"{rt_ms:.3f} ms ({BATCH * 1e3 / rt_ms:.1f} frames/s; the same "
          f"round trip compacting first {rt_compact_ms:.3f} ms); "
          f"roundtrip_step {step_ms:.3f} ms; compaction of the {W4K}x{H4K} "
          f"lanes: mask select {mask_ms:.3f} ms, scatter_chunks "
          f"{scatter_ms:.3f} ms", flush=True)

    # 10: capture, playback and the streaming drivers on the CLI frame
    reset_launches()
    isizes, icontent, itotal, iok = device_stream.ingest_frame(px_dev, qt,
                                                               dct)
    torch.cuda.synchronize()
    launches["ingest_frame"] = dict(build.launches)
    check(bool(iok) and torch.equal(isizes, sizes)
          and torch.equal(icontent[:int(itotal)], stream),
          "ingest_frame differs from X1 and the frame API")
    reset_launches()
    pbgrx, pok = device_stream.preview_frame(stream, sizes, qt, dct, H4K,
                                             W4K)
    torch.cuda.synchronize()
    launches["preview_frame"] = dict(build.launches)
    check(bool(pok) and torch.equal(pbgrx, kdev.iyuv_to_bgrx(ry, ru, rv)),
          "preview_frame differs from plain X2 of the plain decode")
    del isizes, icontent, pbgrx
    for step, pair in (("ingest_frame", ("bgrx_to_iyuv", "dct_encode")),
                       ("preview_frame", ("decode_idct", "iyuv_to_bgrx"))):
        want = dict.fromkeys(KERNELS, 0)
        want.update(dict.fromkeys(pair, 1))
        check(launches[step] == want, f"{step} launched {launches[step]}")

    reset_launches()
    ok_r, tot_r, _ = streaming.roundtrip_stream([planes] * NSTREAM, qt, dct)
    ok_i, tot_i, _ = streaming.ingest_stream([px_dev] * NSTREAM, qt, dct)
    ok_p, _ = streaming.preview_stream((stream, sizes), qt, dct, H4K, W4K,
                                       NSTREAM)
    n_cs = 0
    for st in streaming.compress_stream([planes] * NSTREAM, qt, dct):
        for (gs, gc), (ws, wc) in zip(st, plain):
            check(np.array_equal(gs, ws) and np.array_equal(gc, wc),
                  "compress_stream differs from the frame API")
        n_cs += 1
    launches["streaming"] = dict(build.launches)
    check(ok_r.all() and ok_i.all() and ok_p.all() and n_cs == NSTREAM,
          "a streaming driver reported a bad frame or dropped one")
    check((tot_r == stream.numel()).all() and (tot_i == stream.numel()).all(),
          "streamed totals differ from the frame API")
    want = dict.fromkeys(KERNELS, 0)
    want.update(dct_encode=3 * NSTREAM, decode_idct=2 * NSTREAM,
                bgrx_to_iyuv=NSTREAM, iyuv_to_bgrx=NSTREAM)
    check(launches["streaming"] == want,
          f"streaming launched {launches['streaming']}")
    for name, drive, item in (
            ("roundtrip_stream", streaming.roundtrip_stream, planes),
            ("ingest_stream", streaming.ingest_stream, px_dev)):
        check(not probe.card_ran_dry(lambda fs: drive(fs, qt, dct), item),
              f"{name} let the card run dry before its drain (host sync)")
    rt_fps, rt_ok, rt_total, rt_stats = streaming.sustained_roundtrip_fps(
        frame_np, qt, dct, n_frames=NSTREAM)
    in_fps, pv_fps, pipe_ok = streaming.sustained_pipeline_fps(
        frame_np, qt, dct, n_frames=NSTREAM)
    cs_fps, cs_total, cs_first = streaming.compress_stream_timed(
        frame_np, qt, dct, n_frames=NSTREAM)
    check(rt_ok and pipe_ok and rt_total == cs_total == stream.numel(),
          "a sustained run reported a bad frame or another size")
    for (gs, gc), (ws, wc) in zip(cs_first, plain):
        check(np.array_equal(gs, ws) and np.array_equal(gc, wc),
              "compress_stream_timed differs from the frame API")
    print(f"[10 capture/playback/streaming] {card} | {W4K}x{H4K} q50: "
          f"ingest_frame == X1 + compress_frame, preview_frame == plain X2 "
          f"of the plain decode (launches {launches['ingest_frame']}, "
          f"{launches['preview_frame']}); {NSTREAM} frames through "
          f"roundtrip_stream, ingest_stream, preview_stream, "
          f"compress_stream: flags all ok, totals and bytes == frame API, "
          f"launches {launches['streaming']}; round trip and ingest queue "
          f"16 frames behind a sleep kernel without running dry; sustained "
          f"(host clock, {NSTREAM} frames a window): round trip {rt_fps} "
          f"fps (windows {rt_stats['windows_fps']}), ingest {in_fps} fps, "
          f"preview {pv_fps} fps, compress_stream {cs_fps} fps", flush=True)

    # 11: the transcode / RD path. (a) the 4K quality fuzz: every frame
    # through roundtrip_frame against the plain round trip, and one scan a
    # quality over the five kinds against the frames
    def plain_roundtrip(y, u, v, qt_, dct_):
        lanes, lsizes, cerr = encode.dct_encode_blocks_plain(y, u, v, qt_,
                                                             dct_)
        offs = torch.arange(lsizes.numel(), dtype=torch.int64,
                            device=dev) * edev.LANE
        *rec, derr = decode.decode_idct_blocks_plain(
            lanes.view(-1), lsizes, offs, qt_, dct_, *y.shape)
        return ((lanes, lsizes, cerr), rec, int(lsizes.sum()),
                not bool(cerr.any() | derr.any()))

    frng = np.random.default_rng(11)
    fuzz = [[probe.content_kind(frng, kind, s) for s in
             ((H4K, W4K), (H4K // 2, W4K // 2), (H4K // 2, W4K // 2))]
            for kind in probe.KINDS]
    fstack = [torch.from_numpy(np.stack([f[i] for f in fuzz])).to(dev)
              for i in range(3)]
    del fuzz
    device_stream.clear_scan_graphs()
    fuzz_oks, fuzz_totals = [], []
    t0 = time.perf_counter()
    for q in FUZZ_QUALITIES:
        dct_q, qt_q = pipeline.codec_params([q] * 3, dev)
        totals_q, oks_q = [], []
        for i, kind in enumerate(probe.KINDS):
            frame_i = [p[i] for p in fstack]
            tag = f"fuzz {kind} q{q}"
            want_lanes, want_rec, want_total, want_ok = plain_roundtrip(
                *frame_i, qt_q, dct_q)
            same(encode.dct_encode_blocks(*frame_i, qt_q, dct_q), want_lanes,
                 errs, "dct_encode", f"K1 differs from plain: {tag}")
            *rec, total, ok = device_stream.roundtrip_frame(*frame_i, qt_q,
                                                            dct_q)
            same(rec, want_rec, errs, "decode_idct",
                 f"roundtrip_frame planes differ from plain: {tag}")
            check(int(total) == want_total and bool(ok) == want_ok,
                  f"roundtrip_frame total/ok differ from plain: {tag}")
            totals_q.append(want_total)
            oks_q.append(want_ok)
        s_totals, s_oks = device_stream.roundtrip_scan(*fstack, qt_q, dct_q)
        check(s_totals.tolist() == totals_q and s_oks.tolist() == oks_q,
              f"roundtrip_scan q{q} differs from the frames: "
              f"{s_totals.tolist()} {s_oks.tolist()} against {totals_q} "
              f"{oks_q}")
        fuzz_totals.append(totals_q)
        fuzz_oks += oks_q
    fuzz_graph = device_stream.scan_graph(len(probe.KINDS), H4K, W4K,
                                          fstack[0].device)
    check(fuzz_graph.replays == len(FUZZ_QUALITIES),
          f"the fuzz scans made {fuzz_graph.replays} graph replays")
    t_fuzz = time.perf_counter() - t0
    del fstack
    device_stream.clear_scan_graphs()
    print(f"[11a fuzz] {W4K}x{H4K}, q {FUZZ_QUALITIES} x kinds "
          f"{','.join(probe.KINDS)}: {len(fuzz_oks)} frames, K1 == plain "
          f"and roundtrip_frame planes, total and ok == the plain round "
          f"trip (ok False on {fuzz_oks.count(False)}); one roundtrip_scan "
          f"a quality (K = {len(probe.KINDS)}, {fuzz_graph.replays} "
          f"replays of one graph, tables copied in each call) == the "
          f"frames; totals by quality {fuzz_totals}; {t_fuzz:.1f} s; "
          f"max_abs_err K1 {errs['dct_encode']} K2 {errs['decode_idct']}",
          flush=True)

    # (b) sustained scans beside the streamed round trip, same frame; the
    # first scan captures the graph, its private pool measured around it
    stk = [p.expand(KSCAN, *p.shape).contiguous() for p in planes]
    graph = device_stream.scan_graph(KSCAN, H4K, W4K, stk[0].device)
    inputs_mb = sum(t.numel() for t in (graph.ys, graph.us, graph.vs)) / 1e6
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_reserved(dev)
    reset_launches()
    first_totals, first_oks = device_stream.roundtrip_scan(*stk, qt, dct)
    torch.cuda.empty_cache()
    pool_mb = (torch.cuda.memory_reserved(dev) - held0) / 1e6
    check(first_oks.all() and (first_totals == stream.numel()).all(),
          "the first scan differs from the frame API")
    check(graph.launches == {"dct_encode": KSCAN, "decode_idct": KSCAN},
          f"the capture recorded {graph.launches}")
    sc_fps, sc_ok, sc_total = streaming.sustained_scan_fps(
        frame_np, qt, dct, n_frames=NSCAN, k=KSCAN)
    launches["scan"] = dict(build.launches)
    scan_replays = graph.replays
    check(sc_ok and sc_total == stream.numel(),
          "sustained_scan_fps reported a bad frame or another size")
    # from Python: the warm body before the capture, then the capture's
    # record; the replays launch from the graph and add nothing
    want = dict.fromkeys(KERNELS, 0)
    want.update({k: 1 + n for k, n in graph.launches.items()})
    check(launches["scan"] == want, f"the scans launched {launches['scan']} "
          f"from Python")
    check(scan_replays == 2 + -(-NSCAN // KSCAN),
          f"the scans made {scan_replays} graph replays")
    rt_fps2, rt_ok2, rt_total2, _ = streaming.sustained_roundtrip_fps(
        frame_np, qt, dct, n_frames=NSCAN)
    check(rt_ok2 and rt_total2 == stream.numel(),
          "sustained_roundtrip_fps reported a bad frame or another size")
    lanes1, sizes1, _ = encode.dct_encode_blocks(*planes, qt, dct)
    in_place = torch.arange(sizes1.numel(), dtype=torch.int64,
                            device=dev) * edev.LANE
    scan_ms = {name: probe.cuda_ms(fn, REPS) for name, fn in (
        ("roundtrip_scan",
         lambda: device_stream.roundtrip_scan(*stk, qt, dct)),
        ("copy_in", lambda: graph.load(*stk, qt, dct)),
        ("replay", graph.replay),
        ("roundtrip_frame",
         lambda: device_stream.roundtrip_frame(*planes, qt, dct)),
        ("K1", lambda: encode.dct_encode_blocks(*planes, qt, dct)),
        ("K2 on K1's lanes", lambda: decode.decode_idct_blocks(
            lanes1.view(-1), sizes1, in_place, qt, dct, H4K, W4K)))}
    graph_launches = graph.launches
    del stk, lanes1, graph
    device_stream.clear_scan_graphs()
    print(f"[11b scan] {card} | {W4K}x{H4K} q50, K = {KSCAN}, {NSCAN} "
          f"frames, host clock: sustained_scan_fps {sc_fps} fps, "
          f"sustained_roundtrip_fps {rt_fps2} fps (same frame, same count); "
          f"launches from Python {launches['scan']} (the warm body and "
          f"the capture's record), a graph of {graph_launches} replayed "
          f"{scan_replays} times; the graph's "
          f"private pool {pool_mb:.1f} MB beside its {inputs_mb:.1f} MB of "
          f"inputs; CUDA events, calls queued behind a busy card, median of "
          f"{REPS}: "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in scan_ms.items())
          + f" ({scan_ms['roundtrip_scan'] / KSCAN:.4f} ms a frame in a "
          f"scan)", flush=True)

    # (c) the RD sweep on the CLI frame
    reset_launches()
    rd_coder = sweep.quality_sweep(frame_np, RD_QUALITIES, None, device=dev)
    rd_frame = sweep.quality_sweep(frame_np, RD_QUALITIES, "device",
                                   device=dev)
    launches["sweep"] = dict(build.launches)
    rd_timed = sweep.quality_sweep(frame_np, RD_QUALITIES, "device",
                                   time_device=True, device=dev)
    for c, f, t in zip(rd_coder, rd_frame, rd_timed):
        check(c["compressed_bytes"] == f["compressed_bytes"]
              == t["compressed_bytes"],
              f"the sweep's rate routes differ at q{c['quality']}")
        check({k: v for k, v in t.items() if not k.endswith("_fps")} == f,
              f"the timed sweep differs at q{c['quality']}")
        if c["quality"] == 50:
            check(c["compressed_bytes"] == stream.numel() + n + 3 * 8 + 12,
                  "the q50 sweep bytes differ from the plain stream's")
    for key in ("psnr_y_db", "psnr_u_db", "psnr_v_db", "compressed_bytes"):
        seq = [p[key] for p in rd_coder]
        check(seq == sorted(seq), f"{key} falls as the quality rises: {seq}")
    for path, names in (("scan", ("dct_encode", "decode_idct")),
                        ("sweep", ("dct_encode", "dct_quantize",
                                   "dequantize_idct", "huffman_encode"))):
        for name in names:
            check(launches[path][name] > 0,
                  f"{name} never launched on the {path} path: "
                  f"{launches[path]}")
    print(f"[11c sweep] {card} | {W4K}x{H4K} CLI frame, q {RD_QUALITIES}: "
          f"K3 + K5 bytes == K1 bytes (q50 == the plain stream's), PSNR "
          f"and bytes rise with q; launches of the two untimed sweeps "
          f"{launches['sweep']}; points (fps: encode_frame and "
          f"roundtrip_frame by probe.cuda_ms, decompress_frame "
          f"host-inclusive) {json.dumps(rd_timed)}", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"myyuv_tpu_torch/csrc/{name}.cu",
         "replaces": REPLACES[name],
         "launches": launches[path_of[name]][name],
         "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "noise_ms": noise_ms[name],
         "bound_ms": times[name][2][0], "bound_by": times[name][2][1],
         "library_ms": None,
         "launches_scan": launches["scan"][name],
         "scan_graph_launches": graph_launches.get(name, 0),
         "scan_replays": scan_replays,
         "launches_sweep": launches["sweep"][name]}
        for name in KERNELS]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
