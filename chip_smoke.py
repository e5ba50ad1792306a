#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``myyuv_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

It builds the seventeen CUDA kernels from ``myyuv_tpu_torch/csrc`` (nvcc, one
process per source, all at once), then, each phase printing one line and any
failure ending the run with a non-zero exit code:

1. environment: Python, torch, CUDA and nvcc versions, the card;
2. build of the seventeen kernels, timed, with ptxas's registers, stack
   frame and spills per kernel instance; all seventeen (the lane-group
   encoders K1 and K5, the warp decoders K2 and K6, the group transforms K3
   and K4, the fast transforms F1 and F2, the colour conversions X1 and
   X2, and T1-T7, the probes of the tools and the decoder's tree stage) must
   use no local memory (0-byte stack frame, no spills);
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
    with q, and the per-quality device rates;
12. the tool path (``myyuv_tpu_torch/tools/``, T1-T7), counts set to 0 just
    before and read just after each tool's check runs once on the card
    (``run``: ``exp_shuffle`` packs and unpacks a 3008x4032 plane through
    T1, ``exp_bcast`` T2, ``exp_r4lane`` T3's four ops, ``exp_fma`` counts
    T4's bare and fused forms against the rounded one (bare must equal
    rounded: ``-fmad=false`` holds), ``exp_r3stage`` T5 on a 4K smooth and
    a noise frame, ``exp_sublane`` T6 in both layouts, ``check_bitexact``
    K3, K4, X1, X2 and T7's chain against the host's double-rounded
    sequence), each holding its T kernel to its plain version bit for bit
    and returning the largest difference; then T5 also on phase 3's ten
    streams and on the decoder families, with its codes equal to K6's tree
    codes (1..4, else 0); the decoders' stage split
    (``exp_r3stage.stage_split``: T5, K6, K4, K2, and payload = K6 - T5,
    IDCT = K2 - K6, derived) on the CLI frame and phase 3's noise frame;
    each T kernel's time beside its plain version's, the PyTorch call that
    computes it (T1-T4) and its bound (``tools/common.py::times``: each call
    reads its inputs from device memory, not from the L2);
13. the multi-device path, every run with the counts set to 0 just before
    and read just after: (a) ``compress_frame_sharded`` and
    ``decompress_frame_sharded`` of the CLI frame and phase 3's noise frame
    (4032x3008 q50) on meshes of 1, 2, 4 (as (2, 2)) and 8 shards of the
    card, and on a mesh of every card where there are several: streams
    equal to ``compress_frame_to_streams``, planes to
    ``decompress_streams_to_frame``, K1 and K2 launched once a shard; (b)
    ``compress_batch_sharded`` and ``make_sharded_roundtrip`` on a (4, 2)
    mesh over 8 x 1920x1088: streams and planes equal to the single-device
    batch API, the histogram to ``roundtrip_step``'s and the SSE to rtol
    1e-6; (c) two processes sharing the card in a gloo group (this script
    with ``--gloo-worker``), each coding 4 of the 8 frames over a (2, 1)
    mesh: both assemble (b)'s streams; (d) ``entry.dryrun_multichip(8)``;
    (e) host-clock times of the sharded compress and decompress at 4K over
    1, 2, 4 and 8 shards beside the single-device functions;
14. the ``-cube`` viewer: ``-cube -frames 4 -shapes 8 -fly`` at 1000x800
    through the CLI with ``--device cuda`` and ``--device cpu``, the frames
    held to a share of 1e-3 differing pixels, and the wall time a frame;
15. ``precision="fast"`` (F1 ``fast_dct_quantize.cu``, F2
    ``fast_dequantize_idct.cu``): (a) F1 and F2 on the CLI and noise 4K
    frames at q 10, 50 and 90 equal to their plain versions (the same FMA
    chains) and within +-1 of K3 / K4 (on noise, shares differing <= 1e-3
    for coefficients, <= 1e-4 for pixels), and the plain F1 identical with
    ``allow_tf32`` True and False; (c)
    the fast main path, ``compress_dct`` and ``decompress_dct`` with
    ``precision="fast"`` of the CLI image at q 10, 50, 90 (counts set to 0
    before the q50 pair and read after: F1, K5, K6, F2 once each, nothing
    else), the file's coefficients equal to plain F1's and its pixels to
    plain F2 of them, PSNR within 0.05 dB of exact; (d) the fast
    ``roundtrip_batch`` on 8 x 1920x1088 equal to F2(F1(x)) and to
    ``roundtrip_step``'s; (e) a fast ``roundtrip_scan`` at K = 8 (a graph
    of 8 launches of each of F1, K5, K6, F2); (f) the fast sweep (both rate
    routes equal, PSNR within 0.05 dB of the exact sweep); (g)
    ``compress_frame_sharded`` / ``decompress_frame_sharded`` on two shards
    of the card equal to the frame API; (h) F1 and F2 timed beside K3 and
    K4, warm and on inputs in device memory (``tools/common.py::cold``),
    with the four kernels' ptxas registers and stack beside the card's
    name and power limit, their plain versions and the ``torch.matmul``
    formulation with TF32 off (the ``library_ms`` of the two entries), and
    the fast routes beside the exact ones on the host clock.

It prints a JSON line with one entry per kernel (its launches on the path
that drives it -- for F1 and F2 phase 15 (c)'s q50 pair, with
``launches_batch``, ``launches_sweep`` and ``launches_sharded`` from (d),
(f) and (g), ``share_differing_from_exact`` (from K3 / K4) from (a) and
``library_ms`` the ``torch.matmul`` formulation; for T1-T7 the tool path
of phase 12, with the entry's times summed over a tool's variants (T3's four ops, T4's three forms, T6's
two layouts) and each variant's under ``variants`` -- and as ``launches_scan`` and ``launches_sweep`` on phase
11's scans and untimed sweeps, counted from Python, which for the scans
is the warm body and the capture's record; ``scan_graph_launches``, the
launches a replay makes, and ``scan_replays``; for K1-K4
``launches_sharded``, counted on phase 13 (a) and (b); max abs error
against its plain version, times on the CLI frame and, as ``noise_ms``, on the noise
frame, and the bound: the larger of the bytes it must move over 3.35 TB/s
and its float32 operations over 67 TFLOP/s, NVIDIA's H100 SXM figures (T6:
the integer operations its chains need over the SMs' integer issue rate,
33.4e12 a second, ``tools/common.py``); an
encoder's output counts the measured stream's chunk bytes, not the
256-byte lanes the port writes them into), the card's name and power limit
as ``nvidia-smi`` gives them, and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``myyuv_tpu_torch`` package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import hashlib
import json
import re
import socket
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
DCT_FLOP = 2 * 64 * 15 + 64     # per block: two 8-term chains + (de)quantize
KERNELS = ("dct_encode", "decode_idct", "dct_quantize", "dequantize_idct",
           "huffman_encode", "huffman_decode", "bgrx_to_iyuv",
           "iyuv_to_bgrx")
# T1-T7, in the order of the table of TPU kernels (PERF.md)
PROBES = ("lane_shuffle", "bcast_mul", "lane_probes", "fma_probe",
          "huffman_tree", "consume_chain", "dct_chain")
# F1, F2: the transforms of precision="fast" (phase 15)
FAST = ("fast_dct_quantize", "fast_dequantize_idct")
ALL = KERNELS + PROBES + FAST
# the kernels of the multi-device path (phase 13)
SHARDED = ("dct_encode", "decode_idct", "dct_quantize", "dequantize_idct")
# f32 operations a pixel: X1 3 products and 2 sums of the luma, 2
# differences and 2 products of the chroma; X2 4 products, 4 sums
CONVERT_FLOP = {"bgrx_to_iyuv": 9, "iyuv_to_bgrx": 8}
NSTREAM = 32
FUZZ_QUALITIES = (1, 10, 35, 50, 75, 90, 100)
KSCAN, NSCAN = 8, 112           # frames a scan, frames a sustained run
RD_QUALITIES = (10, 30, 50, 70, 90)
CUBE_FRAMES = 4
CUBE_SHARE = 1e-3   # share of -cube pixels that may differ, card vs CPU
# precision="fast": F1 and F2 equal their plain versions (the same FMA
# chains); within +-1 of K3's coefficients and K4's pixels, on noise in at
# most these shares of them (tests/test_torch_fast.py gives the reason);
# PSNR within FAST_PSNR_DB of exact
FAST_QUALITIES = (10, 50, 90)
FAST_COEF_SHARE, FAST_PIXEL_SHARE, FAST_PSNR_DB = 1e-3, 1e-4, 0.05
REPLACES = {
    "dct_encode": "myyuv_tpu/entropy/pallas_encode8.py:609",
    "decode_idct": "myyuv_tpu/entropy/pallas_decode8.py:189",
    "dct_quantize": "myyuv_tpu/kernels/pallas_dct8.py:256",
    "dequantize_idct": "myyuv_tpu/kernels/pallas_dct8.py:297",
    "huffman_encode": "myyuv_tpu/entropy/pallas_encode8.py:603",
    "huffman_decode": "myyuv_tpu/entropy/pallas_decode8.py:183+319",
    "bgrx_to_iyuv": "myyuv_tpu/kernels/device.py:232",
    "iyuv_to_bgrx": "myyuv_tpu/kernels/device.py:285",
    "lane_shuffle": "tools/exp_shuffle.py:91",
    "bcast_mul": "tools/exp_bcast.py:31",
    "lane_probes": "tools/exp_r4lane.py:100",
    "fma_probe": "tools/exp_fma.py:50",
    "huffman_tree": "tools/exp_r3stage.py:107",
    "consume_chain": "tools/exp_sublane.py:84",
    "dct_chain": "tools/check_tpu_bitexact.py:94",
    # no Pallas kernel: XLA einsums of the fast path
    "fast_dct_quantize": "myyuv_tpu/kernels/device.py:158",
    "fast_dequantize_idct": "myyuv_tpu/kernels/device.py:188",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


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
    from myyuv_tpu_torch.tools import common
    from myyuv_tpu_torch.tools.common import bound_ms

    dev = torch.device("cuda")
    card = common.card()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(card, flush=True)

    t0 = time.perf_counter()
    logs = build.build_all(ALL)
    ptxas = {}
    for name in ALL:
        build.load(name)
    print(f"[2 build] {len(ALL)} kernels for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in ALL:  # one report per kernel instance of the library
        log = logs.get(name, "")
        regs = re.findall(r"Used (\d+) registers", log)
        stack = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", log)
        ptxas[name] = ("; ".join(f"{r} registers, {s[0]} B stack, "
                                 f"{s[1]}/{s[2]} B spill st/ld"
                                 for r, s in zip(regs, stack))
                       if regs and stack else "no report (library cached)")
        print(f"[2 ptxas] {name}: {ptxas[name]}")
        check(all(st == ("0", "0", "0") for st in stack),
              f"{name} uses local memory: {stack}")

    errs = dict.fromkeys(ALL, 0)
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

    tree_streams = []  # T5's inputs in phase 12
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
        tree_streams.append((tag, stream, sizes, offsets, k6[1]))
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
        want = dict.fromkeys(ALL, 0)
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
    noise_planes = nplanes  # phase 12's stage split
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
        want = dict.fromkeys(ALL, 0)
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
    want = dict.fromkeys(ALL, 0)
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
    want = dict.fromkeys(ALL, 0)
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

    # 12: the tool path (T1-T7). Counts from the tools' checks alone, which
    # hold each T kernel to its plain version on the tools' inputs; T5 is
    # then held on phase 3's streams and the decoder families too
    from myyuv_tpu_torch.tools import (check_bitexact, exp_bcast, exp_fma,
                                       exp_r3stage, exp_r4lane, exp_shuffle,
                                       exp_sublane)
    tools = {"lane_shuffle": exp_shuffle, "bcast_mul": exp_bcast,
             "lane_probes": exp_r4lane, "fma_probe": exp_fma,
             "huffman_tree": exp_r3stage, "consume_chain": exp_sublane,
             "dct_chain": check_bitexact}
    t0 = time.perf_counter()
    reset_launches()
    ran = {name: mod.run(dev) for name, mod in tools.items()}
    torch.cuda.synchronize()
    launches["tools"] = dict(build.launches)
    for name in PROBES:
        check(launches["tools"][name] > 0,
              f"{name} never launched on the tool path: {launches['tools']}")
    fma = ran["fma_probe"]
    check(ran["lane_shuffle"]["pack_exact"]
          and ran["lane_shuffle"]["unpack_exact"], "exp_shuffle failed")
    check(ran["bcast_mul"]["exact"], "exp_bcast failed")
    check(all(ran["lane_probes"]["exact"].values()), "exp_r4lane failed")
    check(fma["bare_vs_rounded"] == 0 and fma["bare_equals_host"],
          f"T4: nvcc contracted the bare form under the build flags: {fma}")
    check(fma["fused_vs_rounded"] > 0 and all(fma["plain_exact"].values()),
          f"T4 differs from its plain versions: {fma}")
    check(all(ran["huffman_tree"][f]["exact"]
              and ran["huffman_tree"][f]["codes_agree"]
              for f in ("cli", "noise")), "exp_r3stage failed")
    check(ran["consume_chain"]["exact"]
          and ran["consume_chain"]["layouts_equal"], "exp_sublane failed")
    check(not ran["dct_chain"]["failed"],
          f"check_bitexact failed: {ran['dct_chain']['failed']}")

    for name in PROBES:  # each tool's run held its kernel to its plain version
        errs[name] = ran[name]["max_abs_err"]
        check(errs[name] == 0, f"{name} differs from its plain version")
    for tag, st, sz, offs, k6err in tree_streams:
        tree = decode.parse_trees(st, sz, offs)
        same(tree, decode.parse_trees_plain(st, sz, offs), errs,
             "huffman_tree", f"T5 differs from plain: {tag}")
        check(exp_r3stage.tree_codes_agree(tree[2], k6err),
              f"T5's codes differ from K6's: {tag}")
    for name, arrays in layouts:
        content, fsizes, foffsets = (torch.from_numpy(a).to(dev)
                                     for a in arrays)
        tree = decode.parse_trees(content, fsizes, foffsets)
        same(tree, decode.parse_trees_plain(content, fsizes, foffsets), errs,
             "huffman_tree", f"T5 differs from plain on family {name}")
        check(exp_r3stage.tree_codes_agree(tree[2], decode.decode_blocks(
            content, fsizes, foffsets)[1]),
            f"T5's codes differ from K6's on family {name}")
    t_checks = time.perf_counter() - t0
    print(f"[12 tool path] T1-T7 through the tools' checks: {W4K}x{H4K} "
          f"pack/unpack (T1), [64, 256] scale (T2), [512, 8192] lane ops "
          f"(T3), a * b + c on {exp_fma.N} elements: bare vs rounded "
          f"{fma['bare_vs_rounded']}, fused vs rounded "
          f"{fma['fused_vs_rounded']}, bare == host {fma['bare_equals_host']}"
          f" (T4), T5 on 4K smooth and noise frames, {exp_sublane.NBLOCKS} "
          f"chains in both layouts (T6), K3/K4/X1/X2 and T7's chain == the "
          f"host's double-rounded sequence ({ran['dct_chain']['probe_blocks']}"
          f" contraction-probe blocks); launches {launches['tools']}; each T "
          f"kernel == plain bit for bit, T5 also on the {len(tree_streams)} "
          f"phase-3 streams and the decoder families (codes == K6's tree "
          f"codes); {t_checks:.1f} s; max_abs_err "
          + ", ".join(f"{k} {errs[k]}" for k in PROBES), flush=True)

    split = {"cli": exp_r3stage.stage_split(planes, qt, dct),
             "noise": exp_r3stage.stage_split(noise_planes, qt, dct)}
    for frame, t in split.items():
        print(f"[12 stage split] {card} | {frame} frame {W4K}x{H4K} q50 "
              f"({t['stream_bytes']} stream bytes), ms: compress_frame "
              f"{t['compress_frame_host_incl']:.4f} (host-inclusive) = K1 "
              f"{t['K1']:.4f} (K3 {t['K3']:.4f} + K5 {t['K5']:.4f} staged) "
              f"+ compaction {t['compaction_host_incl']:.4f} "
              f"(host-inclusive); decompress_frame "
              f"{t['decompress_frame_host_incl']:.4f} (host-inclusive): K2 "
              f"{t['K2']:.4f} = K6 {t['K6']:.4f} + IDCT "
              f"{t['derived_idct']:.4f} (derived, K2 - K6); K6 = tree T5 "
              f"{t['T5']:.4f} (bound {t['T5_row']['bound_ms']:.4f}; its "
              f"tables' write alone {t['T5_tables_write']:.4f}, so the parse >= "
              f"{t['derived_tree_parse']:.4f}, derived) + payload "
              f"{t['derived_payload']:.4f} (derived, K6 - T5); K4 alone "
              f"{t['K4']:.4f}", flush=True)
    probe_times = {name: tools[name].times(dev) for name in PROBES
                   if name != "huffman_tree"}
    probe_times["huffman_tree"] = {"huffman_tree": split["cli"]["T5_row"]}

    def summed(name):
        """A T kernel's times, summed over its variants."""
        parts = {k: v for k, v in probe_times[name].items()
                 if isinstance(v, dict)}
        total = {key: sum(p[key] for p in parts.values())
                 for key in ("ms", "plain_ms", "bound_ms")}
        lib = [p["library_ms"] for p in parts.values()]
        total["library_ms"] = None if None in lib else sum(lib)
        total["bound_by"] = next(iter(parts.values()))["bound_by"]
        total["variants"] = probe_times[name]
        return total

    probe_sum = {name: summed(name) for name in PROBES}
    probe_sum["huffman_tree"]["noise_ms"] = split["noise"]["T5_row"]["ms"]
    def ms4(t):
        return "none" if t is None else f"{t:.4f}"

    print(f"[12 times] {card} | CUDA events around calls queued behind a "
          f"busy card, median of {REPS}, on inputs in device memory, not in "
          f"the L2 (the plain versions of T5 and T6 host-inclusive): "
          + "; ".join(
              f"{name} {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
              f"library {ms4(t['library_ms'])}, bound {t['bound_ms']:.4f} "
              f"by {t['bound_by']})" for name, t in probe_sum.items())
          + f"; T1's pack {probe_times['lane_shuffle']['pack_ms']:.4f} ms, "
          f"unpack {probe_times['lane_shuffle']['unpack_ms']:.4f} ms",
          flush=True)

    sharded_counts = multi_device(
        dev, card, {"cli": frame_np,
                    "noise": [p.cpu().numpy() for p in noise_planes]},
        stack)
    cube_viewer(card, px)
    fast = fast_path(dev, card, img, planes, noise_planes, stack, rd_coder,
                     ptxas)

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
         "launches_sweep": launches["sweep"][name],
         **({"launches_sharded": sharded_counts[name]}
            if name in SHARDED else {})}
        for name in KERNELS] + [
        {"name": name, "route": "cuda",
         "source": f"myyuv_tpu_torch/csrc/{name}.cu",
         "replaces": REPLACES[name],
         "launches": launches["tools"][name],
         "max_abs_err": errs[name], **probe_sum[name]}
        for name in PROBES] + [
        {"name": name, "route": "cuda",
         "source": f"myyuv_tpu_torch/csrc/{name}.cu",
         "replaces": REPLACES[name], **fast[name]}
        for name in FAST]}))
    print(common.card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def reset_launches() -> None:
    from myyuv_tpu_torch.kernels import build
    for k in build.launches:
        build.launches[k] = 0


def multi_device(dev, card: str, frames4k: dict, stack) -> dict:
    """Phase 13: the multi-device path on meshes of the card ``dev``
    repeated (and of every card, where there are several), held to the
    single-device path; ``frames4k`` holds the CLI and noise frames'
    numpy planes (4032x3008), ``stack`` the 8 x 1920x1088 batch's. Returns
    the launches of (a) and (b) by kernel."""
    from myyuv_tpu_torch import entry
    from myyuv_tpu_torch.engine import batch, device_stream, pipeline
    from myyuv_tpu_torch.engine import sharded_stream
    from myyuv_tpu_torch.kernels import build
    from myyuv_tpu_torch.parallel import mesh as meshlib
    bt = [torch.from_numpy(p).to(dev) for p in stack]
    frame_np = frames4k["cli"]
    dct50, qt50 = pipeline.codec_params([50] * 3, dev)
    qts50 = list(qt50.cpu().numpy())
    meshes = {f"{r}x{c}": meshlib.make_mesh((r, c), [dev] * (r * c))
              for r, c in ((1, 1), (2, 1), (2, 2), (8, 1))}
    if torch.cuda.device_count() > 1:
        meshes["cards"] = meshlib.make_mesh()
    sharded_counts = dict.fromkeys(ALL, 0)

    def counted(fn, want, what):
        """fn() with the counts set to 0 just before and read just after;
        each kernel of ``want`` must have launched that many times."""
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(build.launches)
        for name, n in want.items():
            check(got[name] == n, f"{what}: {name} launched {got[name]} "
                  f"times, want {n}")
        for k, v in got.items():
            sharded_counts[k] += v
        return out

    wants = {}
    for fname, fr in frames4k.items():
        want = wants[fname] = device_stream.compress_frame_to_streams(
            fr, qt50, dct50)
        ref = device_stream.decompress_streams_to_frame(want, qt50, dct50,
                                                        H4K, W4K)
        for mname, mesh in meshes.items():
            tag = f"{fname} frame on the {mname} mesh"
            got = counted(lambda: sharded_stream.compress_frame_sharded(
                mesh, fr, qts50), {"dct_encode": mesh.size}, tag)
            for (gs, gc), (ws, wc) in zip(got, want):
                check(np.array_equal(gs, ws) and np.array_equal(gc, wc),
                      f"sharded streams differ: {tag}")
            rec = counted(lambda: sharded_stream.decompress_frame_sharded(
                mesh, got, qts50, H4K, W4K), {"decode_idct": mesh.size}, tag)
            for g, w_ in zip(rec, ref):
                check(np.array_equal(g, w_), f"sharded planes differ: {tag}")
    shards = ", ".join(f"{k} ({m.size} shards)" for k, m in meshes.items())
    print(f"[13a sharded frame] {W4K}x{H4K} q50, CLI and noise frames, "
          f"meshes {shards}: streams == compress_frame_to_streams, planes == "
          f"decompress_streams_to_frame, K1 and K2 once a shard", flush=True)

    mesh42 = meshlib.make_mesh((4, 2), [dev] * 8)
    bframes = counted(lambda: sharded_stream.compress_batch_sharded(
        mesh42, stack, qts50), {"dct_encode": BATCH * 8}, "batch (4, 2)")
    bplanes = [counted(lambda: sharded_stream.decompress_frame_sharded(
        mesh42, bframes[f], qts50, H1K, W1K), {"decode_idct": 8},
        f"batch frame {f}") for f in range(BATCH)]
    one = device_stream.compress_batch_to_streams(stack, qt50, dct50)
    bs, bc = device_stream.compress_batch(*bt, qt50, dct50)
    ones = device_stream.decompress_batch(bc, bs, qt50, dct50, BATCH, H1K,
                                          W1K)
    for f in range(BATCH):
        for (gs, gc), (ws, wc) in zip(bframes[f], one[f]):
            check(np.array_equal(gs, ws) and np.array_equal(gc, wc),
                  f"compress_batch_sharded differs at frame {f}")
        for g, w_ in zip(bplanes[f], ones):
            check(np.array_equal(g, w_[f].cpu().numpy()),
                  f"sharded decode differs at batch frame {f}")
    step = batch.make_sharded_roundtrip(mesh42)
    (sy, su, sv), sm = counted(lambda: step(*bt, *qt50, dct50),
                               {"dct_quantize": 8, "dequantize_idct": 8},
                               "make_sharded_roundtrip")
    (uy, uu, uv), um = batch.roundtrip_step(*bt, *qt50, dct50)
    for g, w_ in zip((sy, su, sv), (uy, uu, uv)):
        check(torch.equal(g, w_), "make_sharded_roundtrip planes differ")
    check(torch.equal(sm["symbol_hist"], um["symbol_hist"]),
          "make_sharded_roundtrip histogram differs")
    sse_rel = max(abs(float(sm[k]) - float(um[k])) / max(float(um[k]), 1.0)
                  for k in ("sse_y", "sse_u", "sse_v"))
    check(sse_rel <= 1e-6, f"sharded SSE off by {sse_rel:.3g} (rtol 1e-6)")
    print(f"[13b sharded batch] {BATCH} x {W1K}x{H1K} q50 on the (4, 2) "
          f"mesh: compress_batch_sharded streams == compress_batch_to_streams"
          f", decompress_frame_sharded planes == decompress_batch; "
          f"make_sharded_roundtrip planes and histogram == roundtrip_step, "
          f"SSE within {sse_rel:.3g} (rtol 1e-6: float32 sums shard by "
          f"shard); launches (a) + (b) {sharded_counts}", flush=True)

    blob = hashlib.sha256(b"".join(bytes(c) + bytes(s) for streams in bframes
                                   for s, c in streams)).hexdigest()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "batch.npz"
        np.savez(path, *stack)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--gloo-worker",
             str(port), str(rank), str(path), str(dev)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for rank in range(2)]
        outs = []
        try:
            for proc in procs:
                out, err = proc.communicate(timeout=300)
                check(proc.returncode == 0, f"gloo worker failed: "
                      f"{err[-3000:]}")
                outs.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
    for o in outs:
        check(o["sha"] == blob and o["n_frames"] == BATCH,
              f"process {o['rank']} assembled other streams than (b)")
        check(o["dct_encode"] == 4 * 2, f"process {o['rank']} launched K1 "
              f"{o['dct_encode']} times, want 8")
    print(f"[13c two processes] gloo, {dev} shared, each "
          f"compress_batch_sharded on frames {[o['local'] for o in outs]} "
          f"over a (2, 1) mesh: both assemble the {BATCH} frames' streams "
          f"of (b) (sha256 {blob[:16]}); K1 launches "
          f"{[o['dct_encode'] for o in outs]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    dry = entry.dryrun_multichip(8, dev.type)
    print(f"[13d dryrun_multichip(8)] {dry}", flush=True)

    def sharded_times(mesh):
        fr = frames4k["cli"]
        streams = sharded_stream.compress_frame_sharded(mesh, fr, qts50)
        return (host_ms(lambda: sharded_stream.compress_frame_sharded(
                    mesh, fr, qts50)),
                host_ms(lambda: sharded_stream.decompress_frame_sharded(
                    mesh, streams, qts50, H4K, W4K)))

    single = (host_ms(lambda: device_stream.compress_frame_to_streams(
                  frame_np, qt50, dct50)),
              host_ms(lambda: device_stream.decompress_streams_to_frame(
                  wants["cli"], qt50, dct50, H4K, W4K)))
    shard_ms = {k: sharded_times(meshes[k])
                for k in ("1x1", "2x1", "2x2", "8x1")}
    print(f"[13e times] {card} | host clock, median of {REPS}, CLI frame "
          f"{W4K}x{H4K} q50, numpy planes to streams and back: single-device "
          f"compress_frame_to_streams {single[0]:.3f} ms, "
          f"decompress_streams_to_frame {single[1]:.3f} ms; sharded compress "
          f"/ decompress on the card repeated: " + ", ".join(
              f"{k.replace('x', ' x ')} {c:.3f} / {d:.3f} ms"
              for k, (c, d) in shard_ms.items()), flush=True)

    return sharded_counts


def cube_viewer(card: str, px: np.ndarray) -> None:
    """Phase 14: the -cube viewer at the reference's 1000x800 with the
    BGRX picture ``px`` as its texture, card against CPU."""
    from myyuv_tpu_torch import cli
    from myyuv_tpu_torch.formats import bmp
    from myyuv_tpu_torch.viewer import cube

    def run_cli(*args):
        rc = cli.main([str(a) for a in args])
        check(rc == 0, f"CLI failed: {' '.join(map(str, args))}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        bmp.BMPImage.from_pixels(px).dump(tmp / "t.bmp")
        cube_s, cube_frames = {}, {}
        for device in ("cuda", "cuda", "cpu"):  # the first cuda run warms up
            t0 = time.perf_counter()
            run_cli(tmp / "t.bmp", "-cube", "-frames", CUBE_FRAMES,
                    "-shapes", 8, "-fly", "-size", 0, "-o", tmp / device,
                    "--device", device)
            cube_s[device] = time.perf_counter() - t0
            cube_frames[device] = [
                bmp.BMPImage.load(f).pixels_topdown()
                for f in sorted((tmp / device).glob("frame_*.bmp"))]
    check(len(cube_frames["cuda"]) == len(cube_frames["cpu"]) == CUBE_FRAMES,
          "-cube wrote the wrong number of frames")
    differ = sum(int((a != b).any(-1).sum())
                 for a, b in zip(cube_frames["cuda"], cube_frames["cpu"]))
    total = sum(a.shape[0] * a.shape[1] for a in cube_frames["cpu"])
    shown = sum(int((a[..., :3] != cube.CLEAR_BGR).any(-1).sum())
                for a in cube_frames["cpu"])
    check(shown > 0, "-cube drew no shape")
    check(differ <= CUBE_SHARE * total, f"-cube: {differ} of {total} pixels "
          f"differ between the card and the CPU (share {differ / total:.3g}"
          f" > {CUBE_SHARE})")
    print(f"[14 cube] {card} | CLI -cube -frames {CUBE_FRAMES} -shapes 8 "
          f"-fly at 1000x800 ({px.shape[1]}x{px.shape[0]} texture): card vs "
          f"CPU {differ} of {total} pixels differ (share {differ / total:.3g}, limit "
          f"{CUBE_SHARE}); {shown} pixels show a shape; wall time a frame, "
          f"texture load and BMP writes included: cuda "
          f"{cube_s['cuda'] * 1e3 / CUBE_FRAMES:.1f} ms, cpu "
          f"{cube_s['cpu'] * 1e3 / CUBE_FRAMES:.1f} ms", flush=True)


def fast_path(dev, card: str, img, planes, noise_planes, stack,
              rd_exact, ptxas: dict) -> dict:
    """Phase 15: precision="fast". (a) F1 and F2 on the CLI and noise 4K
    frames at q 10, 50, 90 against their plain versions and K3 / K4; (b)
    F1's plain version alike with ``allow_tf32`` True and False; (c) the
    fast main path, ``compress_dct`` then ``decompress_dct`` of the CLI
    image (``img``) at q 10, 50, 90, the counts set to 0 just before the
    q50 pair and read just after; (d) ``roundtrip_batch`` on the 8 x 1080p
    ``stack``; (e) a fast ``roundtrip_scan`` at K = 8; (f) the fast sweep
    beside the exact one (``rd_exact``); (g) ``compress_frame_sharded`` on
    the card as two shards; (h) times, warm and on inputs in device memory,
    with ``ptxas``'s report (kernel name: registers, stack, spills) of F1,
    F2, K3 and K4. Returns F1's and F2's entries of the kernels line."""
    from myyuv_tpu_torch.engine import (batch, device_stream, pipeline,
                                        sharded_stream, sweep)
    from myyuv_tpu_torch.entropy import decode
    from myyuv_tpu_torch.kernels import build, probe, transform
    from myyuv_tpu_torch.kernels import device as kdev
    from myyuv_tpu_torch.parallel import mesh as meshlib
    from myyuv_tpu_torch.tools.common import bound_ms, cold

    errs = dict.fromkeys(FAST, 0)

    def within(got, want, share, name, what):
        """got within +-1 of want, differing in at most ``share`` of the
        values (0: equal; None: any share); the largest |d| goes under
        ``errs[name]``."""
        for g, w_ in zip(got, want):
            d = (g.to(torch.int32) - w_.to(torch.int32)).abs()
            m, frac = int(d.max()), float((d != 0).double().mean())
            if name:
                errs[name] = max(errs[name], m)
            check(m <= 1 and (share is None or frac <= share),
                  f"{what}: max |d| {m}, share {frac:.3g} (bounds 1, "
                  f"{share})")

    # (a) the kernels against their plain versions and the exact kernels
    t0 = time.perf_counter()
    vs_exact = dict.fromkeys(FAST, 0.0)
    for fname, fr in (("cli", planes), ("noise", noise_planes)):
        for q in FAST_QUALITIES:
            dct, qt = pipeline.codec_params([q] * 3, dev)
            tag = f"{fname} q{q}"
            cs, ps = ((FAST_COEF_SHARE, FAST_PIXEL_SHARE) if fname == "noise"
                      else (None, None))
            f1 = transform.fast_dct_quantize_blocks(*fr, qt, dct)
            check(f1.device.type == dev.type, "F1 output not on the card")
            within([f1], [transform.fast_dct_quantize_blocks_plain(
                *fr, qt, dct)], 0, "fast_dct_quantize",
                f"F1 against its plain version: {tag}")
            k3 = transform.dct_quantize_blocks(*fr, qt, dct)
            within([f1], [k3], cs, None, f"F1 against K3: {tag}")
            vs_exact["fast_dct_quantize"] = max(
                vs_exact["fast_dct_quantize"],
                float((f1 != k3).double().mean()))
            f2 = transform.fast_dequantize_idct_blocks(f1, qt, dct, H4K, W4K)
            within(f2, transform.fast_dequantize_idct_blocks_plain(
                f1, qt, dct, H4K, W4K), 0, "fast_dequantize_idct",
                f"F2 against its plain version: {tag}")
            k4 = transform.dequantize_idct_blocks(f1, qt, dct, H4K, W4K)
            within(f2, k4, ps, None, f"F2 against K4: {tag}")
            vs_exact["fast_dequantize_idct"] = max(
                [vs_exact["fast_dequantize_idct"]]
                + [float((a != b).double().mean()) for a, b in zip(f2, k4)])
    # (b) the plain version runs no matmul: the TF32 switch changes nothing
    dct, qt = pipeline.codec_params([90] * 3, dev)
    saved = torch.backends.cuda.matmul.allow_tf32
    plain_tf32 = []
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            plain_tf32.append(transform.fast_dct_quantize_blocks_plain(
                *noise_planes, qt, dct))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    check(torch.equal(*plain_tf32), "plain F1 differs with allow_tf32 on")
    print(f"[15a F1/F2 vs plain] {W4K}x{H4K} CLI and noise frames, q "
          f"{FAST_QUALITIES}: F1 and F2 (on F1's coefficients) == their "
          f"plain versions; within +-1 of K3 / K4, largest share differing "
          f"F1 {vs_exact['fast_dct_quantize']:.3g}, F2 "
          f"{vs_exact['fast_dequantize_idct']:.3g} (on noise within "
          f"{FAST_COEF_SHARE} / {FAST_PIXEL_SHARE}); plain F1 identical with "
          f"allow_tf32 True and False; max_abs_err F1 "
          f"{errs['fast_dct_quantize']} F2 {errs['fast_dequantize_idct']}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (c) the fast main path through pipeline, the file held to the plain
    # versions: its coefficients to plain F1's, its pixels to plain F2 of
    # those coefficients
    launches = {}
    frame = device_stream.to_device(img.planes(), dev)
    psnr = {}
    for q in FAST_QUALITIES:
        params = bytes([q] * 3)
        if q == 50:
            reset_launches()
        comp = pipeline.compress_dct(img, params, device=dev,
                                     precision="fast")
        dec = pipeline.decompress_dct(comp, device=dev, precision="fast")
        if q == 50:
            torch.cuda.synchronize()
            launches["main"] = dict(build.launches)
        dct, qt = pipeline.codec_params([q] * 3, dev)
        streams, _, _ = pipeline._dct_streams(comp, dev)
        content, sizes = device_stream.streams_to_device(streams, dev)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        coeffs, err = decode.decode_blocks_plain(content, sizes, offsets)
        check(not err.any(), f"the fast q{q} file does not decode")
        within([coeffs], [transform.fast_dct_quantize_blocks_plain(
            *frame, qt, dct)], 0, None,
            f"fast compress_dct q{q} against plain F1")
        rec = [torch.from_numpy(np.ascontiguousarray(p)).to(dev)
               for p in dec.planes()]
        within(rec, transform.fast_dequantize_idct_blocks_plain(
            coeffs, qt, dct, H4K, W4K), 0, None,
            f"fast decompress_dct q{q} against plain F2")
        exact = pipeline.decompress_dct(
            pipeline.compress_dct(img, params, device=dev), device=dev)
        yo = img.planes()[0].astype(np.float64)
        psnr[q] = [10 * np.log10(255.0 ** 2 / max(float(
            ((d.planes()[0].astype(np.float64) - yo) ** 2).mean()), 1e-12))
            for d in (dec, exact)]
        check(psnr[q][0] > 20 and abs(psnr[q][0] - psnr[q][1])
              <= FAST_PSNR_DB, f"fast PSNR-Y at q{q}: {psnr[q]}")
    want = dict.fromkeys(ALL, 0)
    want.update(fast_dct_quantize=1, huffman_encode=1, huffman_decode=1,
                fast_dequantize_idct=1)
    check(launches["main"] == want,
          f"the fast main path launched {launches['main']}")
    print(f"[15c fast main path] compress_dct / decompress_dct "
          f"precision='fast' of the {W4K}x{H4K} CLI image at q "
          f"{FAST_QUALITIES}: coefficients == plain F1's, pixels == plain "
          f"F2 of them; PSNR-Y fast / exact "
          + ", ".join(f"q{q} {a:.3f} / {b:.3f} dB"
                      for q, (a, b) in psnr.items())
          + f"; launches at q50 {launches['main']}", flush=True)

    # (d) the fast batch round trip: K5 and K6 are lossless, so its planes
    # are F2(F1(x)) of the batch seen as one frame
    dct, qt = pipeline.codec_params([50] * 3, dev)
    bt = [torch.from_numpy(p).to(dev) for p in stack]
    tall = [p.view(-1, p.shape[-1]) for p in bt]
    reset_launches()
    (ry, ru, rv), btotal, bok = device_stream.roundtrip_batch(
        *bt, qt, dct, precision="fast")
    torch.cuda.synchronize()
    launches["batch"] = dict(build.launches)
    f1 = transform.fast_dct_quantize_blocks(*tall, qt, dct)
    want_planes = transform.fast_dequantize_idct_blocks(
        f1, qt, dct, BATCH * H1K, W1K)
    bsizes, bcontent = device_stream.compress_batch(*bt, qt, dct,
                                                    precision="fast")
    check(bool(bok) and int(btotal) == bcontent.numel(),
          "fast roundtrip_batch: ok or total differ from compress_batch")
    for g, w_ in zip((ry, ru, rv), want_planes):
        check(torch.equal(g.reshape(w_.shape), w_),
              "fast roundtrip_batch planes differ from F2(F1(x))")
    (sy, su, sv), sm = batch.roundtrip_step(*bt, *qt, dct, precision="fast")
    for g, w_ in zip((sy, su, sv), (ry, ru, rv)):
        check(torch.equal(g, w_), "fast roundtrip_step planes differ from "
              "the fast roundtrip_batch's")
    want = dict.fromkeys(ALL, 0)
    want.update(fast_dct_quantize=1, huffman_encode=1, huffman_decode=1,
                fast_dequantize_idct=1)
    check(launches["batch"] == want,
          f"the fast batch round trip launched {launches['batch']}")

    # (e) a fast scan: one graph of K frames of F1, K5, K6 and F2
    stk = [p.expand(KSCAN, *p.shape).contiguous() for p in planes]
    device_stream.clear_scan_graphs()
    reset_launches()
    totals, oks = device_stream.roundtrip_scan(*stk, qt, dct, "fast")
    launches["scan"] = dict(build.launches)
    graph = device_stream.scan_graph(KSCAN, H4K, W4K, stk[0].device, "fast")
    fsizes, fcontent = device_stream.compress_frame(*planes, qt, dct,
                                                    precision="fast")
    check(oks.all() and (totals == fcontent.numel()).all(),
          "the fast scan differs from the fast frame API")
    check(graph.launches == dict.fromkeys(
        ("fast_dct_quantize", "huffman_encode", "huffman_decode",
         "fast_dequantize_idct"), KSCAN),
        f"the fast scan's graph recorded {graph.launches}")
    print(f"[15d/e fast batch and scan] {BATCH} x {W1K}x{H1K} q50 "
          f"roundtrip_batch precision='fast': planes == F2(F1(x)) == "
          f"roundtrip_step's, {int(btotal)} bytes, launches "
          f"{launches['batch']}; roundtrip_scan K = {KSCAN} of the 4K CLI "
          f"frame: totals == compress_frame's {fcontent.numel()}, a graph of "
          f"{graph.launches}, launches from Python {launches['scan']}",
          flush=True)

    # (f) the fast sweep: PSNR within FAST_PSNR_DB of the exact sweep's,
    # its two rate routes equal
    frame_np = img.planes()
    reset_launches()
    rd_fast = sweep.quality_sweep(frame_np, RD_QUALITIES, None, device=dev,
                                  precision="fast")
    rd_fast_k = sweep.quality_sweep(frame_np, RD_QUALITIES, "device",
                                    device=dev, precision="fast")
    launches["sweep"] = dict(build.launches)
    for f, g, e in zip(rd_fast, rd_fast_k, rd_exact):
        check(f["compressed_bytes"] == g["compressed_bytes"],
              f"the fast sweep's rate routes differ at q{f['quality']}")
        for k in ("psnr_y_db", "psnr_u_db", "psnr_v_db"):
            check(abs(f[k] - e[k]) <= FAST_PSNR_DB,
                  f"fast sweep {k} at q{f['quality']}: {f[k]} against "
                  f"exact {e[k]}")
    for name in FAST:
        check(launches["sweep"][name] > 0, f"the fast sweep skipped {name}")
    for name in ("dct_encode", "decode_idct", "dct_quantize",
                 "dequantize_idct"):
        check(launches["sweep"][name] == 0,
              f"the fast sweep launched {name}")

    # (g) the sharded codec on the card as two shards
    qts = list(qt.cpu().numpy())
    mesh = meshlib.make_mesh((2, 1), [dev, dev])
    want_streams = device_stream.compress_frame_to_streams(
        frame_np, qt, dct, precision="fast")
    reset_launches()
    got = sharded_stream.compress_frame_sharded(mesh, frame_np, qts,
                                                precision="fast")
    rec = sharded_stream.decompress_frame_sharded(mesh, got, qts, H4K, W4K,
                                                  precision="fast")
    torch.cuda.synchronize()
    launches["sharded"] = dict(build.launches)
    for (gs, gc), (ws, wc) in zip(got, want_streams):
        check(np.array_equal(gs, ws) and np.array_equal(gc, wc),
              "fast sharded streams differ from compress_frame_to_streams")
    for g, w_ in zip(rec, device_stream.decompress_streams_to_frame(
            want_streams, qt, dct, H4K, W4K, precision="fast")):
        check(np.array_equal(g, w_), "fast sharded planes differ")
    check(launches["sharded"]["fast_dct_quantize"] == 2
          and launches["sharded"]["fast_dequantize_idct"] == 2,
          f"fast sharded launches {launches['sharded']}")
    print(f"[15f/g fast sweep and shards] quality_sweep precision='fast' q "
          f"{RD_QUALITIES}: both rate routes equal, PSNR within "
          f"{FAST_PSNR_DB} dB of the exact sweep ("
          + ", ".join(f"q{f['quality']} Y {f['psnr_y_db']} / {e['psnr_y_db']}"
                      for f, e in zip(rd_fast, rd_exact))
          + f"), launches {launches['sweep']}; compress_frame_sharded / "
          f"decompress_frame_sharded on 2 shards of the card == the frame "
          f"API, launches {launches['sharded']}", flush=True)

    # (h) times: F1 and F2 beside K3 and K4 on the same inputs, the plain
    # versions, and the torch.matmul formulation with TF32 off
    c_e = transform.dct_quantize_blocks(*planes, qt, dct)
    c_f = transform.fast_dct_quantize_blocks(*planes, qt, dct)
    n = c_e.shape[0]
    npx = H4K * W4K * 3 // 2
    tables = qt.numel() * 4 + dct.numel() * 4

    def queued(fn):
        return probe.cuda_ms(fn, REPS, calls=1)

    def matmul_forward(fr):
        """F1's function as torch.matmul of [N, 8, 8] blocks."""
        out = []
        for i, p in enumerate(fr):
            x = kdev.plane_to_blocks(p).to(torch.float32) - 128.0
            coef = torch.matmul(torch.matmul(dct, x), dct.t())
            out.append(kdev.round_half_away(coef / qt[i]).to(torch.int16)
                       .reshape(-1, 64))
        return torch.cat(out)

    def matmul_inverse(c):
        """F2's function as torch.matmul of [N, 8, 8] blocks."""
        out = []
        for i, b in enumerate(c.split(kdev.plane_block_counts(H4K, W4K))):
            x = b.reshape(-1, 8, 8).to(torch.float32) * qt[i]
            pix = torch.matmul(torch.matmul(dct.t(), x), dct)
            r = kdev.round_half_away(pix).to(torch.int32) + 128
            out.append(r.clamp(0, 255).to(torch.uint8))
        return transform.blocks_to_planes(torch.cat(out), H4K, W4K)

    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        within([matmul_forward(planes)], [c_f], None, None,
               "the matmul formulation against F1")
        times = {
            "K3": probe.cuda_ms(lambda: transform.dct_quantize_blocks(
                *planes, qt, dct), REPS),
            "fast_dct_quantize": probe.cuda_ms(
                lambda: transform.fast_dct_quantize_blocks(*planes, qt, dct),
                REPS),
            "K4": probe.cuda_ms(lambda: transform.dequantize_idct_blocks(
                c_e, qt, dct, H4K, W4K), REPS),
            "fast_dequantize_idct": probe.cuda_ms(
                lambda: transform.fast_dequantize_idct_blocks(
                    c_e, qt, dct, H4K, W4K), REPS),
            "noise K3": probe.cuda_ms(lambda: transform.dct_quantize_blocks(
                *noise_planes, qt, dct), REPS),
            "noise F1": probe.cuda_ms(
                lambda: transform.fast_dct_quantize_blocks(*noise_planes, qt,
                                                           dct), REPS),
        }
        plain = {
            "fast_dct_quantize": queued(
                lambda: transform.fast_dct_quantize_blocks_plain(
                    *planes, qt, dct)),
            "fast_dequantize_idct": queued(
                lambda: transform.fast_dequantize_idct_blocks_plain(
                    c_e, qt, dct, H4K, W4K)),
        }
        library = {
            "fast_dct_quantize": queued(lambda: matmul_forward(planes)),
            "fast_dequantize_idct": queued(lambda: matmul_inverse(c_e)),
        }
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    noise_c = transform.dct_quantize_blocks(*noise_planes, qt, dct)
    times["noise K4"] = probe.cuda_ms(lambda: transform.dequantize_idct_blocks(
        noise_c, qt, dct, H4K, W4K), REPS)
    times["noise F2"] = probe.cuda_ms(
        lambda: transform.fast_dequantize_idct_blocks(noise_c, qt, dct, H4K,
                                                      W4K), REPS)
    # the same four on inputs in device memory, as the bound by bytes
    # assumes: each call takes the next of copies rotated past the L2
    cold_ms = {}
    for name, fn, args in (
            ("K3", lambda *p: transform.dct_quantize_blocks(*p, qt, dct),
             planes),
            ("fast_dct_quantize",
             lambda *p: transform.fast_dct_quantize_blocks(*p, qt, dct),
             planes),
            ("K4", lambda c: transform.dequantize_idct_blocks(
                c, qt, dct, H4K, W4K), (c_e,)),
            ("fast_dequantize_idct",
             lambda c: transform.fast_dequantize_idct_blocks(
                 c, qt, dct, H4K, W4K), (c_e,))):
        cold_ms[name] = probe.cuda_ms(cold(fn, args), REPS)
    bounds = {"fast_dct_quantize": bound_ms(npx + tables + n * 128,
                                            n * DCT_FLOP),
              "fast_dequantize_idct": bound_ms(n * 128 + tables + npx,
                                               n * DCT_FLOP)}
    rec_e = device_stream.compress_frame(*planes, qt, dct)
    rec_f = (fsizes, fcontent)
    host = {}
    for prec, (sz, ct) in (("exact", rec_e), ("fast", rec_f)):
        host[prec] = [host_ms(f) for f in (
            lambda: device_stream.compress_frame(*planes, qt, dct,
                                                 precision=prec),
            lambda: device_stream.decompress_frame(ct, sz, qt, dct, H4K, W4K,
                                                   precision=prec),
            lambda: pipeline.compress_dct(img, bytes([50] * 3), device=dev,
                                          precision=prec),
            lambda: device_stream.roundtrip_batch(*bt, qt, dct, prec),
            lambda: batch.roundtrip_step(*bt, *qt, dct, prec))]
    device_stream.clear_scan_graphs()
    scan_ms = {prec: probe.cuda_ms(lambda: device_stream.roundtrip_scan(
        *stk, qt, dct, prec), REPS) for prec in ("exact", "fast")}
    device_stream.clear_scan_graphs()
    print(f"[15h times] {card} | {W4K}x{H4K} q50 CLI frame, CUDA events "
          f"around calls queued behind a busy card, median of {REPS}: "
          f"F1 {times['fast_dct_quantize']:.4f} ms against K3 "
          f"{times['K3']:.4f}, F2 {times['fast_dequantize_idct']:.4f} "
          f"against K4 {times['K4']:.4f} (noise frame: F1 "
          f"{times['noise F1']:.4f} / K3 {times['noise K3']:.4f}, F2 "
          f"{times['noise F2']:.4f} / K4 {times['noise K4']:.4f}); inputs "
          f"in device memory: F1 {cold_ms['fast_dct_quantize']:.4f}, K3 "
          f"{cold_ms['K3']:.4f}, F2 {cold_ms['fast_dequantize_idct']:.4f}, "
          f"K4 {cold_ms['K4']:.4f}; ptxas: " + "; ".join(
              f"{label} {ptxas[name]}" for label, name in (
                  ("F1", "fast_dct_quantize"), ("K3", "dct_quantize"),
                  ("F2", "fast_dequantize_idct"), ("K4", "dequantize_idct")))
          + f"; bound {bounds['fast_dct_quantize'][0]:.4f} ms by "
          f"{bounds['fast_dct_quantize'][1]}; plain F1 "
          f"{plain['fast_dct_quantize']:.4f}, F2 "
          f"{plain['fast_dequantize_idct']:.4f}; torch.matmul formulation, "
          f"TF32 off: F1's {library['fast_dct_quantize']:.4f}, F2's "
          f"{library['fast_dequantize_idct']:.4f}; roundtrip_scan K = "
          f"{KSCAN}: exact {scan_ms['exact']:.4f} ms, fast "
          f"{scan_ms['fast']:.4f} ms", flush=True)
    print(f"[15h times] {card} | host clock, median of {REPS}, exact / fast: "
          + ", ".join(f"{k} {a:.3f} / {b:.3f} ms" for k, a, b in zip(
              ("compress_frame 4K", "decompress_frame 4K", "compress_dct 4K",
               f"roundtrip_batch {BATCH} x 1080p",
               f"roundtrip_step {BATCH} x 1080p"),
              host["exact"], host["fast"])), flush=True)
    del stk, frame, bt, tall
    return {name: {"launches": launches["main"][name],
                   "max_abs_err": errs[name],
                   "share_differing_from_exact": vs_exact[name],
                   "ms": times[name], "cold_ms": cold_ms[name],
                   "plain_ms": plain[name],
                   "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                   "library_ms": library[name],
                   "launches_batch": launches["batch"][name],
                   "launches_sweep": launches["sweep"][name],
                   "launches_sharded": launches["sharded"][name]}
            for name in FAST}


def gloo_worker(argv) -> int:
    """One process of phase 13 (c): ``chip_smoke.py --gloo-worker PORT RANK
    BATCH.npz DEVICE``. Joins a gloo group of two at localhost:PORT, codes
    its share of the batch's frames with ``compress_batch_sharded`` over a
    (2, 1) mesh of the parent's card DEVICE at q50, and prints one JSON
    line: its frames, the sha256 of every frame's gathered streams and its
    K1 launches."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from myyuv_tpu_torch.engine import pipeline, sharded_stream
    from myyuv_tpu_torch.kernels import build
    from myyuv_tpu_torch.parallel import distributed
    from myyuv_tpu_torch.parallel import mesh as meshlib
    port, rank, path, dev = argv[0], int(argv[1]), argv[2], argv[3]
    distributed.initialize(f"localhost:{port}", 2, rank)
    try:
        with np.load(path) as z:
            stack = [z[f"arr_{i}"] for i in range(3)]
        _, qt = pipeline.codec_params([50] * 3, dev)
        mesh = meshlib.make_mesh((2, 1), [dev, dev])
        frames = sharded_stream.compress_batch_sharded(
            mesh, stack, list(qt.cpu().numpy()))
        torch.cuda.synchronize()
        blob = b"".join(bytes(c) + bytes(s) for streams in frames
                        for s, c in streams)
        print(json.dumps({
            "rank": rank, "n_frames": len(frames),
            "local": list(distributed.local_shard(stack[0].shape[0])),
            "sha": hashlib.sha256(blob).hexdigest(),
            "dct_encode": build.launches["dct_encode"]}), flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-worker"]:
        sys.exit(gloo_worker(sys.argv[2:]))
    sys.exit(main())
