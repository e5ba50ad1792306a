"""The CUDA kernels K1-K6, X1, X2 and T1-T7 against their plain PyTorch
versions on the card, the staged route and batch API against the fused
route, and the streaming drivers against the frame API, ``roundtrip_scan``'s
CUDA graph against the eager round trip and the sweep's two rate routes
against each other. Marked ``gpu``: they skip where no CUDA device is
present, and run with ``python -m pytest tests/test_torch_gpu.py`` on a
machine with one (``-k convert`` for X1 and X2, ``-k streaming`` for the
drivers, ``-k "scan or sweep"`` for the scan and the sweep, ``-k "tree or
probe or lane"`` for T1-T7, ``-k "sharded or card"`` for the multi-device
path, the second card and the cube, ``-k fast`` for F1 and F2).

Tolerance: exact equality (bytes, sizes, pixels, error codes, totals,
flags), except the sweep's PSNR on the card against the CPU's, to 1e-3:
float32 sums taken in another order, rounded to 3 decimals; the sharded
round trip's SSE to rtol 1e-6 (float32 sums shard by shard); the cube's
frames on the card and the CPU to a share of 1e-3 differing pixels (edge
pixels under another order of float32 operations)."""

import time

import numpy as np
import pytest
import torch

from myyuv_tpu_torch.engine import device_stream, pipeline, streaming
from myyuv_tpu_torch.entropy import decode, encode
from myyuv_tpu_torch.entropy import device as edev
from myyuv_tpu_torch.kernels import build, convert, probe, transform
from myyuv_tpu_torch.kernels import device as kdev

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frame(rng, h, w):
    y = probe.with_probe_blocks(rng.integers(0, 256, (h, w), np.uint8),
                                probe.contraction_probe_blocks())
    u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
    v = np.full((h // 2, w // 2), 77, np.uint8)
    return y, u, v


@pytest.mark.parametrize("q", [1, 50, 90, 100])
def test_k1_and_k2_match_plain(rng, cuda, q):
    h, w = 64, 128
    planes = [torch.from_numpy(p).to(cuda) for p in _frame(rng, h, w)]
    dct, qt = pipeline.codec_params([q] * 3, cuda)
    got = encode.dct_encode_blocks(*planes, qt, dct)
    want = encode.dct_encode_blocks_plain(*planes, qt, dct)
    for g, p in zip(got, want):
        assert g.is_cuda and torch.equal(g, p)
    sizes, content = device_stream.compress_frame(*planes, qt, dct)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    got = decode.decode_idct_blocks(content, sizes, offsets, qt, dct, h, w)
    want = decode.decode_idct_blocks_plain(content, sizes, offsets, qt, dct,
                                           h, w)
    for g, p in zip(got, want):
        assert g.is_cuda and torch.equal(g, p)
    assert not got[3].any()


@pytest.mark.parametrize("shape", [(16, 16), (736, 992)])
@pytest.mark.parametrize("q", [1, 10, 35, 75, 100])
def test_content_kinds_sweep(rng, cuda, shape, q):
    """Five content kinds per quality; 16x16 has 6 blocks (no multiple of
    8 or of the thread-block size)."""
    h, w = shape
    dct, qt = pipeline.codec_params([q] * 3, cuda)
    for kind in probe.KINDS:
        planes = [torch.from_numpy(probe.content_kind(rng, kind, s)).to(cuda)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        got = encode.dct_encode_blocks(*planes, qt, dct)
        want = encode.dct_encode_blocks_plain(*planes, qt, dct)
        for g, p in zip(got, want):
            assert torch.equal(g, p), kind
        sizes, content = device_stream.compress_frame(*planes, qt, dct)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        got = decode.decode_idct_blocks(content, sizes, offsets, qt, dct,
                                        h, w)
        want = decode.decode_idct_blocks_plain(content, sizes, offsets, qt,
                                               dct, h, w)
        for g, p in zip(got, want):
            assert torch.equal(g, p), kind
        assert not got[3].any()


def test_k2_flags_corrupt_chunks_like_plain(rng, cuda):
    h, w = 32, 64
    planes = [torch.from_numpy(p).to(cuda) for p in _frame(rng, h, w)]
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    sizes, content = device_stream.compress_frame(*planes, qt, dct)
    content = content.clone()
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    for b, flip in ((0, 2), (5, 0), (9, 3)):  # tree size, enc bits, tree
        content[offsets[b] + flip] ^= 0x5A
    sizes = sizes.clone()
    sizes[20] = 2
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    offsets[30] = content.numel() - 2      # runs off the end of content
    offsets[31] = content.numel() + 100    # wholly outside it
    got = decode.decode_idct_blocks(content, sizes, offsets, qt, dct, h, w)
    want = decode.decode_idct_blocks_plain(content, sizes, offsets, qt, dct,
                                           h, w)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    assert got[3][20] == 1 and got[3][0] != 0


def test_cuda_and_cpu_files_identical(rng, cuda):
    from myyuv_tpu_torch.formats import yuv
    planes = _frame(rng, 48, 96)
    img = yuv.YUVImage.from_planes(yuv.FourccFormats.IYUV, planes, 96, 48)
    a = pipeline.compress_dct(img, bytes([75] * 3), device="cuda")
    b = pipeline.compress_dct(img, bytes([75] * 3), device="cpu")
    assert a.to_bytes() == b.to_bytes()
    assert (pipeline.decompress_dct(a, "cuda").to_bytes()
            == pipeline.decompress_dct(b, "cpu").to_bytes())


def _kind_planes(rng, kind, h, w, cuda):
    return [torch.from_numpy(probe.content_kind(rng, kind, s)).to(cuda)
            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


@pytest.mark.parametrize("shape", [(16, 16), (736, 992)])
@pytest.mark.parametrize("q", [1, 10, 35, 50, 75, 90, 100])
def test_staged_kernels_match_plain(rng, cuda, shape, q):
    """K3, K5, K6 and K4 against their plain versions on five content
    kinds, and each staged pair against the fused kernel it splits."""
    h, w = shape
    dct, qt = pipeline.codec_params([q] * 3, cuda)
    for kind in probe.KINDS:
        planes = _kind_planes(rng, kind, h, w, cuda)
        coeffs = transform.dct_quantize_blocks(*planes, qt, dct)
        assert coeffs.is_cuda and torch.equal(
            coeffs, transform.dct_quantize_blocks_plain(*planes, qt, dct))
        lanes = encode.encode_blocks(coeffs)
        for g, p, f in zip(lanes, edev.encode_lanes(coeffs),
                           encode.dct_encode_blocks(*planes, qt, dct)):
            assert torch.equal(g, p) and torch.equal(g, f), kind
        sizes = lanes[1]
        content = device_stream.compact_chunks(lanes[0], sizes)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        got = decode.decode_blocks(content, sizes, offsets)
        want = decode.decode_blocks_plain(content, sizes, offsets)
        for g, p in zip(got, want):
            assert torch.equal(g, p), kind
        assert torch.equal(got[0], coeffs) and not got[1].any()
        pix = transform.dequantize_idct_blocks(got[0], qt, dct, h, w)
        fused = decode.decode_idct_blocks(content, sizes, offsets, qt, dct,
                                          h, w)
        for g, p, f in zip(pix, transform.dequantize_idct_blocks_plain(
                got[0], qt, dct, h, w), fused):
            assert torch.equal(g, p) and torch.equal(g, f), kind


def test_k5_on_coefficients_no_dct_makes(rng, cuda):
    c = rng.integers(-32768, 32768, (300, 64)).astype(np.int16)
    c[0] = 0
    c[1] = -1024
    c[2] = 1023
    c[3] = np.iinfo(np.int16).max
    c[4, ::2] = np.iinfo(np.int16).min
    c[5] = np.arange(64) * 1021 - 32000      # 64 distinct symbols
    coeffs = torch.from_numpy(c).to(cuda)
    got = encode.encode_blocks(coeffs)
    for g, p in zip(got, edev.encode_lanes(coeffs)):
        assert torch.equal(g, p)
    assert not got[2].any() and int(got[1].max()) <= 255


# K1's case for each encoder family: plane content ("mid" is 128
# everywhere) and quantizer entries (q everywhere, or 1 at the kept
# row-major positions and 4096, which zeroes any coefficient, elsewhere).
# Its transform reaches the family's shape where a u8 picture can; int16
# extremes and aliasing symbols lie beyond a DCT's range, so those take the
# widest symbols q = 1 gives. 48x80 is 90 blocks, no multiple of the 32
# blocks a CTA codes.
_K1_CASES = {
    "all_zero": ("mid", 1, None), "first_only": ("noise", 1, [0]),
    "last_only": ("noise", 1, [63]), "one_symbol": ("flat", 1, None),
    "n_sym_2": ("noise", 1, [0, 63]), "merge_ties": ("noise", 64, None),
}


@pytest.mark.parametrize("family", probe.ENCODER_FAMILIES)
def test_encoder_families_match_plain(rng, cuda, family):
    """K5 on each family of ``probe.encoder_families`` and K1 on frames
    that reach it: lanes, sizes and err identical to the plain versions."""
    coeffs = torch.from_numpy(probe.encoder_families(rng)[family]).to(cuda)
    got = encode.encode_blocks(coeffs)
    for g, p in zip(got, edev.encode_lanes(coeffs)):
        assert g.is_cuda and torch.equal(g, p)
    kind, q, keep = _K1_CASES.get(family, ("noise", 1, None))
    h, w = 48, 80
    planes = []
    for shape in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        p = (np.full(shape, 128, np.uint8) if kind == "mid"
             else probe.content_kind(rng, kind, shape))
        planes.append(torch.from_numpy(p).to(cuda))
    qt = torch.full((3, 64), float(q if keep is None else 4096))
    if keep is not None:
        qt[:, keep] = 1.0
    qt = qt.view(3, 8, 8).to(cuda)
    dct, _ = pipeline.codec_params([50] * 3, cuda)
    got = encode.dct_encode_blocks(*planes, qt, dct)
    for g, p in zip(got, encode.dct_encode_blocks_plain(*planes, qt, dct)):
        assert g.is_cuda and torch.equal(g, p)


def test_encoder_k1_reads_planes_off_8_byte_boundaries(rng, cuda):
    """K1 loads a lane's 8 pixels at once only from an 8-byte aligned row;
    planes that start off that boundary take its byte loads."""
    h, w = 32, 64
    planes = []
    for i, shape in enumerate(((h, w), (h // 2, w // 2), (h // 2, w // 2))):
        buf = torch.from_numpy(rng.integers(0, 256, shape[0] * shape[1] + 8,
                                            np.uint8)).to(cuda)
        planes.append(buf[i + 1:i + 1 + shape[0] * shape[1]].view(shape))
    dct, qt = pipeline.codec_params([90] * 3, cuda)
    got = encode.dct_encode_blocks(*planes, qt, dct)
    for g, p in zip(got, encode.dct_encode_blocks_plain(*planes, qt, dct)):
        assert torch.equal(g, p)


# 6 and 90 blocks leave the last CTA's groups, and a warp's, partly idle
_TRANSFORM_SHAPES = [(16, 16), (48, 80), (64, 128)]


@pytest.mark.parametrize("q", [1, 10, 35, 50, 75, 90, 100])
def test_transform_k3_k4_match_plain(rng, cuda, q):
    """K3 on frames of random planes with the contraction-probe blocks and
    K4 on K3's coefficients and on random int16 rows: coefficients and
    pixels identical to the plain versions."""
    dct, qt = pipeline.codec_params([q] * 3, cuda)
    for h, w in _TRANSFORM_SHAPES:
        planes = [torch.from_numpy(p).to(cuda) for p in _frame(rng, h, w)]
        coeffs = transform.dct_quantize_blocks(*planes, qt, dct)
        assert coeffs.is_cuda and torch.equal(
            coeffs, transform.dct_quantize_blocks_plain(*planes, qt, dct))
        rows = torch.from_numpy(rng.integers(
            -2048, 2048, coeffs.shape).astype(np.int16)).to(cuda)
        for c in (coeffs, rows):
            got = transform.dequantize_idct_blocks(c, qt, dct, h, w)
            for g, p in zip(got, transform.dequantize_idct_blocks_plain(
                    c, qt, dct, h, w)):
                assert g.is_cuda and torch.equal(g, p), (h, w)


def test_transform_k3_k4_on_a_tall_batch_frame(rng, cuda):
    """8 x 1088x1920 passed as one frame of 8704 rows, as the batch API
    passes it: more blocks than the card holds groups at once, so every
    group walks the frame several times."""
    b, h, w = 8, 1088, 1920
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    planes = [torch.from_numpy(rng.integers(0, 256, s, np.uint8)).to(cuda)
              for s in ((b * h, w), (b * h // 2, w // 2),
                        (b * h // 2, w // 2))]
    coeffs = transform.dct_quantize_blocks(*planes, qt, dct)
    assert torch.equal(coeffs, transform.dct_quantize_blocks_plain(
        *planes, qt, dct))
    for g, p in zip(transform.dequantize_idct_blocks(coeffs, qt, dct, b * h,
                                                     w),
                    transform.dequantize_idct_blocks_plain(coeffs, qt, dct,
                                                           b * h, w)):
        assert torch.equal(g, p)


def test_transform_k3_reads_planes_off_8_byte_boundaries(rng, cuda):
    """K3 loads a lane's 8 pixels at once only from an 8-byte aligned row;
    planes that start off that boundary take its byte loads."""
    h, w = 48, 80
    planes = []
    for i, shape in enumerate(((h, w), (h // 2, w // 2), (h // 2, w // 2))):
        buf = torch.from_numpy(rng.integers(0, 256, shape[0] * shape[1] + 8,
                                            np.uint8)).to(cuda)
        planes.append(buf[i + 1:i + 1 + shape[0] * shape[1]].view(shape))
    dct, qt = pipeline.codec_params([90] * 3, cuda)
    assert torch.equal(transform.dct_quantize_blocks(*planes, qt, dct),
                       transform.dct_quantize_blocks_plain(*planes, qt, dct))


def test_timer_leaves_out_host_work(cuda):
    """``probe.cuda_ms`` times the card's work only: a one-element add
    reads a few microseconds, whatever the host spends per call; a call
    that synchronises lets the card wait on the host, and the timer
    refuses it."""
    x = torch.zeros(1, device=cuda)
    assert probe.cuda_ms(lambda: x.add_(1)) < 0.01

    def synchronising():
        x.add_(1)
        torch.cuda.synchronize()

    with pytest.raises(RuntimeError, match="host"):
        probe.cuda_ms(synchronising)


def test_timer_retakes_a_reading_the_host_paused(cuda):
    """A pause of the host while it queues one reading (another process on
    its cores) costs that reading, not the timer: it is taken again behind
    a longer sleep. Calls 13-22 are the first reading."""
    x = torch.zeros(1, device=cuda)
    calls = []

    def paused_once():
        calls.append(None)
        if len(calls) == 15:
            time.sleep(0.05)
        x.add_(1)

    assert probe.cuda_ms(paused_once) < 0.01
    assert len(calls) > 2 + 10 + 7 * 10


def test_card_ran_dry_retakes_a_run_the_host_paused(cuda):
    """card_ran_dry tells one pause of the host from a sync: a driver that
    pauses once in its first timed run has not run the card dry; one that
    synchronises on every frame has."""
    x = torch.zeros(1, device=cuda)
    runs = []

    def paused_once(frames):
        runs.append(None)
        for i, _ in enumerate(frames):
            if len(runs) == 2 and i == 1:
                time.sleep(0.2)
            x.add_(1)
        x.item()

    def synchronising(frames):
        for _ in frames:
            x.add_(1)
            x.item()

    assert not probe.card_ran_dry(paused_once, None)
    assert len(runs) == 3
    assert probe.card_ran_dry(synchronising, None)


def _decoder_frame(sizes, offsets):
    """A 16 x 16m frame's worth of blocks: the family's chunks, then empty
    ones (code 1)."""
    n = sizes.numel()
    h, w = 16, 16 * -(-n // 6)                 # 6 blocks per 16 x 16
    pad = transform.frame_blocks(h, w) - n
    return (torch.cat([sizes, sizes.new_zeros(pad)]),
            torch.cat([offsets, offsets.new_zeros(pad)]), h, w)


@pytest.mark.parametrize("family", probe.DECODER_FAMILIES)
def test_decoder_families_match_plain(rng, cuda, family):
    """K6 and K2 on each family of ``probe.decoder_families``, with garbage
    between the chunks and packed back to back (the decoders stage a warp's
    chunks one way or the other): coefficients, pixels and err identical to
    the plain versions, K6's codes equal to K2's, and a bad block's
    coefficients 0."""
    stream = probe.decoder_families(rng)[family]
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    for arrays in (stream, probe.back_to_back(*stream)):
        content, sizes, offsets = (torch.from_numpy(a).to(cuda)
                                   for a in arrays)
        got = decode.decode_blocks(content, sizes, offsets)
        for g, p in zip(got, decode.decode_blocks_plain(content, sizes,
                                                        offsets)):
            assert g.is_cuda and torch.equal(g, p)
        assert not got[0][got[1] != 0].any()
        sizes2, offsets2, h, w = _decoder_frame(sizes, offsets)
        k2 = decode.decode_idct_blocks(content, sizes2, offsets2, qt, dct,
                                       h, w)
        for g, p in zip(k2, decode.decode_idct_blocks_plain(
                content, sizes2, offsets2, qt, dct, h, w)):
            assert g.is_cuda and torch.equal(g, p)
        assert torch.equal(k2[3][:sizes.numel()], got[1])


@pytest.mark.parametrize("start", [1, 2, 3])
def test_decoder_reads_content_off_word_boundaries(rng, cuda, start):
    """The decoders stage chunks with word loads from the word boundary
    below them; content that starts off a 4-byte boundary takes the same
    paths with every chunk shifted."""
    fams = probe.decoder_families(rng)
    for family in ("word_crossing", "offsets_outside", "chunk_255"):
        c, s, o = (fams[family] if family == "offsets_outside"
                   else probe.back_to_back(*fams[family]))
        buf = torch.zeros(c.size + 8, dtype=torch.uint8, device=cuda)
        content = buf[start:start + c.size]
        content.copy_(torch.from_numpy(c))
        sizes, offsets = torch.from_numpy(s).to(cuda), torch.from_numpy(
            o).to(cuda)
        for g, p in zip(decode.decode_blocks(content, sizes, offsets),
                        decode.decode_blocks_plain(content, sizes, offsets)):
            assert torch.equal(g, p), family
        sizes2, offsets2, h, w = _decoder_frame(sizes, offsets)
        dct, qt = pipeline.codec_params([90] * 3, cuda)
        for g, p in zip(decode.decode_idct_blocks(content, sizes2, offsets2,
                                                  qt, dct, h, w),
                        decode.decode_idct_blocks_plain(
                            content, sizes2, offsets2, qt, dct, h, w)):
            assert torch.equal(g, p), family


def test_k6_codes_match_k2_on_corrupt_chunks(rng, cuda):
    h, w = 32, 64
    planes = [torch.from_numpy(p).to(cuda) for p in _frame(rng, h, w)]
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    sizes, content = device_stream.compress_frame(*planes, qt, dct)
    content = content.clone()
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    for b, flip in ((0, 2), (5, 0), (9, 3)):
        content[offsets[b] + flip] ^= 0x5A
    sizes = sizes.clone()
    sizes[20] = 2
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    offsets[30] = content.numel() - 2
    offsets[31] = content.numel() + 100
    coeffs, err = decode.decode_blocks(content, sizes, offsets)
    want = decode.decode_blocks_plain(content, sizes, offsets)
    assert torch.equal(coeffs, want[0]) and torch.equal(err, want[1])
    k2 = decode.decode_idct_blocks(content, sizes, offsets, qt, dct, h, w)
    assert torch.equal(err, k2[3]) and err[20] == 1 and err[0] != 0
    assert not coeffs[err != 0].any()


def test_staged_route_and_batch_equal_fused_on_card(rng, cuda):
    from myyuv_tpu_torch.engine import batch
    h, w, b = 64, 128, 3
    dct, qt = pipeline.codec_params([75] * 3, cuda)
    frames = [_frame(rng, h, w) for _ in range(b)]
    staged = device_stream.compress_frame_to_streams(frames[0], qt, dct,
                                                     fused=False)
    fused = device_stream.compress_frame_to_streams(frames[0], qt, dct)
    for (gs, gc), (fs, fc) in zip(staged, fused):
        assert np.array_equal(gs, fs) and np.array_equal(gc, fc)
    for a, f in zip(device_stream.decompress_streams_to_frame(
            fused, qt, dct, h, w, fused=False),
            device_stream.decompress_streams_to_frame(fused, qt, dct, h, w)):
        assert np.array_equal(a, f)
    stack = [np.stack([f[i] for f in frames]) for i in range(3)]
    per_frame = device_stream.compress_batch_to_streams(stack, qt, dct)
    for f in range(b):
        one = device_stream.compress_frame_to_streams(frames[f], qt, dct)
        for (gs, gc), (ws, wc) in zip(per_frame[f], one):
            assert np.array_equal(gs, ws) and np.array_equal(gc, wc)
    t = [torch.from_numpy(p).to(cuda) for p in stack]
    (ry, ru, rv), total, ok = device_stream.roundtrip_batch(*t, qt, dct)
    sizes, content = device_stream.compress_batch(*t, qt, dct)
    assert bool(ok) and int(total) == content.numel()
    for g, r in zip(device_stream.decompress_batch(
            content, sizes, qt, dct, b, h, w), (ry, ru, rv)):
        assert torch.equal(g, r)
    (py, pu, pv), m = batch.roundtrip_step(*t, *qt)
    assert torch.equal(py, ry) and torch.equal(pu, ru)
    assert torch.equal(pv, rv) and int(m["symbol_hist"].sum()) == b * (
        (h // 8) * (w // 8) + 2 * (h // 16) * (w // 16)) * 64
    coeffs = transform.dct_quantize_blocks_plain(
        *[p.view(-1, p.shape[-1]) for p in t], qt, dct)
    sym = coeffs.cpu().numpy().astype(np.int32).ravel() + 1024
    counted = np.bincount(sym[(sym >= 0) & (sym < batch.NUM_SYMBOLS)],
                          minlength=batch.NUM_SYMBOLS)
    assert np.array_equal(m["symbol_hist"].cpu().numpy(), counted)


def _same_conversions(px, planes):
    """X1 on BGRX ``px`` and X2 on ``planes`` and on X1's planes, each
    against its plain version."""
    got = convert.bgrx_to_iyuv(px)
    for g, p in zip(got, kdev.bgrx_to_iyuv(px)):
        assert g.is_cuda and torch.equal(g, p)
    for y, u, v in (got, planes):
        g = convert.iyuv_to_bgrx(y, u, v)
        assert g.is_cuda and torch.equal(g, kdev.iyuv_to_bgrx(y, u, v))


def test_convert_every_colour_and_every_triple(rng, cuda):
    """X1 on a frame holding each 24-bit colour once and X2 on planes
    holding each (Y, U, V) triple once: the whole input domains."""
    px = torch.from_numpy(probe.every_colour_bgrx(rng)).to(cuda)
    planes = [torch.from_numpy(p).to(cuda) for p in probe.every_yuv_triple()]
    _same_conversions(px, planes)


def test_convert_batch_of_1080p_frames(rng, cuda):
    """8 x 1088x1920, as the batch API holds frames: X1 on [8, H, W, 4],
    X2 on [8, H, W] planes with each frame's own chroma."""
    b, h, w = 8, 1088, 1920
    px = torch.from_numpy(rng.integers(0, 256, (b, h, w, 4), np.uint8)
                          ).to(cuda)
    planes = [torch.from_numpy(rng.integers(0, 256, s, np.uint8)).to(cuda)
              for s in ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2))]
    _same_conversions(px, planes)


@pytest.mark.parametrize("lead,h,w", [
    ((), 15, 17), ((3,), 15, 17), ((2,), 16, 17), ((2,), 15, 16),
    ((), 1, 1), ((4,), 3, 5), ((2, 3), 34, 66), ((), 6, 10)])
def test_convert_odd_and_ragged_sizes(rng, cuda, lead, h, w):
    """X2 on odd H or W, in a batch too (a frame never reads the next
    frame's chroma), and on W not a multiple of 4 (the byte-wise
    instance); X1 on the even sizes among them."""
    hc, wc = (h + 1) // 2, (w + 1) // 2
    planes = [torch.from_numpy(rng.integers(0, 256, (*lead, *s), np.uint8)
                               ).to(cuda) for s in ((h, w), (hc, wc),
                                                    (hc, wc))]
    got = convert.iyuv_to_bgrx(*planes)
    assert got.shape == (*lead, h, w, 4)
    assert torch.equal(got, kdev.iyuv_to_bgrx(*planes))
    if h % 2 == 0 and w % 2 == 0:
        px = torch.from_numpy(rng.integers(0, 256, (*lead, h, w, 4),
                                           np.uint8)).to(cuda)
        for g, p in zip(convert.bgrx_to_iyuv(px), kdev.bgrx_to_iyuv(px)):
            assert torch.equal(g, p)


@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_convert_reads_inputs_off_16_byte_boundaries(rng, cuda, offset):
    """Inputs that start off the 16-, 8- and 4-byte boundaries the vector
    accesses need take the byte-wise instance of the same kernel."""
    h, w = 64, 96

    def at_offset(shape):
        n = int(np.prod(shape))
        buf = torch.zeros(n + 32, dtype=torch.uint8, device=cuda)
        t = buf[offset:offset + n].view(shape)
        t.copy_(torch.from_numpy(rng.integers(0, 256, shape, np.uint8)))
        return t

    px = at_offset((h, w, 4))
    planes = [at_offset(s) for s in ((h, w), (h // 2, w // 2),
                                     (h // 2, w // 2))]
    assert px.data_ptr() % 16 and planes[0].data_ptr() % 16
    _same_conversions(px, planes)


def test_convert_counts_its_launches(rng, cuda):
    px = torch.from_numpy(rng.integers(0, 256, (32, 64, 4), np.uint8)
                          ).to(cuda)
    before = dict(build.launches)
    convert.iyuv_to_bgrx(*convert.bgrx_to_iyuv(px))
    assert build.launches["bgrx_to_iyuv"] == before["bgrx_to_iyuv"] + 1
    assert build.launches["iyuv_to_bgrx"] == before["iyuv_to_bgrx"] + 1


def _stream_frames(rng, n, h, w):
    return [[probe.content_kind(rng, probe.KINDS[f % len(probe.KINDS)], s)
             for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
            for f in range(n)]


@pytest.mark.parametrize("depth", [1, 3])
def test_streaming_drivers_equal_frame_api(rng, cuda, depth):
    """roundtrip_stream, ingest_stream, preview_stream and compress_stream
    on the card: flags all True, totals and bytes those of the frame API,
    and ingest_frame / preview_frame equal to X1 + compress_frame and to
    decompress_frame + X2."""
    h, w = 256, 512
    frames = _stream_frames(rng, 7, h, w)
    dct, qt = pipeline.codec_params([75] * 3, cuda)
    dev = [device_stream.to_device(f, cuda) for f in frames]
    want = [device_stream.compress_frame_to_streams(f, qt, dct)
            for f in frames]
    totals = [sum(int(c.size) for _, c in st) for st in want]
    ok, tot, _ = streaming.roundtrip_stream(dev, qt, dct)
    assert ok.all() and tot.tolist() == totals
    px = [convert.iyuv_to_bgrx(*d) for d in dev]
    ok, tot, _ = streaming.ingest_stream(px, qt, dct)
    for p, t in zip(px, tot):
        sizes, content = device_stream.compress_frame(
            *convert.bgrx_to_iyuv(p), qt, dct)
        got = device_stream.ingest_frame(p, qt, dct)
        assert torch.equal(got[0], sizes) and int(got[2]) == t
        assert torch.equal(got[1][:t], content) and bool(got[3])
    assert ok.all()
    sizes, content = device_stream.compress_frame(*dev[0], qt, dct)
    ok, _ = streaming.preview_stream((content, sizes), qt, dct, h, w, 5)
    bgrx, pok = device_stream.preview_frame(content, sizes, qt, dct, h, w)
    assert ok.all() and bool(pok) and torch.equal(
        bgrx, convert.iyuv_to_bgrx(*device_stream.decompress_frame(
            content, sizes, qt, dct, h, w)))
    got = list(streaming.compress_stream(dev, qt, dct, depth=depth))
    assert len(got) == len(frames)
    for streams, ws in zip(got, want):
        for (gs, gc), (ss, sc) in zip(streams, ws):
            assert np.array_equal(gs, ss) and np.array_equal(gc, sc)


def test_streaming_roundtrip_queues_16_frames_without_a_host_sync(rng,
                                                                   cuda):
    """roundtrip_stream and ingest_stream take 16 frames while a sleep
    kernel queued before them still runs: nothing they do before the drain
    waits for the card."""
    h, w = 1088, 1920
    frame = device_stream.to_device(_stream_frames(rng, 1, h, w)[0], cuda)
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    assert not probe.card_ran_dry(
        lambda fs: streaming.roundtrip_stream(fs, qt, dct), frame)
    px = convert.iyuv_to_bgrx(*frame)
    assert not probe.card_ran_dry(
        lambda fs: streaming.ingest_stream(fs, qt, dct), px)


def _scan_stack(frames, dev):
    return [torch.from_numpy(np.stack([f[i] for f in frames])).to(dev)
            for i in range(3)]


def test_scan_graph_replay_equals_eager_frames(rng, cuda, monkeypatch):
    """roundtrip_scan on the card: the first call captures one graph of K
    round trips, recording K launches of K1 and K of K2; every call is one
    replay of it, with no kernel launched from Python (``build.launch``
    refuses) and nothing added to the counts; totals and oks equal K eager
    roundtrip_frame calls, also when the next call brings other frames."""
    k, h, w = 3, 256, 512
    dct, qt = pipeline.codec_params([75] * 3, cuda)
    first, second = (_scan_stack(_stream_frames(rng, k, h, w), cuda)
                     for _ in range(2))
    device_stream.clear_scan_graphs()
    totals, oks = device_stream.roundtrip_scan(*first, qt, dct)
    graph = device_stream.scan_graph(k, h, w, first[0].device)
    assert graph.replays == 1
    assert graph.launches == {"dct_encode": k, "decode_idct": k}

    def eager(ys, us, vs):
        outs = [device_stream.roundtrip_frame(ys[i], us[i], vs[i], qt, dct)
                for i in range(k)]
        return [int(o[3]) for o in outs], [bool(o[4]) for o in outs]

    want_first, want_second = eager(*first), eager(*second)
    assert (totals.tolist(), oks.tolist()) == want_first
    assert all(want_first[1]) and all(want_second[1])

    def no_launch(*args):
        raise AssertionError("a scan launched a kernel from Python")

    before = dict(build.launches)
    monkeypatch.setattr(build, "launch", no_launch)
    for stack, want in ((second, want_second), (first, want_first)):
        totals, oks = device_stream.roundtrip_scan(*stack, qt, dct)
        assert (totals.tolist(), oks.tolist()) == want
    assert graph.replays == 3
    assert build.launches == before
    device_stream.clear_scan_graphs()


def test_scan_graph_reads_each_calls_tables(rng, cuda):
    """q50 then q90 scans of the same frames back to back on one cached
    graph: each call's totals are those of roundtrip_frame at its own
    quality (a graph reading the captured tables would repeat q50's)."""
    k, h, w = 2, 256, 512
    stack = _scan_stack(_stream_frames(rng, k, h, w), cuda)
    device_stream.clear_scan_graphs()
    seen = []
    for q in (50, 90, 50):
        dct, qt = pipeline.codec_params([q] * 3, cuda)
        totals, oks = device_stream.roundtrip_scan(*stack, qt, dct)
        want = [int(device_stream.roundtrip_frame(
            stack[0][i], stack[1][i], stack[2][i], qt, dct)[3])
            for i in range(k)]
        assert totals.tolist() == want and oks.all()
        seen.append(want)
    assert seen[0] == seen[2] != seen[1]
    assert device_stream.scan_graph(k, h, w, stack[0].device).replays == 3
    device_stream.clear_scan_graphs()


def test_scan_stream_queues_16_scans_without_a_host_sync(rng, cuda):
    """roundtrip_scan_stream (the loop of sustained_scan_fps) takes 16
    scans while a sleep kernel queued before them still runs; then
    sustained_scan_fps itself reports every frame ok and the frame API's
    total."""
    h, w = 1088, 1920
    frame = _stream_frames(rng, 1, h, w)[0]
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    stack = _scan_stack([frame] * 4, cuda)
    assert not probe.card_ran_dry(
        lambda stacks: streaming.roundtrip_scan_stream(stacks, qt, dct),
        stack)
    fps, ok, total = streaming.sustained_scan_fps(frame, qt, dct,
                                                  n_frames=16, k=4)
    sizes, _ = device_stream.compress_frame(
        *device_stream.to_device(frame, cuda), qt, dct)
    assert ok and fps > 0 and total == int(sizes.sum())
    device_stream.clear_scan_graphs()


def test_sweep_rate_routes_agree_on_card(rng, cuda):
    """quality_sweep at 1920x1088 on the card: K3 then K5 and K1 give the
    same bytes, which the plain versions on the CPU give too; the device
    rates are there and positive; PSNR and bytes rise with the quality."""
    from myyuv_tpu_torch.engine import sweep
    from myyuv_tpu_torch.tools import rd_sweep

    qs = (10, 50, 90)
    planes = rd_sweep.picture_planes(rng, (1088, 1920), cuda)
    coder = sweep.quality_sweep(planes, qs, None, device=cuda)
    frame = sweep.quality_sweep(planes, qs, "device", time_device=True,
                                device=cuda)
    plain = sweep.quality_sweep(planes, qs, "device", device="cpu")
    for c, f, p in zip(coder, frame, plain):
        assert (c["compressed_bytes"] == f["compressed_bytes"]
                == p["compressed_bytes"])
        assert c["psnr_y_db"] == f["psnr_y_db"]
        assert abs(f["psnr_y_db"] - p["psnr_y_db"]) <= 1e-3 + 1e-9
        assert all(f[k] > 0 for k in ("device_encode_fps",
                                      "device_decode_fps",
                                      "device_roundtrip_fps"))
    for key in ("psnr_y_db", "compressed_bytes"):
        seq = [f[key] for f in frame]
        assert seq == sorted(seq), key


# ---- T1-T7: the probes of myyuv_tpu_torch/tools/ and the tree stage ----

@pytest.mark.parametrize("family", probe.DECODER_FAMILIES)
def test_tree_stage_families_match_plain(rng, cuda, family):
    """T5 on each decoder family, with gaps and back to back: symbols,
    counts and codes identical to the plain version; its codes are K6's
    where K6 found a bad tree (1..4), else 0."""
    from myyuv_tpu_torch.tools.exp_r3stage import tree_codes_agree
    stream = probe.decoder_families(rng)[family]
    for arrays in (stream, probe.back_to_back(*stream)):
        content, sizes, offsets = (torch.from_numpy(a).to(cuda)
                                   for a in arrays)
        got = decode.parse_trees(content, sizes, offsets)
        for g, p in zip(got, decode.parse_trees_plain(content, sizes,
                                                      offsets)):
            assert g.is_cuda and torch.equal(g, p), family
        assert tree_codes_agree(got[2], decode.decode_blocks(
            content, sizes, offsets)[1]), family


@pytest.mark.parametrize("q", [1, 50, 90, 100])
def test_tree_stage_on_frames_matches_plain(rng, cuda, q):
    """T5 on the streams of 736x992 frames of every content kind."""
    dct, qt = pipeline.codec_params([q] * 3, cuda)
    for kind in probe.KINDS:
        planes = _kind_planes(rng, kind, 736, 992, cuda)
        sizes, content = device_stream.compress_frame(*planes, qt, dct)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        got = decode.parse_trees(content, sizes, offsets)
        for g, p in zip(got, decode.parse_trees_plain(content, sizes,
                                                      offsets)):
            assert torch.equal(g, p), kind
        assert not got[2].any()


@pytest.mark.parametrize("shape", [(3, 4), (5, 64), (16, 1024), (2, 8192),
                                   (64, 4032)])
def test_lane_shuffle_matches_plain(rng, cuda, shape):
    """T1 on random perms of 2 to 13 bits, and through the pack and unpack
    relayouts of a luma plane."""
    from myyuv_tpu_torch.tools import exp_shuffle as t1
    r, w = shape
    p = 1 << (w - 1).bit_length()
    nbits = p.bit_length() - 1
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (r, p),
                                      dtype=np.int64).astype(np.int32))
    for perm in (tuple(rng.permutation(nbits).tolist()),
                 t1.pack_perm(nbits) if nbits > 4 else tuple(range(nbits))):
        got = t1.lane_shuffle(x.to(cuda), perm)
        assert torch.equal(got.cpu(), t1.lane_shuffle_plain(x, perm))
    if w % 64 == 0 and r % 8 == 0:
        plane = torch.from_numpy(rng.integers(0, 256, (r, w),
                                              np.uint8)).to(cuda)
        words = t1.pack_plane_fast(plane)
        assert torch.equal(words.cpu(), t1.pack_plane_fast(plane.cpu()))
        assert torch.equal(t1.unpack_plane_fast(words, r, w), plane)


def test_probe_kernels_match_plain(rng, cuda):
    """T2, T3, T4, T6 and T7 against their plain versions, bit for bit, at
    small sizes and at the tools' own."""
    from myyuv_tpu_torch.tools import (check_bitexact, exp_bcast,
                                       exp_fma, exp_r4lane, exp_sublane)
    for rows, cols in ((64, 256), (3, 8), (7, 1000)):
        x = torch.from_numpy(rng.standard_normal((rows, cols))
                             .astype(np.float32)).to(cuda)
        q = torch.from_numpy(rng.standard_normal((rows, 1))
                             .astype(np.float32)).to(cuda)
        assert torch.equal(exp_bcast.bcast_mul(x, q),
                           exp_bcast.bcast_mul_plain(x, q))
    for rows, cols in ((16, 256), (1, 8), (3, 8200), (512, 8192)):
        x = torch.from_numpy(rng.integers(-2**31, 2**31, (rows, cols),
                                          dtype=np.int64)
                             .astype(np.int32)).to(cuda)
        for op in exp_r4lane.OPS:
            assert torch.equal(exp_r4lane.lane_probe(x, op),
                               exp_r4lane.lane_probe_plain(x, op)), op
    a, b, c = (torch.from_numpy(v).to(cuda) for v in exp_fma.inputs())
    for form in exp_fma.FORMS:
        assert exp_fma.differ(exp_fma.fma_form(a, b, c, form),
                              exp_fma.fma_form_plain(a, b, c, form)) == 0
    for nblocks in (1024, 8 * 1001):
        w1 = exp_sublane.table(cuda, nblocks)
        w8 = exp_sublane.to_rows8(w1)
        o1 = exp_sublane.consume_chain(w1, 1)
        assert torch.equal(o1, exp_sublane.consume_chain_plain(w1, 1))
        assert torch.equal(exp_sublane.rows8_order(
            exp_sublane.consume_chain(w8, 8)), o1)
    for cols in (4, 1024, 1028):
        x = torch.from_numpy(rng.standard_normal((64, cols))
                             .astype(np.float32) * 128).to(cuda)
        cf = torch.from_numpy(rng.standard_normal(8).astype(np.float32)
                              ).to(cuda)
        assert torch.equal(check_bitexact.dct_chain(x, cf),
                           check_bitexact.dct_chain_plain(x, cf))


def test_probe_tools_on_the_card(cuda):
    """Each tool at its own size: the kernels equal their plain versions,
    bare equals rounded (the build keeps -fmad=false), fused differs, the
    chain equals the host's double-rounded sequence, both T6 layouts
    agree, each tool's largest difference from the plain version is 0, and
    every tool times its kernel, no faster than its bound."""
    from myyuv_tpu_torch.tools import (check_bitexact, exp_bcast, exp_fma,
                                       exp_r3stage, exp_r4lane,
                                       exp_shuffle, exp_sublane)
    fma = exp_fma.run(cuda)
    assert fma["bare_vs_rounded"] == 0 and fma["fused_vs_rounded"] > 0
    assert fma["bare_equals_host"] and all(fma["plain_exact"].values())
    assert check_bitexact.run(cuda)["failed"] == []
    assert exp_bcast.run(cuda)["exact"]
    assert all(exp_r4lane.run(cuda)["exact"].values())
    sub = exp_sublane.run(cuda)
    assert sub["exact"] and sub["layouts_equal"]
    shuffle = exp_shuffle.run(cuda)
    assert shuffle["pack_exact"] and shuffle["unpack_exact"]
    stage = exp_r3stage.run(cuda)
    split = exp_r3stage.times(cuda)
    for frame in ("cli", "noise"):
        assert stage[frame]["exact"] and stage[frame]["codes_agree"]
        assert 0 < split[frame]["T5"] < split[frame]["K2"]
        row = split[frame]["T5_row"]
        assert row["ms"] >= row["bound_ms"] > 0
    assert all(mod.run(cuda)["max_abs_err"] == 0 for mod in (
        exp_bcast, exp_fma, exp_r4lane, exp_shuffle, exp_sublane,
        check_bitexact, exp_r3stage))
    for mod in (exp_bcast, exp_fma, exp_r4lane, exp_shuffle, exp_sublane,
                check_bitexact):
        for t in mod.times(cuda).values():
            assert isinstance(t, float) or t["ms"] >= t["bound_ms"] > 0


def test_probe_tools_end_with_an_error_when_a_launch_fails(cuda,
                                                           monkeypatch):
    """A kernel that does not launch ends each tool with an error: no tool
    falls back to the plain version."""
    from myyuv_tpu_torch.tools import (check_bitexact, exp_bcast, exp_fma,
                                       exp_r3stage, exp_r4lane,
                                       exp_shuffle, exp_sublane)

    def refuse(name, *args):
        raise RuntimeError(f"{name} kernel launch failed: refused")

    monkeypatch.setattr(build, "launch", refuse)
    for main in (exp_shuffle.main, exp_bcast.main, exp_r4lane.main,
                 exp_fma.main, exp_r3stage.main, exp_sublane.main,
                 check_bitexact.main):
        with pytest.raises(RuntimeError, match="launch failed"):
            main(["--device", "cuda"])


def test_k1_launches_on_a_second_card(rng):
    """``build.launch`` makes the tensor's card current: K1 on cuda:1 while
    cuda:0 is current equals its plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    planes = [torch.from_numpy(p).to(dev) for p in _frame(rng, 64, 128)]
    dct, qt = pipeline.codec_params([50] * 3, dev)
    with torch.cuda.device(0):
        got = encode.dct_encode_blocks(*planes, qt, dct)
    torch.cuda.synchronize(dev)
    for g, p in zip(got, encode.dct_encode_blocks_plain(*planes, qt, dct)):
        assert g.device == dev and torch.equal(g, p)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (8, 1)])
@pytest.mark.parametrize("h,w", [(64, 128), (48, 64), (32, 384)])
def test_sharded_frame_on_a_repeated_card(rng, cuda, shape, h, w):
    """The sharded frame codec on a mesh of the card repeated: streams and
    planes equal the single-device frame API's, K1 and K2 launched once a
    shard."""
    from myyuv_tpu_torch.engine import sharded_stream
    from myyuv_tpu_torch.parallel import mesh as meshlib
    n = shape[0] * shape[1]
    mesh = meshlib.make_mesh(shape, [cuda] * n)
    planes = [p.copy() for p in _frame(rng, h, w)]
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    qts = list(qt.cpu().numpy())
    before = dict(build.launches)
    streams = sharded_stream.compress_frame_sharded(mesh, planes, qts)
    assert build.launches["dct_encode"] - before["dct_encode"] == n
    want = device_stream.compress_frame_to_streams(planes, qt, dct)
    for (gs, gc), (ws, wc) in zip(streams, want):
        assert np.array_equal(gs, ws) and np.array_equal(gc, wc)
    before = dict(build.launches)
    got = sharded_stream.decompress_frame_sharded(mesh, streams, qts, h, w)
    assert build.launches["decode_idct"] - before["decode_idct"] == n
    ref = device_stream.decompress_streams_to_frame(want, qt, dct, h, w)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)


def test_sharded_roundtrip_and_dryrun_on_the_card(rng, cuda):
    from myyuv_tpu_torch import entry
    from myyuv_tpu_torch.engine import batch
    from myyuv_tpu_torch.parallel import mesh as meshlib
    b, h, w = 4, 64, 128
    y, u, v = (torch.from_numpy(rng.integers(0, 256, s, np.uint8)).to(cuda)
               for s in ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2)))
    qts = batch.plane_qtables([50, 60, 70], cuda)
    step = batch.make_sharded_roundtrip(meshlib.make_mesh((2, 2), [cuda] * 4))
    got, m = step(y, u, v, *qts)
    want, wm = batch.roundtrip_step(y, u, v, *qts)
    for g, p in zip(got, want):
        assert g.is_cuda and torch.equal(g, p)
    assert torch.equal(m["symbol_hist"], wm["symbol_hist"])
    for k in ("sse_y", "sse_u", "sse_v"):
        assert torch.isclose(m[k], wm[k], rtol=1e-6, atol=0)
    assert entry.dryrun_multichip(8)["q95_largest_chunk"] > 64


def test_cube_on_the_card_matches_the_cpu(cuda):
    """render_scene on the card against the CPU, to the share of differing
    pixels test_torch_cube.py holds the CPU to against the JAX package."""
    from myyuv_tpu_torch.viewer import cube
    rng = np.random.default_rng(11)
    tex = rng.integers(0, 256, (96, 128, 4), np.uint8)
    verts, tris, uvs = cube.shape_geometry(128, 96)
    pos = cube.generate_shape_positions(8, np.random.default_rng(0))
    cam = cube.Camera()
    r = cube.generation_radius(8)
    cam.pos = np.array([r * 2.5 + 3, 0, r * 2.5 + 3], np.float32)
    cam.yaw = -135.0
    cam.update()
    h, w = 800, 1000
    args = (tex, verts, tris, uvs, pos, np.full(8, 30.0, np.float32),
            cam.view(), cube.perspective(aspect=w / h))
    frames = [cube.render_scene(*(torch.from_numpy(np.ascontiguousarray(a))
                                  .to(d) for a in args), h, w).cpu()
              for d in (cuda, torch.device("cpu"))]
    share = float((frames[0] != frames[1]).any(-1).float().mean())
    print(f"cube card vs CPU: share of differing pixels {share:.3g}")
    assert share <= 1e-3


# precision="fast": F1 and F2 against their plain versions (exact: the same
# FMA chains), and the routes that run them. Against K3 and K4: within +-1,
# on noise in at most FAST_COEF_SHARE of the coefficients and
# FAST_PIXEL_SHARE of the pixels (tests/test_torch_fast.py gives the
# reason): FMA and the exact chains differ where a value lies within a few
# ulps of a rounding tie.
FAST_COEF_SHARE, FAST_PIXEL_SHARE = 1e-3, 1e-4


def _fast_within(got, want, share=None):
    """|got - want| <= 1, and, given ``share``, differing in at most that
    share of the values (held on noise of 4,096 blocks or more only: the
    contraction-probe blocks are built to sit on rounding ties)."""
    d = (got.to(torch.int32) - want.to(torch.int32)).abs()
    assert int(d.max()) <= 1
    if share is not None:
        frac = float((d != 0).double().mean())
        assert frac <= share, frac


# the layouts F1 and F2 take besides whole frames of their own: 968-byte
# chroma rows (no multiple of 16 bytes), planes that start off every
# 8-byte boundary (the byte loads and stores), a batch of 3 frames as 3 H
# rows, and 90 blocks, which leave a partial last round for some warps
_FAST_LAYOUTS = ["frames", "chroma_rows_968", "odd_offsets", "batch_of_3",
                 "partial_round"]


def _views_at(rng, shapes, offset, cuda):
    """Random u8 planes of ``shapes`` on the card, each a view that starts
    ``offset`` + its index bytes into a buffer of its own."""
    out = []
    for i, (h, w) in enumerate(shapes):
        buf = torch.from_numpy(rng.integers(0, 256, h * w + 16,
                                            np.uint8)).to(cuda)
        out.append(buf[offset + i:offset + i + h * w].view(h, w))
    return out


@pytest.mark.parametrize("layout", _FAST_LAYOUTS)
@pytest.mark.parametrize("q", [1, 10, 50, 90, 100])
def test_fast_f1_f2_match_plain(rng, cuda, q, layout):
    """F1 and F2 (``-k fast``) equal to their plain versions. ``frames``: on
    noise and on the contraction-probe frame, at the transform test shapes
    and at 736x992, and F2 on random int16 rows, also within +-1 of K3 /
    K4; the shares against K3 / K4 are held on noise at q 10, 50 and 90,
    where they were measured (at q100, a table of ones, 1.4e-3 of the noise
    frame's coefficients sit close enough to a tie to differ). The other
    layouts (``_FAST_LAYOUTS``): F1 on the layout's planes, F2 on F1's
    coefficients and on random rows, into planes of the same layout."""
    dct, qt = pipeline.codec_params([q] * 3, cuda)
    if layout != "frames":
        h, w, offset = {"chroma_rows_968": (1088, 1936, 0),
                        "odd_offsets": (48, 80, 1),
                        "batch_of_3": (3 * 1088, 1920, 0),
                        "partial_round": (48, 80, 0)}[layout]
        shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
        planes = _views_at(rng, shapes, offset, cuda)
        coeffs = transform.fast_dct_quantize_blocks(*planes, qt, dct)
        assert coeffs.is_cuda and torch.equal(
            coeffs, transform.fast_dct_quantize_blocks_plain(*planes, qt,
                                                             dct))
        rows = torch.from_numpy(rng.integers(
            -2048, 2048, coeffs.shape).astype(np.int16)).to(cuda)
        for c in (coeffs, rows):
            got = _views_at(rng, shapes, offset, cuda)
            build.launch("fast_dequantize_idct", cuda, c.data_ptr(), h, w,
                         qt.data_ptr(), dct.data_ptr(),
                         *(g.data_ptr() for g in got))
            for g, p in zip(got, transform.fast_dequantize_idct_blocks_plain(
                    c, qt, dct, h, w)):
                assert torch.equal(g, p), layout
        return
    for (h, w), kind in [(s, _frame) for s in _TRANSFORM_SHAPES] + [
            ((736, 992), _frame), ((736, 992), _noise_frame)]:
        noise = kind is _noise_frame and q in (10, 50, 90)
        cs, ps = (FAST_COEF_SHARE, FAST_PIXEL_SHARE) if noise else (None,
                                                                    None)
        planes = [torch.from_numpy(p).to(cuda) for p in kind(rng, h, w)]
        coeffs = transform.fast_dct_quantize_blocks(*planes, qt, dct)
        assert coeffs.is_cuda and coeffs.dtype == torch.int16
        assert torch.equal(coeffs, transform.fast_dct_quantize_blocks_plain(
            *planes, qt, dct))
        _fast_within(coeffs, transform.dct_quantize_blocks(*planes, qt, dct),
                     cs)
        rows = torch.from_numpy(rng.integers(
            -2048, 2048, coeffs.shape).astype(np.int16)).to(cuda)
        for c in (coeffs, rows):
            got = transform.fast_dequantize_idct_blocks(c, qt, dct, h, w)
            for g, p, e in zip(
                    got, transform.fast_dequantize_idct_blocks_plain(
                        c, qt, dct, h, w),
                    transform.dequantize_idct_blocks(c, qt, dct, h, w)):
                assert g.is_cuda and torch.equal(g, p)
                _fast_within(g, e, ps)


def _noise_frame(rng, h, w):
    return [rng.integers(0, 256, s, np.uint8)
            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


def test_fast_routes_launch_f1_k5_k6_f2(rng, cuda, monkeypatch):
    """The fast frame and scan routes on the card launch F1 then K5 and K6
    then F2 and nothing else, never the plain versions; their streams
    decode to F1's coefficients, and a fast scan's graph records K of each
    of the four."""
    h, w = 256, 512
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    planes = [torch.from_numpy(p).to(cuda) for p in _noise_frame(rng, h, w)]

    def refuse(*args, **kwargs):
        raise AssertionError("a plain fast transform ran on the card")

    monkeypatch.setattr(transform, "fast_dct_quantize_blocks_plain", refuse)
    monkeypatch.setattr(transform, "fast_dequantize_idct_blocks_plain",
                        refuse)

    def counted(fn):
        before = dict(build.launches)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: n - before[k] for k, n in build.launches.items()
                     if n != before[k]}

    coeffs = transform.fast_dct_quantize_blocks(*planes, qt, dct)
    (sizes, content), n = counted(lambda: device_stream.compress_frame(
        *planes, qt, dct, precision="fast"))
    assert n == {"fast_dct_quantize": 1, "huffman_encode": 1}
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    assert torch.equal(decode.decode_blocks(content, sizes, offsets)[0],
                       coeffs)
    rec, n = counted(lambda: device_stream.decompress_frame(
        content, sizes, qt, dct, h, w, fused=True, precision="fast"))
    assert n == {"huffman_decode": 1, "fast_dequantize_idct": 1}
    want = transform.fast_dequantize_idct_blocks(coeffs, qt, dct, h, w)
    assert all(torch.equal(g, p) for g, p in zip(rec, want))
    out, n = counted(lambda: device_stream.roundtrip_frame(
        *planes, qt, dct, precision="fast"))
    assert n == {"fast_dct_quantize": 1, "huffman_encode": 1,
                 "huffman_decode": 1, "fast_dequantize_idct": 1}
    assert all(torch.equal(g, p) for g, p in zip(out[:3], want))
    assert int(out[3]) == content.numel() and bool(out[4])
    k = 3
    stack = [p.expand(k, *p.shape).contiguous() for p in planes]
    device_stream.clear_scan_graphs()
    totals, oks = device_stream.roundtrip_scan(*stack, qt, dct, "fast")
    graph = device_stream.scan_graph(k, h, w, stack[0].device, "fast")
    assert graph.launches == {"fast_dct_quantize": k, "huffman_encode": k,
                              "huffman_decode": k,
                              "fast_dequantize_idct": k}
    assert totals.tolist() == [content.numel()] * k and oks.all()
    assert device_stream.scan_graph(k, h, w, stack[0].device).graph is None
    device_stream.clear_scan_graphs()


def test_plain_fast_transform_ignores_the_tf32_flag(rng, cuda):
    """F1's plain version on the card gives the same coefficients with
    ``allow_tf32`` True and False: it runs no matmul."""
    h, w = 256, 512
    dct, qt = pipeline.codec_params([90] * 3, cuda)
    planes = [torch.from_numpy(p).to(cuda) for p in _noise_frame(rng, h, w)]
    saved = torch.backends.cuda.matmul.allow_tf32
    outs = []
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            outs.append(transform.fast_dct_quantize_blocks_plain(
                *planes, qt, dct))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(outs[0], outs[1])
