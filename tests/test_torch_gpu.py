"""The CUDA kernels K1-K6, X1, X2 and T1-T7 against their plain PyTorch
versions on the card, the staged route and batch API against the fused
route, and the streaming drivers against the frame API, ``roundtrip_scan``
against K round trips and the sweep's two rate routes against each
other. Marked ``gpu``: they skip where no CUDA device is
present, and run with ``python -m pytest tests/test_torch_gpu.py`` on a
machine with one (``-k convert`` for X1 and X2, ``-k streaming`` for the
drivers, ``-k "scan or sweep"`` for the scan and the sweep, ``-k "tree or
probe or lane"`` for T1-T7, ``-k "sharded or card"`` for the multi-device
path, the second card and the cube, ``-k fast`` for F1 and F2,
``-k encphase`` for K1's measurement instances and the production
encoders' recorded SASS, ``-k trace`` for the span recorder's waits and
pageable bytes, ``-k compact`` for the compaction C1).

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
from myyuv_tpu_torch.runtime.errors import BitstreamError

import front_cases

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


# K1's frame for each front case (tests/front_cases.py): plane content
# ("mixed": noise, every other block of a row flat), and the quantizer: q at
# the first n zigzag positions and 4096, which zeroes any coefficient,
# after them. Messages then end at n where the content has detail; the
# int16 ends lie beyond a DCT's range, so that case takes the widest
# symbols q = 1 gives.
_K1_FRONT = {
    **{f"msg_len_{n}": ("noise", 1, n) for n in front_cases.MSG_LENS},
    "distinct_64": ("noise", 1, 64), "all_equal": ("flat", 1, 64),
    "tied_frequencies": ("noise", 64, 64),
    "int16_ends_padded": ("noise", 1, 9), "mixed_warp": ("mixed", 1, 33),
}


def _front_plane(rng, kind, shape):
    p = probe.content_kind(rng, "flat" if kind == "flat" else "noise", shape)
    if kind == "mixed":
        p[:, np.arange(shape[1]) // 8 % 2 == 0] = 128
    return p


@pytest.mark.parametrize("case", front_cases.FRONT_CASES)
def test_encoder_front_cases_match_plain(cuda, case):
    """K5 on each of the front's block sets, and K1 and its ``frontonly``
    instance on a frame whose quantizer reaches the set's message lengths:
    lanes, sizes and err identical to the plain versions."""
    rng = np.random.default_rng(20)
    coeffs = torch.from_numpy(front_cases.front_blocks(rng, case)).to(cuda)
    got = encode.encode_blocks(coeffs)
    for g, p in zip(got, edev.encode_lanes(coeffs)):
        assert g.is_cuda and torch.equal(g, p)
    kind, q, kept = _K1_FRONT[case]
    h, w = 48, 80
    planes = [torch.from_numpy(_front_plane(rng, kind, s)).to(cuda)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    qt = torch.full((3, 64), 4096.0)
    qt[:, torch.from_numpy(edev.ZIGZAG[:kept].astype(np.int64))] = float(q)
    qt = qt.view(3, 8, 8).to(cuda)
    dct, _ = pipeline.codec_params([50] * 3, cuda)
    args = (*planes, qt, dct)
    for g, p in zip(encode.dct_encode_blocks(*args),
                    encode.dct_encode_blocks_plain(*args)):
        assert g.is_cuda and torch.equal(g, p)
    for g, p in zip(encode.dct_encode_phase(*args, "frontonly"),
                    encode.dct_encode_phase_plain(*args, "frontonly")):
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
    """The staged route composed from the K3, K5, C1, K6 and K4 wrappers
    equals the frame route's K1 and K2; the batch API equals the frame
    API."""
    from myyuv_tpu_torch.engine import batch
    h, w, b = 64, 128, 3
    dct, qt = pipeline.codec_params([75] * 3, cuda)
    frames = [_frame(rng, h, w) for _ in range(b)]
    lanes, sizes, err = encode.encode_blocks(transform.dct_quantize_blocks(
        *device_stream.to_device(frames[0], cuda), qt, dct))
    assert not err.any()
    staged = device_stream.split_planes(
        device_stream.to_host(sizes),
        device_stream.to_host(device_stream.compact_chunks(lanes, sizes)),
        h, w)
    fused = device_stream.compress_frame_to_streams(frames[0], qt, dct)
    for (gs, gc), (fs, fc) in zip(staged, fused):
        assert np.array_equal(gs, fs) and np.array_equal(gc, fc)
    content, sizes = device_stream.streams_to_device(fused, cuda)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    coeffs, err = decode.decode_blocks(content, sizes, offsets)
    assert not err.any()
    for a, f in zip(transform.dequantize_idct_blocks(coeffs, qt, dct, h, w),
                    device_stream.decompress_streams_to_frame(fused, qt, dct,
                                                              h, w)):
        assert np.array_equal(device_stream.to_host(a), f)
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


@pytest.mark.parametrize("depth", [1, 3])
def test_streaming_compress_stream_of_bgrx_and_its_trace(rng, cuda, depth):
    """compress_stream on BGRX frames in device memory (random and
    saturated colours): the streams of X1 followed by
    ``compress_frame_to_streams``, on the card and on the CPU; with the
    recorder on, one ingest span and one wait of each kind a frame, and the
    exact bytes of every pinned pull (the head: seven int64 and the u8
    sizes; the stream)."""
    from myyuv_tpu_torch.runtime import trace
    h, w = 256, 512
    px = [torch.from_numpy(f).to(cuda) for f in np.concatenate([
        rng.integers(0, 256, (3, h, w, 4)),
        255 * rng.integers(0, 2, (3, h, w, 4))]).astype(np.uint8)]
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    dct_c, qt_c = pipeline.codec_params([50] * 3, "cpu")
    want = []
    for p in px:
        planes = [t.cpu().numpy() for t in convert.bgrx_to_iyuv(p)]
        card = device_stream.compress_frame_to_streams(planes, qt, dct)
        plain = device_stream.compress_frame_to_streams(
            [t.numpy() for t in convert.bgrx_to_iyuv(p.cpu())], qt_c, dct_c)
        for (a, b), (c, d) in zip(card, plain):
            assert np.array_equal(a, c) and np.array_equal(b, d)
        want.append(card)
    trace.start()
    got = list(streaming.compress_stream(px, qt, dct, depth=depth))
    spans, counters = trace.stop()
    assert len(got) == len(px)
    for streams, ws in zip(got, want):
        for (gs, gc), (ss, sc) in zip(streams, ws):
            assert np.array_equal(gs, ss) and np.array_equal(gc, sc)
    names = {}
    for n, _, _, _ in spans:
        names[n] = names.get(n, 0) + 1
    assert names == {"stream.ingest_frame": 6, "wait.event": 6,
                     "wait.pull": 6, "stream.split": 6}
    nblk = h * w * 3 // 2 // 64
    content = sum(int(c.size) for st in got for _, c in st)
    assert counters == {"pinned_bytes.d2h": 6 * (nblk + 56) + content}


def test_compress_stream_slots_by_geometry_and_replays(rng, cuda):
    """compress_stream on the card over two geometries and both kinds of
    frame, interleaved, at depth 2: each frame's streams are the frame
    API's, each geometry fills its own four slots (depth + 2), and the
    replays launch nothing from Python (K1 and C1 twice a slot: eagerly
    and in the capture; X1 once a BGRX frame)."""
    sizes = [(64, 128), (128, 96)]
    frames, want = [], []
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    for i in range(10):
        h, w = sizes[i % 2]
        planes = _stream_frames(rng, 1, h, w)[0]
        dev = device_stream.to_device(planes, cuda)
        frames.append(convert.iyuv_to_bgrx(*dev) if i % 3 else dev)
        want.append(device_stream.compress_frame_to_streams(
            [t.cpu().numpy() for t in convert.bgrx_to_iyuv(frames[-1])]
            if i % 3 else planes, qt, dct))
    torch.cuda.synchronize()
    before = dict(build.launches)
    got = list(streaming.compress_stream(frames, qt, dct, depth=2))
    launched = {k: build.launches[k] - n for k, n in before.items()
                if build.launches[k] > n}
    assert len(got) == len(frames)
    for streams, ws in zip(got, want):
        for (gs, gc), (ss, sc) in zip(streams, ws):
            assert np.array_equal(gs, ss) and np.array_equal(gc, sc)
    assert launched == {"dct_encode": 16, "compact_chunks": 16,
                        "bgrx_to_iyuv": 6}


def _played(rng, n, h, w):
    """n BGRX frames' streams in host memory (random pixels, coded on the
    CPU), as a player's read-ahead holds them."""
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    px = [torch.from_numpy(f) for f in
          rng.integers(0, 256, (n, h, w, 4)).astype(np.uint8)]
    return list(streaming.compress_stream(px, qt, dct))


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("depth", [1, 3])
def test_decompress_stream_graphs_equal_the_cpu_route(rng, cuda, depth,
                                                      precision):
    """decompress_stream on the card (pinned staging, side-stream uploads,
    one CUDA graph a slot) over 9 frames: every frame's BGRX that of the
    CPU route, byte for byte; the replays launch nothing from Python (K2,
    or K6 and F2, and X2 twice a slot: eagerly and in the capture)."""
    h, w = 256, 512
    streams = _played(rng, 9, h, w)
    dct_c, qt_c = pipeline.codec_params([50] * 3, "cpu")
    want = list(streaming.decompress_stream(streams, qt_c, dct_c, h, w,
                                            precision=precision))
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    torch.cuda.synchronize()
    before = dict(build.launches)
    got = [f.cpu() for f in streaming.decompress_stream(
        streams, qt, dct, h, w, depth=depth, precision=precision)]
    launched = {k: build.launches[k] - n for k, n in before.items()
                if build.launches[k] > n}
    assert len(got) == len(want) == 9
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    slots = 2 * (depth + 2)
    assert launched == ({"decode_idct": slots, "iyuv_to_bgrx": slots}
                        if precision == "exact" else
                        {"huffman_decode": slots,
                         "fast_dequantize_idct": slots,
                         "iyuv_to_bgrx": slots})


def test_decompress_stream_keeps_a_frame_until_its_slot_comes_round(rng,
                                                                    cuda):
    """A yielded frame is a view of its slot: it holds its pixels while
    frames up to k + depth + 1 are queued (while frame k + 1 is yielded),
    and frame k + depth + 2, queued while frame k + 2 is yielded, takes
    the slot over."""
    h, w, depth = 64, 128, 2
    streams = _played(rng, 8, h, w)
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    want = [f.clone() for f in streaming.decompress_stream(
        streams, qt, dct, h, w, depth=depth)]
    taken = []

    def frames():
        for k, st in enumerate(streams):
            taken.append(k)
            yield st
    stream = streaming.decompress_stream(frames(), qt, dct, h, w,
                                         depth=depth)
    first = next(stream)
    assert torch.equal(first, want[0]) and len(taken) == depth + 1
    next(stream)
    torch.cuda.synchronize()
    assert torch.equal(first, want[0]) and len(taken) == depth + 2
    next(stream)
    torch.cuda.synchronize()
    assert len(taken) == depth + 3
    assert torch.equal(first, want[depth + 2])
    assert not torch.equal(want[0], want[depth + 2])
    stream.close()


def test_decompress_stream_counts_its_pinned_uploads(rng, cuda):
    """``pinned_bytes.h2d``: each frame's N one-byte sizes and T chunk
    bytes, once; nothing pageable."""
    from myyuv_tpu_torch.runtime import trace
    h, w = 128, 256
    streams = _played(rng, 6, h, w)
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    trace.start()
    got = list(streaming.decompress_stream(streams, qt, dct, h, w))
    _, counters = trace.stop()
    nblk = h * w * 3 // 2 // 64
    content = sum(int(c.size) for st in streams for _, c in st)
    assert len(got) == 6
    assert counters == {"pinned_bytes.h2d": 6 * nblk + content}


def test_decompress_stream_raises_at_a_bad_frame_and_the_card_goes_on(rng,
                                                                       cuda):
    """A flipped tree-size byte in frame 3 of 7: frames 0-2 come out equal
    to the CPU route's, then BitstreamError with decompress_frame's
    message; the stream is closed, and a new stream on the card decodes
    the good frames."""
    h, w = 128, 256
    streams = _played(rng, 7, h, w)
    dct_c, qt_c = pipeline.codec_params([50] * 3, "cpu")
    good = list(streaming.decompress_stream(streams, qt_c, dct_c, h, w))
    sizes, content = streams[3][0]
    content = content.copy()
    content[2] ^= 0x5A                      # block 0's tree size
    bad = streams[:3] + [[(sizes, content), *streams[3][1:]]] + streams[4:]
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    with pytest.raises(BitstreamError) as want:
        device_stream.decompress_streams_to_frame(bad[3], qt, dct, h, w)
    stream = streaming.decompress_stream(bad, qt, dct, h, w, depth=3)
    for k in range(3):
        assert torch.equal(next(stream).cpu(), good[k])
    with pytest.raises(BitstreamError) as got:
        next(stream)
    assert str(got.value) == str(want.value)
    with pytest.raises(StopIteration):
        next(stream)
    again = [f.cpu() for f in streaming.decompress_stream(streams, qt, dct,
                                                          h, w)]
    assert len(again) == len(good)
    for g, wnt in zip(again, good):
        assert torch.equal(g, wnt)


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


def _launched(fn):
    """fn() and the kernels it launched from Python, by name."""
    before = dict(build.launches)
    out = fn()
    return out, {k: n - before[k] for k, n in build.launches.items()
                 if n != before[k]}


@pytest.mark.parametrize("qualities", [(75,), (50, 90, 50)])
def test_scan_equals_eager_frames(rng, cuda, qualities):
    """roundtrip_scan on the card, one call a quality on the same frames:
    each call launches K1 and K2 once each (the K frames coded as one) and
    nothing else of the port's, and its totals and oks equal K
    roundtrip_frame calls at its own quality."""
    k, h, w = 3, 256, 512
    stack = _scan_stack(_stream_frames(rng, k, h, w), cuda)
    seen = []
    for q in qualities:
        dct, qt = pipeline.codec_params([q] * 3, cuda)
        (totals, oks), n = _launched(
            lambda: device_stream.roundtrip_scan(*stack, qt, dct))
        assert n == {"dct_encode": 1, "decode_idct": 1}
        outs = [device_stream.roundtrip_frame(
            stack[0][i], stack[1][i], stack[2][i], qt, dct)
            for i in range(k)]
        assert totals.tolist() == [int(o[3]) for o in outs]
        assert oks.tolist() == [bool(o[4]) for o in outs] == [True] * k
        seen.append(totals.tolist())
    assert len(set(map(tuple, seen))) == len(set(qualities))


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
    decode to F1's coefficients, and a fast scan of K frames launches each
    of the four once."""
    h, w = 256, 512
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    planes = [torch.from_numpy(p).to(cuda) for p in _noise_frame(rng, h, w)]

    def refuse(*args, **kwargs):
        raise AssertionError("a plain fast transform ran on the card")

    monkeypatch.setattr(transform, "fast_dct_quantize_blocks_plain", refuse)
    monkeypatch.setattr(transform, "fast_dequantize_idct_blocks_plain",
                        refuse)

    coeffs = transform.fast_dct_quantize_blocks(*planes, qt, dct)
    (sizes, content), n = _launched(lambda: device_stream.compress_frame(
        *planes, qt, dct, precision="fast"))
    assert n == {"fast_dct_quantize": 1, "huffman_encode": 1,
                 "compact_chunks": 1}
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    assert torch.equal(decode.decode_blocks(content, sizes, offsets)[0],
                       coeffs)
    rec, n = _launched(lambda: device_stream.decompress_frame(
        content, sizes, qt, dct, h, w, precision="fast"))
    assert n == {"huffman_decode": 1, "fast_dequantize_idct": 1}
    want = transform.fast_dequantize_idct_blocks(coeffs, qt, dct, h, w)
    assert all(torch.equal(g, p) for g, p in zip(rec, want))
    out, n = _launched(lambda: device_stream.roundtrip_frame(
        *planes, qt, dct, precision="fast"))
    assert n == {"fast_dct_quantize": 1, "huffman_encode": 1,
                 "huffman_decode": 1, "fast_dequantize_idct": 1}
    assert all(torch.equal(g, p) for g, p in zip(out[:3], want))
    assert int(out[3]) == content.numel() and bool(out[4])
    k = 3
    stack = [p.expand(k, *p.shape).contiguous() for p in planes]
    (totals, oks), n = _launched(lambda: device_stream.roundtrip_scan(
        *stack, qt, dct, "fast"))
    assert n == {"fast_dct_quantize": 1, "huffman_encode": 1,
                 "huffman_decode": 1, "fast_dequantize_idct": 1}
    assert totals.tolist() == [content.numel()] * k and oks.all()


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


@pytest.fixture(scope="module")
def encphase_frames():
    """exp_r3stage's 4032x3008 CLI and noise frames on the card, q50."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from myyuv_tpu_torch.tools import exp_r3stage
    dev = torch.device("cuda")
    dct, qt = pipeline.codec_params([50] * 3, dev)
    return exp_r3stage.frames(dev), qt, dct


@pytest.mark.parametrize("variant", encode.PHASE_VARIANTS)
@pytest.mark.parametrize("frame", ["cli", "noise"])
def test_encphase_instance_matches_plain_on_4k(encphase_frames, variant,
                                               frame):
    """K1's measurement instance against its plain version, and its output
    what its stand-in makes of K1's, on the tool's 4K frames."""
    from myyuv_tpu_torch.tools import exp_encphase
    frames, qt, dct = encphase_frames
    planes = frames[frame]
    before = build.launches["dct_encode_phases"]
    got = encode.dct_encode_phase(*planes, qt, dct, variant)
    assert build.launches["dct_encode_phases"] == before + 1
    want = encode.dct_encode_phase_plain(*planes, qt, dct, variant)
    for g, p in zip(got, want):
        assert g.is_cuda and torch.equal(g, p)
    full = encode.dct_encode_blocks(*planes, qt, dct)
    coeffs = transform.dct_quantize_blocks(*planes, qt, dct)
    assert exp_encphase.stand_in_holds(variant, got, full, coeffs)


@pytest.mark.parametrize("variant", encode.PHASE_VARIANTS)
@pytest.mark.parametrize("shape", [(16, 16), (48, 80)])
@pytest.mark.parametrize("q", [1, 50, 100])
def test_encphase_instance_matches_plain_on_content_kinds(rng, cuda, variant,
                                                          shape, q):
    """Five content kinds; 16x16 has 6 blocks, less than a CTA's 32."""
    h, w = shape
    dct, qt = pipeline.codec_params([q] * 3, cuda)
    for kind in probe.KINDS:
        planes = [torch.from_numpy(probe.content_kind(rng, kind, s)).to(cuda)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        got = encode.dct_encode_phase(*planes, qt, dct, variant)
        want = encode.dct_encode_phase_plain(*planes, qt, dct, variant)
        for g, p in zip(got, want):
            assert torch.equal(g, p), kind


def test_encphase_tools_on_the_card(cuda):
    from myyuv_tpu_torch.tools import exp_encphase, exp_encsplit
    out = exp_encphase.run(cuda)
    assert out["max_abs_err"] == 0
    assert all(r["exact"] and r["stand_in"] for frame in ("cli", "noise")
               for r in out[frame].values())
    out = exp_encsplit.run(cuda)
    assert out["exact"] and out["flat_one_symbol"]


def test_encphase_production_encoders_keep_the_recorded_sass(cuda):
    """K1's and K5's production builds against ``tests/encoder_sass.json``,
    as ``tools/kernel_ab.py --sass`` read them once the encoder's front
    sorted by two networks: the same registers, a 0-byte stack and the
    count of every SASS opcode. A change meant to alter either kernel
    re-records the file (same command); one that is not, such as a new
    measurement instance, leaves them as they are."""
    import json
    import re
    import subprocess
    from pathlib import Path

    from myyuv_tpu_torch.tools import kernel_ab
    want = json.loads((Path(__file__).parent / "encoder_sass.json")
                      .read_text())
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    assert nvcc.stdout.strip().splitlines()[-1] == want["nvcc"], (
        "another nvcc than the recorded counts': re-record them")
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    for name in ("dct_encode", "huffman_encode"):
        build.load(name)
        lib = build.library_path(name)
        (ops,) = kernel_ab.sass_opcodes(lib).values()
        assert ops == want[name]["opcodes"], name
        usage = subprocess.run([str(cuobjdump), "-res-usage", str(lib)],
                               capture_output=True, text=True,
                               check=True).stdout
        (regs, stack), = re.findall(r"REG:(\d+) STACK:(\d+)", usage)
        assert int(regs) == want[name]["registers"], name
        assert int(stack) == want[name]["stack_bytes"], name



def test_trace_pins_the_file_paths_waits_and_pageable_bytes(rng, cuda):
    """One compress and one decompress of a 992x736 still with the
    recorder on: the CPU route's ``wait.*`` spans, and the exact bytes of
    every pageable copy (the tables, the three planes, the chunk sizes as
    int32 down and uint8 up, the content each way); the same launches and
    the same file as with the recorder off."""
    from myyuv_tpu_torch.formats import dct_stream, yuv
    from myyuv_tpu_torch.runtime import trace
    h, w = 736, 992
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 200
    planes = [(base + rng.integers(0, 40, (h, w))).astype(np.uint8),
              rng.integers(90, 170, (h // 2, w // 2)).astype(np.uint8),
              base[::2, ::2].astype(np.uint8)]
    raw = yuv.YUVImage.from_planes(yuv.FourccFormats.IYUV, planes, w,
                                   h).to_bytes()
    npix, nblk = h * w * 3 // 2, h * w * 3 // 2 // 64
    tables = (8 * 8 + 3 * 8 * 8) * 4

    def both(on: bool):
        before = dict(build.launches)
        if on:
            trace.start()
        packed = pipeline.compress_dct(yuv.YUVImage.from_bytes(raw),
                                       bytes([50] * 3), cuda).to_bytes()
        comp = trace.stop()
        if on:
            trace.start()
        back = pipeline.decompress_dct(yuv.YUVImage.from_bytes(packed),
                                       cuda).to_bytes()
        decomp = trace.stop()
        launched = {k: n - before.get(k, 0)
                    for k, n in build.launches.items()}
        return packed, back, launched, comp, decomp

    off = both(False)[:3]
    packed, back, launched, (cs, cc), (ds, dc) = both(True)
    assert (packed, back, launched) == off
    content = sum(p.content.size for p in dct_stream.DCTStream.parse(
        yuv.YUVImage.from_bytes(packed).data).planes)

    def waits(spans):
        out = {}
        for n, _, _, _ in spans:
            if n.startswith("wait."):
                out[n] = out.get(n, 0) + 1
        return out
    assert waits(cs) == {"wait.h2d": 5, "wait.size": 1, "wait.d2h": 2}
    assert waits(ds) == {"wait.h2d": 4, "wait.err": 1, "wait.d2h": 3}
    assert cc == {"pageable_bytes.h2d": tables + npix,
                  "pageable_bytes.d2h": nblk * 4 + content,
                  "compact.bytes": content}
    assert dc == {"pageable_bytes.h2d": tables + nblk + content,
                  "pageable_bytes.d2h": npix}


EDGE_SIZES = (0, 1, 13, 255, 256, 300, -1)


def _edge_lanes(rng, n, cuda):
    """Random lanes [n, 256] and sizes drawn from ``EDGE_SIZES`` (every
    one of them where n allows) on the card."""
    sizes = rng.choice(EDGE_SIZES, n)
    sizes[:min(n, len(EDGE_SIZES))] = EDGE_SIZES[:n]
    return (torch.from_numpy(rng.integers(0, 256, (n, 256), np.uint8)
                             ).to(cuda),
            torch.from_numpy(sizes.astype(np.int32)).to(cuda))


@pytest.mark.parametrize("n", [0, 1, 17112, 391680])
def test_compact_kernel_matches_plain(rng, cuda, n):
    """C1 against the mask select at no block, one block, a 992x736 frame's
    blocks and 8 x 1920x1088 frames' blocks, sizes 0, 1, 13, 255, 256, 300
    and -1 (one block: each in turn), one launch a call."""
    cases = ([_edge_lanes(rng, n, cuda)] if n != 1 else
             [(_edge_lanes(rng, 1, cuda)[0],
               torch.tensor([s], dtype=torch.int32, device=cuda))
              for s in EDGE_SIZES])
    for lanes, sizes in cases:
        before = build.launches["compact_chunks"]
        got = device_stream.compact_chunks(lanes, sizes)
        assert build.launches["compact_chunks"] == before + 1
        want = device_stream.compact_chunks_plain(lanes, sizes)
        assert got.is_cuda and got.dtype == torch.uint8
        assert torch.equal(got, want), sizes[:8].tolist()


@pytest.mark.parametrize("n", [0, 1, 17112, 391680])
def test_compact_scatter_on_the_card_equals_the_cpu(rng, cuda, n):
    """``scatter_chunks`` on the card (C1 into the zeroed worst-case
    buffer) against the CPU's: the whole buffer, zeros past the chunks
    included; ``total`` stays on the card."""
    lanes, sizes = _edge_lanes(rng, n, cuda)
    content, total = device_stream.scatter_chunks(lanes, sizes)
    assert total.is_cuda and content.is_cuda
    want, want_total = device_stream.scatter_chunks(lanes.cpu(), sizes.cpu())
    assert torch.equal(content.cpu(), want)
    assert int(total) == int(want_total)


def _smooth_batch(rng, b, h, w, cuda):
    """A batch of b frames [b, h, w] (+2x [b, h/2, w/2]) of gradients with
    light noise on the card: no chunk past 255 bytes at q50."""
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 200
    return [torch.from_numpy((base[None, ::s, ::s] + rng.integers(
        0, 40, (b, h // s, w // s))).astype(np.uint8)).to(cuda)
        for s in (1, 2, 2)]


@pytest.mark.parametrize("entry", ["compress_batch", "compress_frame"])
@pytest.mark.parametrize("n", [1, 33, 391680])
def test_compress_entries_equal_the_mask_select(rng, cuda, monkeypatch,
                                                entry, n):
    """``compress_batch`` and ``compress_frame`` on the card (C1 into the
    worst-case buffer, the length and the error flag read in one copy)
    give K1's sizes and the mask select's bytes of the same lanes: edge
    sizes at 1 and 33 blocks (the encoder's lanes replaced), K1's own
    lanes of 8 x 1920x1088 frames (391,680 blocks); the stream's length is
    the clamped sum of the sizes, one wait a call, no search."""
    from myyuv_tpu_torch.runtime import trace
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    if n == 391680:
        planes = _smooth_batch(rng, 8, 1088, 1920, cuda)
    else:
        planes = _smooth_batch(rng, 1, 16, 16, cuda)
        lanes, sizes = _edge_lanes(rng, n, cuda)
        err = torch.zeros(n, dtype=torch.int32, device=cuda)
        monkeypatch.setattr(device_stream, "frame_lanes",
                            lambda *a, **k: (lanes, sizes, err))
    call = {"compress_batch": device_stream.compress_batch,
            "compress_frame": lambda y, u, v, *a: device_stream.compress_frame(
                *device_stream.as_one_frame(y, u, v), *a)}[entry]
    trace.start()
    got_sizes, content = call(*planes, qt, dct)
    spans, counters = trace.stop()
    lanes, sizes, err = device_stream.frame_lanes(
        *device_stream.as_one_frame(*planes), qt, dct)
    assert sizes.numel() == n and not err.any()
    assert torch.equal(got_sizes, sizes)
    assert content.is_cuda and content.dtype == torch.uint8
    assert torch.equal(content, device_stream.compact_chunks_plain(lanes,
                                                                   sizes))
    assert content.numel() == int(sizes.clamp(0, 256).sum())
    assert [s[0] for s in spans if s[0].startswith("wait.")] == ["wait.size"]
    assert "err.search" not in counters


@pytest.mark.parametrize("entry", ["compress_batch", "compress_frame",
                                   "decompress_batch", "decompress_frame"])
def test_bad_blocks_raise_the_same_messages_on_the_card(rng, cuda,
                                                        monkeypatch, entry):
    """A forced encode error (block 5's chunk past its 8-bit size) and a
    corrupt stream (block 0's tree size past its chunk, the decoder's
    code 2) raise the messages the entries have always raised, on the
    card as on the CPU, after one search."""
    from myyuv_tpu_torch.runtime import trace
    from myyuv_tpu_torch.runtime.errors import BitstreamError
    b, h, w = 2, 32, 64
    planes = _smooth_batch(rng, b, h, w, cuda)
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    one = device_stream.as_one_frame(*planes)
    sizes, content = device_stream.compress_batch(*planes, qt, dct)
    content = content.clone()
    content[2] = 255               # block 0's tree size, past its chunk
    lanes_of = device_stream.frame_lanes

    def too_long(*a, **k):
        lanes, sizes, err = lanes_of(*a, **k)
        sizes, err = sizes.clone(), err.clone()
        sizes[5], err[5] = 300, 1
        return lanes, sizes, err
    monkeypatch.setattr(device_stream, "frame_lanes", too_long)
    calls = {
        "compress_batch": lambda dev: device_stream.compress_batch(
            *[p.to(dev) for p in planes], qt.to(dev), dct.to(dev)),
        "compress_frame": lambda dev: device_stream.compress_frame(
            *[p.to(dev) for p in one], qt.to(dev), dct.to(dev)),
        "decompress_batch": lambda dev: device_stream.decompress_batch(
            content.to(dev), sizes.to(dev), qt.to(dev), dct.to(dev), b, h,
            w),
        "decompress_frame": lambda dev: device_stream.decompress_frame(
            content.to(dev), sizes.to(dev), qt.to(dev), dct.to(dev), b * h,
            w),
    }
    want = ("Huffman encode failed at block 5 (code 1)"
            if entry.startswith("compress") else
            "Huffman decode failed at block 0 (code 2)")
    for dev in (cuda, torch.device("cpu")):
        trace.start()
        with pytest.raises(BitstreamError) as raised:
            calls[entry](dev)
        _, counters = trace.stop()
        assert str(raised.value) == want, dev
        assert counters["err.search"] == 1, dev


def test_compact_once_a_batch_and_its_counter(rng, cuda):
    """One ``compress_batch`` of 8 frames launches C1 once; with the
    recorder on, ``compact.bytes`` is the stream's length."""
    from myyuv_tpu_torch.runtime import trace
    b, h, w = 8, 64, 128
    frames = [_frame(rng, h, w) for _ in range(b)]
    planes = [torch.from_numpy(np.stack([f[i] for f in frames])).to(cuda)
              for i in range(3)]
    dct, qt = pipeline.codec_params([50] * 3, cuda)
    before = dict(build.launches)
    trace.start()
    sizes, content = device_stream.compress_batch(*planes, qt, dct)
    _, counters = trace.stop()
    assert build.launches["compact_chunks"] == before["compact_chunks"] + 1
    assert build.launches["dct_encode"] == before["dct_encode"] + 1
    assert counters["compact.bytes"] == content.numel() > 0
    assert content.numel() == int(sizes.sum())
