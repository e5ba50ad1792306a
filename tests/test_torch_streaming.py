"""The port's streaming drivers (``engine/streaming.py``) on the CPU, where
they run the plain versions: flags and totals against the frame API, and
``compress_stream``'s bytes against the frame API and the JAX package, and
on BGRX frames against X1 and the frame API and the benchmark's plain
reference of the capture path; ``decompress_stream``'s pixels against the
frame API with X2, the benchmark's plain reference of the playback path and
the JAX package's decode with its X2; ``device_stream.roundtrip_scan``
against the JAX package's and the frame API.

Tolerance: exact equality (flags, byte counts, stream bytes, pixels),
except the fast decode against the exact one, within +-1 a byte."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myyuv_tpu import native
from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import device_stream as jax_ds
from myyuv_tpu.engine.streaming import FLAG_CHUNK
from myyuv_tpu.kernels import device as jax_device
from benchmark.reference import capture as capture_reference
from benchmark.reference import playback as playback_reference
from myyuv_tpu_torch.engine import device_stream, pipeline, streaming
from myyuv_tpu_torch.kernels import convert, probe
from myyuv_tpu_torch.kernels.device import plane_block_counts
from myyuv_tpu_torch.runtime.errors import BitstreamError

H, W = 64, 128
N_FRAMES = FLAG_CHUNK + 3  # past the JAX package's flag-stack arity


def _frames(rng, n):
    """n frames, the content kinds in turn, so the totals differ."""
    return [[probe.content_kind(rng, probe.KINDS[f % len(probe.KINDS)], s)
             for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
            for f in range(n)]


@pytest.fixture
def setup(rng):
    frames = _frames(rng, N_FRAMES)
    dct, qt = pipeline.codec_params([75] * 3, "cpu")
    streams = [device_stream.compress_frame_to_streams(f, qt, dct)
               for f in frames]
    totals = [sum(int(c.size) for _, c in st) for st in streams]
    return frames, [device_stream.to_device(f, "cpu") for f in frames], \
        streams, totals, qt, dct


def test_roundtrip_stream_flags_and_totals(setup):
    _, dev, _, totals, qt, dct = setup
    ok, tot, elapsed = streaming.roundtrip_stream(dev, qt, dct)
    assert ok.dtype == bool and ok.shape == (N_FRAMES,) and ok.all()
    assert tot.dtype == np.int64 and tot.tolist() == totals
    assert elapsed > 0


def test_ingest_stream_flags_and_totals(setup):
    """Ingest of each frame's X2 preview: totals those of X1 + the frame
    API on the same pixels."""
    _, dev, _, _, qt, dct = setup
    px = [convert.iyuv_to_bgrx(*d) for d in dev]
    want = [int(device_stream.compress_frame(
        *convert.bgrx_to_iyuv(p), qt, dct)[1].numel()) for p in px]
    ok, tot, _ = streaming.ingest_stream(px, qt, dct)
    assert ok.shape == (N_FRAMES,) and ok.all()
    assert tot.dtype == np.int64 and tot.tolist() == want


def test_preview_stream_flags(setup):
    _, dev, _, _, qt, dct = setup
    sizes, content = device_stream.compress_frame(*dev[0], qt, dct)
    ok, elapsed = streaming.preview_stream((content, sizes), qt, dct, H, W,
                                           N_FRAMES)
    assert ok.shape == (N_FRAMES,) and ok.all() and elapsed > 0
    bad = content.clone()
    bad[2] ^= 0x5A                          # block 0's tree size
    ok, _ = streaming.preview_stream((bad, sizes), qt, dct, H, W, 2)
    assert not ok.any()


@pytest.mark.parametrize("depth", [1, 3])
def test_compress_stream_bytes_match_frame_api_and_jax(setup, depth):
    frames, dev, streams, _, qt, dct = setup
    if not native.available():
        pytest.skip("native entropy library unavailable")
    tables = [np.asarray(t) for t in jax_batch.plane_qtables([75] * 3)]
    got = list(streaming.compress_stream(dev, qt, dct, depth=depth))
    assert len(got) == N_FRAMES
    for f, (g, want) in enumerate(zip(got, streams)):
        jax_want = (jax_ds.compress_frame_to_streams(frames[f], tables)
                    if f < len(probe.KINDS) else want)
        for (gs, gc), (ws, wc), (js, jc) in zip(g, want, jax_want):
            for s, c in ((ws, wc), (js, jc)):
                np.testing.assert_array_equal(gs, s)
                np.testing.assert_array_equal(gc, c)


def _bgrx_frames(rng, kind, h, w, n=3):
    """n BGRX frames [h, w, 4]: random bytes, saturated colours (every
    channel 0 or 255) or extreme ones (each channel in 0, 1, 254, 255),
    whose chroma differences reach X1's 8-bit wrap."""
    shape = (n, h, w, 4)
    if kind == "random":
        px = rng.integers(0, 256, shape)
    elif kind == "saturated":
        px = 255 * rng.integers(0, 2, shape)
    else:
        px = rng.choice([0, 1, 254, 255], shape)
    return [torch.from_numpy(f) for f in px.astype(np.uint8)]


@pytest.mark.parametrize("kind", ["random", "saturated", "extreme"])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("h, w", [(32, 48), (64, 64)])
def test_compress_stream_of_bgrx_matches_reference_and_frame_api(
        rng, h, w, depth, kind):
    """BGRX frames through ``compress_stream``: the streams, in order and
    byte for byte, of the benchmark's plain reference of the capture path
    and of X1 followed by ``compress_frame_to_streams``."""
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    frames = _bgrx_frames(rng, kind, h, w)
    got = list(streaming.compress_stream(frames, qt, dct, depth=depth))
    assert len(got) == len(frames)
    for g, px in zip(got, frames):
        planes = [p.numpy() for p in convert.bgrx_to_iyuv(px)]
        for want in (capture_reference.frame_streams(px, [50] * 3),
                     device_stream.compress_frame_to_streams(planes, qt,
                                                             dct)):
            assert len(g) == len(want) == 3
            for (gs, gc), (ws, wc) in zip(g, want):
                assert gs.dtype == gc.dtype == np.uint8
                np.testing.assert_array_equal(gs, ws)
                np.testing.assert_array_equal(gc, wc)


def test_compress_stream_raises_on_a_chunk_over_255_bytes(rng,
                                                          monkeypatch):
    """A block whose chunk does not fit its 8-bit size (K1's err) raises
    BitstreamError at its frame, on BGRX frames as on planes."""
    lanes_of = device_stream.frame_lanes

    def too_long(*a, **k):
        lanes, sizes, err = lanes_of(*a, **k)
        sizes, err = sizes.clone(), err.clone()
        sizes[0], err[0] = 300, 1
        return lanes, sizes, err
    monkeypatch.setattr(device_stream, "frame_lanes", too_long)
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    px = _bgrx_frames(rng, "random", 32, 48, n=1)[0]
    for frame in (px, convert.bgrx_to_iyuv(px)):
        with pytest.raises(BitstreamError, match="8-bit size"):
            list(streaming.compress_stream([frame], qt, dct))


def test_compress_stream_refuses_a_bgrx_batch(rng):
    """A BGRX frame is one [H, W, 4] picture: a batch of them is refused
    (its streams would not split into one frame's planes)."""
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    batch = torch.stack(_bgrx_frames(rng, "random", 32, 48, n=2))
    with pytest.raises(ValueError, match=r"\[H, W, 4\]"):
        list(streaming.compress_stream([batch], qt, dct))


def _played(rng, h, w, n=4, q=50):
    """n random BGRX frames and their streams, as the plain reference of
    the capture path codes them (a file's bytes)."""
    frames = _bgrx_frames(rng, "random", h, w, n)
    return frames, [capture_reference.frame_streams(px, [q] * 3)
                    for px in frames]


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("h, w", [(32, 48), (64, 64)])
def test_decompress_stream_matches_frame_api_reference_and_jax(rng, h, w,
                                                               depth):
    """Streams in host memory through ``decompress_stream``: in order and
    byte for byte the BGRX of ``decompress_streams_to_frame`` followed by
    X2, of the benchmark's plain reference of the playback path on the
    source pixels, and of the JAX package's decode followed by its X2."""
    if not native.available():
        pytest.skip("native entropy library unavailable")
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    tables = [np.asarray(t) for t in jax_batch.plane_qtables([50] * 3)]
    frames, streams = _played(rng, h, w)
    got = list(streaming.decompress_stream(streams, qt, dct, h, w,
                                           depth=depth))
    assert len(got) == len(frames)
    for g, px, st in zip(got, frames, streams):
        assert g.dtype == torch.uint8 and g.shape == (h, w, 4)
        planes = device_stream.decompress_streams_to_frame(st, qt, dct, h, w)
        jax_planes = jax_ds.decompress_streams_to_frame(st, tables, h, w)
        for want in (convert.iyuv_to_bgrx(*map(torch.from_numpy, planes)),
                     playback_reference.frame_bgrx(px, [50] * 3),
                     torch.from_numpy(np.array(jax_device.iyuv_to_bgrx(
                         *(jnp.asarray(p) for p in jax_planes))))):
            assert torch.equal(g, want)


@pytest.mark.parametrize("depth", [0, 3])
def test_decompress_stream_raises_a_bad_tree_at_its_frame(rng, depth):
    """A flipped tree-size byte in frame 2: frames 0 and 1 come out, then
    BitstreamError with ``decompress_frame``'s message."""
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    _, streams = _played(rng, 32, 48)
    sizes, content = streams[2][0]
    content = content.copy()
    content[2] ^= 0x5A                      # block 0's tree size
    streams[2] = [(sizes, content), *streams[2][1:]]
    with pytest.raises(BitstreamError) as want:
        device_stream.decompress_streams_to_frame(streams[2], qt, dct, 32, 48)
    stream = streaming.decompress_stream(streams, qt, dct, 32, 48,
                                         depth=depth)
    assert next(stream).shape == next(stream).shape == (32, 48, 4)
    with pytest.raises(BitstreamError) as got:
        next(stream)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("Huffman decode failed at block 0")


FAULTS = {"short": (BitstreamError, "shorter than chunk sizes"),
          "blocks": (ValueError, "blocks a plane"),
          "dtype": (ValueError, "uint8")}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_decompress_stream_checks_a_frame_when_it_stages_it(rng, fault):
    """Frame 2's Y content one byte shorter than its sizes imply raises
    BitstreamError (a block count not the geometry's, or sizes not uint8,
    ValueError) when the frame is staged: at depth 3 before frame 0 comes
    out, at depth 0 after frames 0 and 1."""
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    _, streams = _played(rng, 32, 48)
    sizes, content = streams[2][0]
    streams[2] = [{"short": (sizes, content[:-1]),
                   "blocks": (sizes[:-1], content),
                   "dtype": (sizes.astype(np.int32), content)}[fault],
                  *streams[2][1:]]
    error, match = FAULTS[fault]
    with pytest.raises(error, match=match):
        next(streaming.decompress_stream(streams, qt, dct, 32, 48, depth=3))
    stream = streaming.decompress_stream(streams, qt, dct, 32, 48, depth=0)
    next(stream), next(stream)
    with pytest.raises(error, match=match):
        next(stream)


def test_decompress_stream_fast_is_within_one_of_exact(rng):
    """``precision="fast"`` (K6 and F2, then X2): every byte within +-1 of
    the exact decode's, alpha 255."""
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    _, streams = _played(rng, 64, 64)
    exact = list(streaming.decompress_stream(streams, qt, dct, 64, 64))
    fast = list(streaming.decompress_stream(streams, qt, dct, 64, 64,
                                            precision="fast"))
    assert len(fast) == len(exact) == len(streams)
    for f, e in zip(fast, exact):
        assert (f.to(torch.int16) - e.to(torch.int16)).abs().max() <= 1
        assert (f[..., 3] == 255).all()


def test_capture_into_playback_is_the_references_reconstruction(rng):
    """``compress_stream`` of BGRX frames fed straight into
    ``decompress_stream``: the reference's reconstruction of each source
    frame, shown as BGRX."""
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    frames = _bgrx_frames(rng, "extreme", 48, 64, n=5)
    got = list(streaming.decompress_stream(
        streaming.compress_stream(frames, qt, dct, depth=2), qt, dct, 48, 64,
        depth=2))
    assert len(got) == len(frames)
    for g, px in zip(got, frames):
        assert torch.equal(g, playback_reference.frame_bgrx(px, [50] * 3))


def test_sustained_drivers_report_every_window(setup):
    frames, _, streams, totals, qt, dct = setup
    fps, ok, total, stats = streaming.sustained_roundtrip_fps(
        frames[0], qt, dct, n_frames=3, windows=3)
    assert ok and total == totals[0] and fps in stats["windows_fps"]
    assert len(stats["windows_fps"]) == 3 and stats["windows_ok"] == [3] * 3
    ingest_fps, preview_fps, ok = streaming.sustained_pipeline_fps(
        frames[0], qt, dct, n_frames=3)
    assert ok and ingest_fps > 0 and preview_fps > 0
    fps, total, first = streaming.compress_stream_timed(frames[0], qt, dct,
                                                        n_frames=3)
    assert fps > 0 and total == totals[0]
    for (gs, gc), (ws, wc) in zip(first, streams[0]):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("case", ["random", "short", "full", "err"])
def test_scatter_chunks_equals_the_mask_select(rng, case):
    """The sync-free compaction of ``compress_stream`` and ``ingest_frame``
    against the frame API's mask select, on lanes zero past their sizes:
    chunks of 0..255 bytes at every byte offset, 255-byte chunks back to
    back, and err chunks (a size past 255 and a zero lane) that take no
    room."""
    n = 2000
    high = {"random": 256, "short": 12, "full": 256, "err": 256}[case]
    sizes = (np.full(n, 255) if case == "full"
             else rng.integers(0, high, n)).astype(np.int32)
    lanes = rng.integers(0, 256, (n, 256)).astype(np.uint8)
    if case == "err":
        sizes[rng.random(n) < 0.05] = 300
    lanes[np.arange(256)[None, :] >= np.minimum(sizes, 256)[:, None]] = 0
    lanes[sizes > 255] = 0
    lanes_t, sizes_t = torch.from_numpy(lanes), torch.from_numpy(sizes)
    content, total = device_stream.scatter_chunks(lanes_t, sizes_t)
    live = torch.where(sizes_t < 256, sizes_t, 0)
    want = device_stream.compact_chunks(lanes_t, live)
    assert content.numel() == n * 255 and int(total) == int(sizes.sum())
    assert torch.equal(content[:want.numel()], want)


EDGE_SIZES = (0, 1, 13, 255, 256, 300, -1)


@pytest.mark.parametrize("size", [*EDGE_SIZES, "mixed", "no_blocks"])
def test_compactions_equal_the_mask_select_definition(rng, size):
    """``compact_chunks`` (the plain version on the CPU) and
    ``scatter_chunks`` against the definition, chunk by chunk in numpy, on
    lanes that are not zero past their sizes: block b gives its first
    clamp(size, 0, 256) bytes to the compaction (an err block of size >=
    256 all of its lane), and its first size bytes to ``scatter_chunks``
    only where 0 <= size < 256, zeros after the live chunks there."""
    n = {"mixed": 2000, "no_blocks": 0}.get(size, 64)
    sizes = (rng.choice(EDGE_SIZES, n) if size == "mixed"
             else np.full(n, 0 if size == "no_blocks" else size))
    sizes = sizes.astype(np.int32)
    lanes = rng.integers(0, 256, (n, 256)).astype(np.uint8)
    lanes_t, sizes_t = torch.from_numpy(lanes), torch.from_numpy(sizes)

    def chunks(keep):
        return b"".join(lanes[b, :keep(int(s))].tobytes()
                        for b, s in enumerate(sizes))

    got = device_stream.compact_chunks(lanes_t, sizes_t)
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == chunks(lambda s: min(max(s, 0), 256))
    content, total = device_stream.scatter_chunks(lanes_t, sizes_t)
    want = chunks(lambda s: s if 0 <= s < 256 else 0)
    assert content.numel() == n * 255 and int(total) == int(sizes.sum())
    assert content[:len(want)].numpy().tobytes() == want
    assert not content[len(want):].any()


def test_empty_streams():
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    ok, tot, _ = streaming.roundtrip_stream([], qt, dct)
    assert ok.shape == (0,) and tot.shape == (0,)
    assert list(streaming.compress_stream([], qt, dct)) == []
    ok, _ = streaming.preview_stream(
        (torch.zeros(0, dtype=torch.uint8),
         torch.zeros(6, dtype=torch.int32)), qt, dct, 16, 16, 0)
    assert ok.shape == (0,)


def _stacked(frames):
    """Frames [(y, u, v)] -> (ys [K, H, W], us, vs [K, H/2, W/2]) tensors."""
    return [torch.from_numpy(np.stack([f[i] for f in frames]))
            for i in range(3)]


def test_roundtrip_scan_matches_jax_and_frame_api(rng):
    """K = 2 frames of 16x32 (the JAX package's own scan test size), two
    content kinds, through the port's and JAX's ``roundtrip_scan``; the
    port's totals and oks also equal K calls of its ``roundtrip_frame``."""
    frames = [[probe.content_kind(rng, kind, s)
               for s in ((16, 32), (8, 16), (8, 16))]
              for kind in ("gradient", "impulse")]
    ys, us, vs = _stacked(frames)
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    totals, oks = device_stream.roundtrip_scan(ys, us, vs, qt, dct)
    assert totals.dtype == torch.int64 and oks.dtype == torch.bool
    assert totals.shape == oks.shape == (2,)
    per_frame = [device_stream.roundtrip_frame(ys[i], us[i], vs[i], qt, dct)
                 for i in range(2)]
    assert totals.tolist() == [int(f[3]) for f in per_frame]
    assert oks.tolist() == [bool(f[4]) for f in per_frame] == [True] * 2
    jtotals, joks = jax_ds.roundtrip_scan(
        *(jnp.asarray(p.numpy()) for p in (ys, us, vs)),
        *jax_batch.plane_qtables([50] * 3))
    assert np.asarray(jtotals).tolist() == totals.tolist()
    assert np.asarray(joks).tolist() == oks.tolist()


def test_roundtrip_scan_checks_its_stacks():
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    ys, us, vs = (torch.zeros(s, dtype=torch.uint8)
                  for s in ((3, 16, 32), (3, 8, 16), (3, 8, 16)))
    for bad in ((ys[0], us, vs), (ys, us[:2], vs), (ys, us, vs.float()),
                (ys[:, :8], us, vs)):
        with pytest.raises(ValueError):
            device_stream.roundtrip_scan(*bad, qt, dct)
    totals, oks = device_stream.roundtrip_scan(ys[:0], us[:0], vs[:0], qt,
                                               dct)
    assert totals.shape == oks.shape == (0,)


@pytest.mark.parametrize("plane", [0, 1, 2])
@pytest.mark.parametrize("side", ["encode", "decode"])
def test_roundtrip_scan_puts_a_bad_block_on_its_own_frame(rng, monkeypatch,
                                                          plane, side):
    """A bad block in one frame's Y, U or V range, from the encoder or the
    decoder, clears that frame's ok alone; the totals stay the frames'."""
    k, h, w, bad_frame = 3, 16, 32, 1
    frames = [[probe.content_kind(rng, "noise", s)
               for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
              for _ in range(k)]
    ys, us, vs = _stacked(frames)
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    want, _ = device_stream.roundtrip_scan(ys, us, vs, qt, dct)
    counts = plane_block_counts(h, w)
    block = k * sum(counts[:plane]) + bad_frame * counts[plane] + 1
    name = "frame_lanes" if side == "encode" else "frame_planes"
    real = getattr(device_stream, name)

    def spoiled(*args, **kwargs):
        *out, err = real(*args, **kwargs)
        err = err.clone()
        err[block] = 1
        return (*out, err)

    monkeypatch.setattr(device_stream, name, spoiled)
    totals, oks = device_stream.roundtrip_scan(ys, us, vs, qt, dct)
    assert totals.tolist() == want.tolist()
    assert oks.tolist() == [f != bad_frame for f in range(k)]


def test_roundtrip_scan_stream_equals_roundtrip_stream(setup):
    """The frames as scans of K = 3 equal them streamed one by one."""
    frames, dev, _, totals, qt, dct = setup
    k = 3
    stacks = [_stacked(frames[i:i + k])
              for i in range(0, N_FRAMES - N_FRAMES % k, k)]
    ok, tot, elapsed = streaming.roundtrip_scan_stream(stacks, qt, dct)
    assert ok.dtype == bool and ok.shape == (len(stacks), k) and ok.all()
    assert tot.ravel().tolist() == totals[:len(stacks) * k]
    assert elapsed > 0


def test_sustained_scan_fps_small(setup):
    frames, _, _, totals, qt, dct = setup
    fps, ok, total = streaming.sustained_scan_fps(frames[0], qt, dct,
                                                  n_frames=5, k=2)
    assert ok and fps > 0 and total == totals[0]
