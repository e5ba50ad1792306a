"""The port's plain Huffman coder (myyuv_tpu_torch.entropy.device) against
the JAX package: chunk bytes against the native coder (the byte oracle:
the Pallas kernel, the XLA coder and native are byte-identical) and against
Pallas K1 run in interpret mode; decoded coefficients and per-chunk error
codes against the host decoder.

Tolerance: exact equality everywhere."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myyuv_tpu import entropy, native
from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import device_stream as jax_ds
from myyuv_tpu.engine import word_frame as jax_wf
from myyuv_tpu.entropy import reference
from myyuv_tpu.runtime.errors import BitstreamError
from myyuv_tpu_torch.engine import device_stream, pipeline
from myyuv_tpu_torch.entropy import device as edev
from myyuv_tpu_torch.entropy import encode
from myyuv_tpu_torch.kernels import probe
from myyuv_tpu_torch.tools import exp_encphase

import front_cases


@pytest.fixture(scope="module", autouse=True)
def _native():
    if not native.available():
        pytest.skip("native entropy library unavailable")


def _blocks(rng, n=600):
    c = rng.integers(-1024, 1024, (n, 64))
    c = (c * (rng.random((n, 64)) < rng.random((n, 1)))).astype(np.int16)
    c[0] = 0                                   # all-zero block
    c[1] = -1024                               # extreme symbols, dense
    c[2] = 1023
    c[3] = np.arange(64) - 32                  # 64 distinct symbols
    c[4:40] = rng.integers(-3, 4, (36, 64))    # small alphabets, many ties
    return c


def _encode(coeffs):
    lanes, sizes, err = edev.encode_lanes(torch.from_numpy(coeffs))
    assert not err.any()
    sizes = sizes.numpy()
    mask = np.arange(edev.LANE)[None, :] < sizes[:, None]
    return sizes, lanes.numpy()[mask]


def _decode(sizes, content):
    sizes_t = torch.from_numpy(np.asarray(sizes, np.int32))
    offsets = torch.cumsum(sizes_t, 0, dtype=torch.int64) - sizes_t
    lanes = edev.gather_lanes(torch.from_numpy(content), sizes_t, offsets)
    coeffs, err = edev.decode_lanes(lanes, sizes_t)
    return coeffs.numpy(), err.numpy()


def _native_decode(chunk: np.ndarray):
    """The host decoder on one chunk: (0, its coefficients) or (its error
    code, None). The chunk lies in a zero-padded buffer, so a malformed tree
    that makes native read past the chunk reads inside it."""
    try:
        out = native.decode_blocks(np.array([chunk.size], np.uint8),
                                   np.pad(chunk, (0, 256)))
    except BitstreamError as e:
        return int(re.search(r"code (\d+)", str(e)).group(1)), None
    return 0, out[0]


def _native_code(chunk: np.ndarray) -> int:
    """The host decoder's verdict on one chunk: 0 or its error code."""
    return _native_decode(chunk)[0]


def test_plain_encode_matches_native_bytes(rng):
    coeffs = _blocks(rng)
    sizes, content = _encode(coeffs)
    want_sizes, want = entropy.encode_blocks(coeffs, backend="native")
    np.testing.assert_array_equal(sizes, want_sizes.astype(np.int32))
    np.testing.assert_array_equal(content, want)


@pytest.mark.parametrize("case", front_cases.FRONT_CASES)
def test_plain_encode_matches_native_on_front_cases(case):
    """The front's edge cases (``tests/front_cases.py``), which the card's
    tests run through K5, K1 and its ``frontonly`` instance: each set
    reaches the message lengths it is named for, and its chunks and sizes
    are native's."""
    coeffs = front_cases.front_blocks(np.random.default_rng(20), case)
    mlen, _ = exp_encphase.message_stats(torch.from_numpy(coeffs))
    assert mlen.tolist() == front_cases.message_lengths(case)
    sizes, content = _encode(coeffs)
    want_sizes, want = entropy.encode_blocks(coeffs, backend="native")
    np.testing.assert_array_equal(sizes, want_sizes.astype(np.int32))
    np.testing.assert_array_equal(content, want)


@pytest.mark.parametrize("case", front_cases.FRONT_CASES)
def test_plain_front_counts_reference_symbols_on_front_cases(case):
    """The plain ``frontonly`` stand-in on the front's edge cases: size
    n_sym, the distinct values of ``reference.py``'s message, err 0 and a
    zero lane."""
    coeffs = front_cases.front_blocks(np.random.default_rng(20), case)
    lanes, sizes, err = edev.encode_lanes(torch.from_numpy(coeffs),
                                          skip="frontonly")
    assert sizes.tolist() == [len(np.unique(reference._message(c)))
                              for c in coeffs]
    assert not err.any() and not lanes.any()


def test_plain_decode_matches_host(rng):
    coeffs = _blocks(rng)
    sizes, content = entropy.encode_blocks(coeffs, backend="native")
    got, err = _decode(sizes, content)
    assert not err.any()
    np.testing.assert_array_equal(
        got, entropy.decode_blocks(sizes, content, backend="native"))
    np.testing.assert_array_equal(got, coeffs)


def test_single_symbol_and_saturated_blocks():
    c = np.zeros((5, 64), np.int16)
    c[0, reference.ZIGZAG[63]] = 5        # one nonzero at the scan's end
    c[1, reference.ZIGZAG[0]] = -7        # single-symbol message
    c[2] = 1023                           # saturated, one symbol
    c[3] = -1024
    c[4, ::2] = -1024                     # two extreme symbols, 32 each
    c[4, 1::2] = 1023
    sizes, content = _encode(c)
    want_sizes, want = native.encode_blocks(c)
    np.testing.assert_array_equal(sizes, want_sizes.astype(np.int32))
    np.testing.assert_array_equal(content, want)
    got, err = _decode(sizes, content)
    assert not err.any()
    np.testing.assert_array_equal(got, c)


def _chunk(*parts) -> np.ndarray:
    return np.concatenate([np.asarray(p, np.uint8).reshape(-1)
                           for p in parts])


def _valid_chunks(rng):
    sizes, content = native.encode_blocks(_blocks(rng, 64))
    offs = np.cumsum(sizes.astype(np.int64)) - sizes
    return [content[o:o + s].copy() for o, s in zip(offs, sizes)][:8]


def _corrupt(kind, rng):
    chunk = _valid_chunks(rng)[5]
    if kind == "too_short":                  # code 1
        return chunk[:2]
    if kind == "truncated":                  # code 2
        return chunk[:-1]
    if kind == "tree_size_255":              # code 2 with the file's size
        chunk[2] = 255
        return chunk
    if kind == "tree_size_mismatch":         # code 4
        chunk[2] -= 1
        return chunk
    if kind == "too_many_symbols":           # code 3: 96 codes of length 1
        group = _chunk([31], np.zeros(44))
        return _chunk([0, 0, 135], group, group, group)
    if kind == "payload_ends_in_code":       # code 5
        return _chunk([1, 0, 3, 0, 5, 0, 1])
    if kind == "out_of_table_code":          # code 7: one 1-bit code "0"
        return _chunk([8, 0, 3, 0, 5, 0, 0xFF])
    if kind == "trailing_bits":              # code 8: 72 bits, 64 symbols
        return _chunk([72, 0, 3, 0, 0, 0], np.zeros(9))
    raise AssertionError(kind)


CORRUPT = {"too_short": 1, "truncated": 2, "tree_size_255": 2,
           "tree_size_mismatch": 4, "too_many_symbols": 3,
           "payload_ends_in_code": 5, "out_of_table_code": 7,
           "trailing_bits": 8}


@pytest.mark.parametrize("kind", sorted(CORRUPT))
def test_corrupt_chunk_rejected_like_host(rng, kind):
    """A corrupt chunk among valid ones gets exactly the host decoder's
    error code, and only it."""
    chunks = _valid_chunks(rng)
    chunks[3] = _corrupt(kind, rng)
    want = [_native_code(c) for c in chunks]
    assert want[3] == CORRUPT[kind] and want.count(0) == len(chunks) - 1
    sizes = np.array([c.size for c in chunks], np.uint8)
    _, err = _decode(sizes, np.concatenate(chunks))
    np.testing.assert_array_equal(err, want)


def test_frame_encode_matches_native_planes_16x16(rng):
    """A 16x16 frame has 4 + 1 + 1 blocks, no multiple of 8."""
    planes = [rng.integers(0, 256, s, np.uint8)
              for s in ((16, 16), (8, 8), (8, 8))]
    dct, qt = pipeline.codec_params([50, 60, 70], "cpu")
    got = device_stream.compress_frame_to_streams(planes, qt, dct)
    for i, (sizes, content) in enumerate(got):
        ws, wc = native.compress_plane(planes[i], qt[i].numpy())
        np.testing.assert_array_equal(sizes, ws)
        np.testing.assert_array_equal(content, wc)


def test_frame_encode_matches_pallas_k1_interpret(rng):
    """The plain version of K1 against the TPU kernel itself, run in
    interpret mode (32x64, q50): stream bytes identical."""
    h, w = 32, 64
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 200
    y = (base + rng.integers(0, 40, (h, w))).astype(np.uint8)
    u = rng.integers(90, 170, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    qts = jax_batch.plane_qtables([50] * 3)
    xw = jax_wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                           tile=8)
    A, C, sizes, _, ok = jax_wf.compress_words(xw, *qts, h=h, w=w,
                                               interpret=True, tile=8)
    assert bool(ok)
    sizes_np = np.asarray(sizes).astype(np.int32)
    packed = jax_ds._pull_packed_stream(A, C, sizes, sizes_np)
    want = jax_ds._split_planes(sizes_np, packed, (h // 8) * (w // 8),
                                (h // 16) * (w // 16))
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    got = device_stream.compress_frame_to_streams((y, u, v), qt, dct)
    lanes, _, _ = encode.dct_encode_blocks(
        *(torch.from_numpy(p) for p in (y, u, v)), qt, dct)
    assert lanes.shape == (sizes_np.size, 256)
    for (gs, gc), (ws, wc) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gc, wc)


def test_wrappers_reject_what_the_kernels_do_not_take():
    from myyuv_tpu_torch.entropy import decode
    dct, qt = pipeline.codec_params([50] * 3, "cpu")
    y = torch.zeros((16, 32), dtype=torch.uint8)
    u = torch.zeros((8, 16), dtype=torch.uint8)
    bad = [
        (y.to(torch.int32), u, u, qt, dct),           # dtype
        (y[:, :16], u, u, qt, dct),                     # chroma shape
        (y.t().contiguous().t(), u, u, qt, dct),        # frame not /16
        (torch.zeros((32, 16), dtype=torch.uint8).t(), u, u, qt, dct),
        (y, u, u, qt.to(torch.float64), dct),
        (y.to("meta"), u.to("meta"), u.to("meta"), qt.to("meta"),
         dct.to("meta")),                               # no kernel there
    ]
    for args in bad:
        with pytest.raises(ValueError):
            encode.dct_encode_blocks(*args)
    n = 8 + 2 * 2
    sizes = torch.full((n,), 3, dtype=torch.int32)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    content = torch.zeros(3 * n, dtype=torch.uint8)
    with pytest.raises(ValueError):
        decode.decode_idct_blocks(content, sizes.to(torch.int64), offsets,
                                  qt, dct, 16, 32)
    with pytest.raises(ValueError):
        decode.decode_idct_blocks(content, sizes, offsets, qt, dct, 16, 24)


def test_chunks_past_the_content_read_as_zero(rng):
    """Offsets that point past the content never read outside it: such
    bytes read as 0, and the chunk is judged on that."""
    sizes, content = native.encode_blocks(_blocks(rng, 64))
    sizes_t = torch.from_numpy(sizes.astype(np.int32))
    offsets = torch.cumsum(sizes_t, 0, dtype=torch.int64) - sizes_t
    offsets[3] = content.size - 2          # chunk 3 runs off the end
    offsets[4] = content.size + 100        # chunk 4 lies wholly outside
    lanes = edev.gather_lanes(torch.from_numpy(content), sizes_t, offsets)
    seen3 = np.zeros(sizes[3], np.uint8)
    seen3[:2] = content[-2:]
    np.testing.assert_array_equal(lanes[3, :sizes[3]].numpy(), seen3)
    assert not lanes[4].any() and not lanes[3, sizes[3]:].any()
    _, err = edev.decode_lanes(lanes, sizes_t)
    assert err[3] == _native_code(seen3)
    assert err[4] == _native_code(np.zeros(sizes[4], np.uint8))
    assert not err[:3].any() and not err[5:].any()


@pytest.mark.parametrize("family", probe.DECODER_FAMILIES)
def test_plain_decoder_matches_native_on_decoder_families(family):
    """Each chunk of a ``probe.decoder_families`` family, as the decoders
    see it (bytes outside the content read as 0), gets native
    ``decode_block``'s error code from the plain decoder, and, when valid,
    native's coefficients; a bad block's are 0. An error family's chunks
    all carry its code."""
    content, sizes, offsets = probe.decoder_families(
        np.random.default_rng(7))[family]
    sizes_t = torch.from_numpy(sizes)
    lanes = edev.gather_lanes(torch.from_numpy(content), sizes_t,
                              torch.from_numpy(offsets))
    coeffs, err = edev.decode_lanes(lanes, sizes_t)
    for b, size in enumerate(sizes):
        code, want = _native_decode(lanes[b, :size].numpy())
        assert int(err[b]) == code, b
        if code:
            assert not coeffs[b].any(), b
        else:
            np.testing.assert_array_equal(coeffs[b].numpy(), want)
    if family.startswith("err"):
        assert set(err.tolist()) == {int(family[3])}
