"""Content and a timer for holding the kernels against their plain versions.

* ``contraction_probe_blocks``: the recipe of the production-kernel
  contraction probe in ``tools/check_tpu_bitexact.py`` (:105-152) — random
  8x8 blocks whose quantized coefficients differ between the reference's
  double-rounded chains (a multiply, then an add, each rounded) and the
  same chains with every step fused into one FMA, emulated in float64. A
  kernel whose compiler contracted the DCT chains disagrees with the plain
  version on these blocks.
* ``content_kind``: the plane content kinds of ``tools/fuzz_tpu_frame.py``
  (:35): noise, gradient, flat, impulse, banded.
* ``encoder_families``: coefficient rows that stress the lane-group
  Huffman encoder of K1 and K5 (``csrc/block_huffman.cuh``), family by
  family (``ENCODER_FAMILIES``).
* ``decoder_families``: chunk streams that stress the decoder of K2 and
  K6 (the same header), family by family (``DECODER_FAMILIES``): every
  reachable error code, valid edge cases and offsets outside the content;
  ``back_to_back`` packs a family's chunks as a valid stream holds them.
* ``smooth_picture``: the smooth XRGB8888 picture of ``chip_smoke.py``'s
  CLI phase, the frame on which it and ``tools/kernel_ab.py`` time the
  kernels.
* ``every_colour_bgrx`` / ``every_yuv_triple``: a 4096x4096 BGRX frame that
  holds each 24-bit colour once, and IYUV planes whose pixels hold each
  (Y, U, V) triple once: the whole input domain of X1 and X2.
* ``cuda_ms``: the device time of a call, by CUDA events around calls
  queued behind a busy card, so the host's work is left out;
  ``card_ran_dry``: whether a streaming driver let the card run out of
  queued work before it had taken its last frame (a host sync);
  ``host_inclusive_ms``: CUDA events around one call on an idle card, for
  a function that synchronises (the plain decoder), whose time then
  includes the host's work.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from ..entropy.device import ZIGZAG, encode_lanes
from .constants import DCT_MATRIX8, PLANE_Q50, quality_scaled_qtable
from .device import blocks_to_plane, dct_quantize, plane_to_blocks

KINDS = ("noise", "gradient", "flat", "impulse", "banded")
ENCODER_FAMILIES = (
    "all_zero", "first_only", "last_only", "one_symbol", "n_sym_2",
    "n_sym_31", "n_sym_32", "n_sym_33", "n_sym_64", "long_run",
    "merge_ties", "word_crossing", "int16_extremes", "alias_11_bits",
    "ragged_count")
DECODER_FAMILIES = (
    "err1_short", "err2_sections", "err3_second_group", "err4_tree_size",
    "err5_payload_end", "err7_no_code", "err8_trailing", "one_symbol_x64",
    "enc_bits_0", "n_sym_64", "all_len_8", "over_subscribed",
    "under_subscribed", "groups_out_of_order", "chunk_255",
    "past_enc_bits", "word_crossing", "big_trees", "offsets_outside",
    "random_bytes")


def fma_quantize(blocks: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """[n, 8, 8] u8 -> int16 coefficients with every chain step fused."""
    c = DCT_MATRIX8
    x = blocks.astype(np.float32) - np.float32(128)

    def fma_mm(a, b):  # acc = fma(a_k, b_k, acc): one rounding per step
        acc = np.float32(np.float64(a[:, 0:1]) * np.float64(b[:, 0:1, :]))
        for k in range(1, 8):
            acc = np.float32(np.float64(a[:, k:k + 1])
                             * np.float64(b[:, k:k + 1, :])
                             + np.float64(acc))
        return acc

    t = fma_mm(c, x)
    coef = np.transpose(fma_mm(c, np.transpose(t, (0, 2, 1))), (0, 2, 1))
    qv = np.float32(coef / qtable[None])
    r = np.trunc(qv)
    bump = np.where(np.abs(qv - r) >= np.float32(0.5), np.sign(qv), 0)
    return (r + bump).astype(np.int16)


def contraction_probe_blocks(limit: int = 1024, seed: int = 11
                             ) -> np.ndarray:
    """Up to ``limit`` u8 [8, 8] blocks whose exact luma q50 coefficients
    differ from the contracted ones."""
    qt = quality_scaled_qtable(PLANE_Q50[0], 50)
    rng = np.random.default_rng(seed)
    for _ in range(8):
        cand = rng.integers(0, 256, (8192, 8, 8), np.uint8)
        exact = dct_quantize(torch.from_numpy(cand),
                             torch.from_numpy(qt)).numpy()
        diff = (exact != fma_quantize(cand, qt)).any(axis=(1, 2))
        if diff.any():
            return cand[diff][:limit]
    return np.zeros((0, 8, 8), np.uint8)


def with_probe_blocks(plane: np.ndarray, blocks: np.ndarray,
                      limit: int = 1024) -> np.ndarray:
    """A copy of ``plane`` whose first ``limit`` raster 8x8 blocks are the
    probe blocks, repeated."""
    h, w = plane.shape
    tiles = plane_to_blocks(torch.from_numpy(plane)).clone()
    n = min(limit, tiles.shape[0])
    tiles[:n] = torch.from_numpy(np.resize(blocks, (n, 8, 8)))
    return blocks_to_plane(tiles, h, w).numpy()


def content_kind(rng: np.random.Generator, kind: str, shape) -> np.ndarray:
    """One u8 plane of content kind ``kind`` (one of ``KINDS``)."""
    h, w = shape
    if kind == "noise":
        return rng.integers(0, 256, shape, np.uint8)
    if kind == "gradient":
        yy, xx = np.mgrid[0:h, 0:w]
        return ((xx * 255 // max(w - 1, 1) + yy // 7) % 256).astype(np.uint8)
    if kind == "flat":
        return np.full(shape, int(rng.integers(0, 256)), np.uint8)
    if kind == "impulse":
        p = np.full(shape, 128, np.uint8)
        n = int(rng.integers(10, 2000))
        p[rng.integers(0, h, n), rng.integers(0, w, n)] = \
            rng.integers(0, 256, n)
        return p
    if kind == "banded":  # alternating 0/255 rows at a random period
        per = int(rng.integers(1, 17))
        yy = np.arange(h)[:, None] // per % 2
        band = np.broadcast_to((yy * 255).astype(np.uint8), shape)
        return band ^ np.uint8(int(rng.integers(0, 2)) * 255)
    raise ValueError(f"unknown content kind {kind!r}")


def encoder_families(rng: np.random.Generator) -> dict:
    """``ENCODER_FAMILIES`` name -> int16 [k, 64] row-major coefficient rows
    (k = 5, except ``ragged_count``'s 53 rows, which are no multiple of the
    32 blocks a CTA of K1 or K5 codes):

    * all_zero; first_only / last_only: one nonzero symbol at zigzag
      position 0 / 63;
    * one_symbol, n_sym_2 .. n_sym_64: exactly that many distinct symbols
      over a full 64-symbol message;
    * long_run: 48 symbols of weight 1 and one of weight 16, so 48 codes of
      length 6 split over two tree groups;
    * merge_ties: weights 1, 1, 2, 2, 4, 4, 8, 8, so merge steps tie a leaf
      with an internal node;
    * word_crossing: dense random 11-bit symbols, whose tree fields and
      codes cross 32-bit words;
    * int16_extremes: the int16 range's ends and random int16 values;
    * alias_11_bits: 5, 2053 and -2043, which share their low 11 bits;
    * ragged_count: sparse random rows.
    """
    per = 5

    def from_messages(msgs):
        msgs = np.asarray(msgs, np.int64)
        rows = np.zeros((msgs.shape[0], 64), np.int64)
        rows[:, ZIGZAG[:msgs.shape[1]]] = msgs
        return rows.astype(np.int16)

    nonzero = np.concatenate([np.arange(-1024, 0), np.arange(1, 1024)])

    def n_distinct(n):
        msgs = []
        for _ in range(per):
            vals = rng.choice(nonzero, n, replace=False)
            msgs.append(rng.permutation(np.concatenate(
                [vals, rng.choice(vals, 64 - n)])))
        return from_messages(msgs)

    i16 = np.iinfo(np.int16)
    ext = rng.integers(i16.min, i16.max + 1, (per, 64))
    ext[0], ext[1] = i16.max, i16.min
    ext[2, ::2], ext[2, 1::2] = i16.min, i16.max
    return {
        "all_zero": np.zeros((per, 64), np.int16),
        "first_only": from_messages(rng.choice(nonzero, (per, 1))),
        "last_only": from_messages(np.pad(rng.choice(nonzero, (per, 1)),
                                          ((0, 0), (63, 0)))),
        "one_symbol": from_messages(
            np.repeat(rng.choice(nonzero, (per, 1)), 64, axis=1)),
        **{f"n_sym_{n}": n_distinct(n) for n in (2, 31, 32, 33, 64)},
        "long_run": from_messages([rng.permutation(np.concatenate(
            [rng.choice(np.arange(1, 500), 48, replace=False),
             np.full(16, -777)])) for _ in range(per)]),
        "merge_ties": from_messages([rng.permutation(np.repeat(
            rng.choice(nonzero, 8, replace=False), [1, 1, 2, 2, 4, 4, 8, 8]))
            for _ in range(per)]),
        "word_crossing": (rng.integers(-1024, 1024, (per, 64))
                          * (rng.random((per, 64)) < 0.6)).astype(np.int16),
        "int16_extremes": ext.astype(np.int16),
        "alias_11_bits": from_messages(rng.choice([5, 2053, -2043],
                                                  (per, 20))),
        "ragged_count": (rng.integers(-300, 300, (53, 64))
                         * (rng.random((53, 64)) < rng.random((53, 1)))
                         ).astype(np.int16),
    }


def _tree(groups) -> list:
    """Tree section bytes of groups [(length, [symbols])]."""
    out = []
    for ln, syms in groups:
        out.append(((ln - 1) << 5) | (len(syms) - 1))
        acc = 0
        for k, v in enumerate(syms):
            acc |= (int(v) & 0x7FF) << (11 * k)
        out += list(acc.to_bytes((11 * len(syms) + 7) // 8, "little"))
    return out


def _codes(groups) -> dict:
    """(length, index within the length) -> canonical code, as native's
    decoder assigns them: the stored order within a length."""
    counts = [0] * 9
    for ln, syms in groups:
        counts[ln] += len(syms)
    codes, first = {}, 0
    for ln in range(1, 9):
        for i in range(counts[ln]):
            codes[(ln, i)] = first + i
        first = (first + counts[ln]) << 1
    return codes


def _bits(codes) -> list:
    """Stream bits of codes [(code, length)], each MSB-first."""
    return [(c >> (ln - 1 - i)) & 1 for c, ln in codes for i in range(ln)]


def _chunk(groups, bits, enc_bits=None, tree_size=None, pad_bits=0,
           extra=()) -> np.ndarray:
    """A chunk: header, tree, payload ``bits`` (its last byte's unused bits
    set to ``pad_bits``), then ``extra`` bytes."""
    tree = _tree(groups)
    nbytes = (len(bits) + 7) // 8
    payload = [0] * nbytes
    for i, b in enumerate(list(bits) + [pad_bits & 1] * (8 * nbytes
                                                         - len(bits))):
        payload[i >> 3] |= b << (i & 7)
    eb = len(bits) if enc_bits is None else enc_bits
    ts = len(tree) if tree_size is None else tree_size
    return np.array([eb & 0xFF, eb >> 8, ts] + tree + payload + list(extra),
                    np.uint8)


def _use(groups, picks) -> list:
    """Stream bits of the codes of (length, index) picks."""
    codes = _codes(groups)
    return _bits([(codes[p], p[0]) for p in picks])


def _pack(rng, chunks, offsets=None):
    """Chunks back to back with 0..3 garbage bytes between them (so they
    start at every alignment and bytes past a chunk's size are not 0) ->
    (content u8, sizes i32, offsets i64); ``offsets`` maps a chunk index to
    an offset of its own, relative to the content's length if negative
    keys... given as a callable of the content length."""
    parts, offs, at = [], [], 0
    for c in chunks:
        gap = rng.integers(0, 256, int(rng.integers(0, 4)), np.uint8)
        parts += [gap, c]
        at += gap.size
        offs.append(at)
        at += c.size
    content = (np.concatenate(parts) if parts else np.zeros(0, np.uint8))
    offs = np.array(offs, np.int64)
    if offsets is not None:
        offs = offsets(offs, content.size)
    return content, np.array([c.size for c in chunks], np.int32), offs


def _encoded(rows) -> list:
    """The plain encoder's chunks of int16 [k, 64] rows."""
    lanes, sizes, _ = encode_lanes(torch.from_numpy(np.asarray(rows,
                                                               np.int16)))
    return [lanes[i, :int(sizes[i])].numpy().copy()
            for i in range(len(sizes))]


def back_to_back(content: np.ndarray, sizes: np.ndarray,
                 offsets: np.ndarray):
    """The chunks of a stream as a decoder sees them (bytes outside
    ``content`` read as 0), packed back to back as a valid stream holds
    them -> (content, sizes, offsets)."""
    chunks = []
    for size, off in zip(sizes.tolist(), offsets.tolist()):
        idx = off + np.arange(size)
        inside = (idx >= 0) & (idx < content.size)
        chunk = np.zeros(size, np.uint8)
        chunk[inside] = content[idx[inside]]
        chunks.append(chunk)
    packed = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    return (packed, sizes.copy(),
            (np.cumsum(sizes, dtype=np.int64) - sizes).astype(np.int64))


def decoder_families(rng: np.random.Generator) -> dict:
    """``DECODER_FAMILIES`` name -> (content u8 [T], sizes i32 [N], offsets
    i64 [N]), the decoders' input contract. Chunks lie back to back with
    0..3 garbage bytes between them, so they start at every alignment.

    * err1..err8: chunks native rejects with that code: too short (sizes
      0..2); sections past the chunk (a cut chunk, tree_size 255,
      enc_bits too large); a 65th symbol of one length at its third group;
      a tree section shorter or longer than tree_size, or cut mid-group; a
      code cut by the payload end, with and without a code that would
      hold the peek (payload bits left < 8), with the chunk's next bits
      completing the cut code; no code of <= 8 bits with exactly 8 and with
      more bits left, and a code in an under-subscribed tree's gap; 64
      symbols with bits left over. (Code 6 cannot occur.)
    * valid edge cases: one 1-bit symbol 64 times; enc_bits 0 (an empty
      tree, and a full one); 64 distinct symbols; only 8-bit codes; an
      over-subscribed tree (Kraft sum > 1, which native decodes); an
      under-subscribed one; length groups out of order (L3, L1, L3); chunks
      of 255 bytes (a padded one; a 178-symbol tree, the most a 255-byte
      chunk holds, without payload; a big tree with payload); nonzero bits
      past enc_bits, in the last payload byte and in bytes after it;
      encoded blocks of dense random symbols, whose fields and codes cross
      32-bit words; 40 chunks of 255 bytes with 178-symbol trees, more than
      a decoder warp's staging buffer and symbol pool hold at once;
    * offsets_outside: valid chunks read from offsets that are negative
      (partly and wholly before the content), partly past its end and
      wholly past it;
    * random_bytes: random trees with random payload bits and enc_bits,
      and random bytes.
    """
    def ri(lo, hi, n=None):
        return rng.integers(lo, hi, n)

    def syms(n):
        return [int(v) for v in ri(-1024, 1024, n)]

    fam = {}
    valid = _encoded(np.where(rng.random((6, 64)) < 0.5,
                              ri(-20, 21, (6, 64)), 0))
    v = valid[1]
    fam["err1_short"] = [v[:0], v[:1], v[:2], np.array([9, 9], np.uint8)]
    big = v.copy()
    big[2] = 255
    more = v.copy()
    more[0], more[1] = 0xFF, 0x7F
    fam["err2_sections"] = [v[:-1], big, more]

    g3 = [(2, syms(32)), (2, syms(20)), (5, syms(3)), (2, syms(13))]
    g3b = [(1, syms(32)), (1, syms(32)), (4, syms(1)), (1, syms(1))]
    fam["err3_second_group"] = [
        _chunk(g3, []), _chunk(g3b, []),
        _chunk(g3, [], tree_size=len(_tree(g3)) + 7, extra=[0] * 7)]

    g4 = [(3, syms(5)), (2, syms(2))]
    t4 = len(_tree(g4))
    bits4 = _use(g4, [(3, 1), (2, 0)])
    fam["err4_tree_size"] = [
        _chunk(g4, bits4, tree_size=t4 - 1),
        _chunk(g4, bits4, tree_size=t4 + 1, extra=[0]),
        _chunk(g4, bits4, tree_size=t4 - 2)]

    g5 = [(2, syms(2)), (3, syms(2))]
    g1 = [(1, syms(1))]
    g8 = [(8, syms(9))]
    fam["err5_payload_end"] = [
        # a 3-bit code with 2 bits left, pad bits 0 and 1
        _chunk(g5, _use(g5, [(2, 0)]) + [1, 0], pad_bits=0),
        _chunk(g5, _use(g5, [(2, 0)]) + [1, 0], pad_bits=1),
        # no code holds the peek, 4 bits left
        _chunk(g1, [0, 0, 0, 1, 0, 1, 1]),
        # an 8-bit code cut after 5 bits; the byte holds the rest
        _chunk(g8, _use(g8, [(8, 3), (8, 5)]), enc_bits=13),
        # the last code of a valid payload cut by one bit
        _chunk(g5, _use(g5, [(3, 1), (2, 1), (3, 0)]), enc_bits=7)]

    gu = [(2, syms(1)), (3, syms(1))]
    fam["err7_no_code"] = [
        _chunk(g1, [1] + list(ri(0, 2, 7))),            # exactly 8 bits left
        _chunk(g1, [0, 0] + [1] + list(ri(0, 2, 11))),  # 12 bits left
        _chunk(gu, _use(gu, [(2, 0), (3, 0)]) + [0, 1, 1, 1, 1, 1, 1, 1])]

    fam["err8_trailing"] = [
        _chunk(g1, [0] * 72),
        _chunk(g5, _use(g5, [(2, int(i)) for i in ri(0, 2, 64)]) + [0])]

    fam["one_symbol_x64"] = [_chunk(g1, [0] * 64),
                             _chunk([(1, [-1024])], [0] * 64)]
    fam["enc_bits_0"] = [np.zeros(3, np.uint8), _chunk(g3[:2], []),
                         _chunk(g5, [], extra=[0xAB, 0xCD])]
    fam["n_sym_64"] = _encoded([rng.permutation(np.concatenate(
        [np.arange(-32, 0), np.arange(1, 33)])) for _ in range(3)])
    g88 = [(8, syms(32)), (8, syms(8))]
    fam["all_len_8"] = [_chunk(g88, _use(g88, [(8, int(i))
                                               for i in ri(0, 40, 64)]))]
    go = [(1, syms(3)), (2, syms(2)), (3, syms(5))]
    go2 = [(2, syms(5))]
    fam["over_subscribed"] = [_chunk(go, list(ri(0, 2, 50))),
                              _chunk(go2, list(ri(0, 2, 64)))]
    gus = [(2, syms(1)), (3, syms(1)), (5, syms(2))]
    fam["under_subscribed"] = [_chunk(gus, _use(gus, [
        (2, 0), (3, 0), (5, 1), (5, 0), (2, 0), (5, 1)]))]
    gooo = [(3, syms(3)), (1, syms(1)), (3, syms(2)), (2, syms(1))]
    fam["groups_out_of_order"] = [_chunk(gooo, _use(gooo, [
        (3, 4), (1, 0), (3, 0), (2, 0), (3, 3), (3, 2), (1, 0)]))]

    pad = valid[2]
    big178 = [(8, syms(32)), (8, syms(32)), (7, syms(32)), (7, syms(32)),
              (6, syms(32)), (6, syms(18))]
    big_pay = [(8, syms(32)), (8, syms(32)), (7, syms(32)), (7, syms(32)),
               (6, syms(32)), (1, syms(1))]
    tp = len(_tree(big_pay))
    fam["chunk_255"] = [
        np.concatenate([pad, ri(0, 256, 255 - pad.size).astype(np.uint8)]),
        _chunk(big178, [], extra=[0x5A]),
        _chunk(big_pay, _use(big_pay, [
            (6, int(i)) for i in ri(0, 32, 20)] + [(1, 0)] * 44),
            extra=[0x77] * (252 - tp - 21)),
    ]
    assert all(c.size == 255 for c in fam["chunk_255"])

    fam["past_enc_bits"] = [
        _chunk(gooo, _use(gooo, [(3, 1), (1, 0)]), pad_bits=1,
               extra=ri(0, 256, 5)),
        _chunk(g5, _use(g5, [(2, 1), (3, 1), (3, 0)]), pad_bits=1)]
    fam["word_crossing"] = _encoded(
        (ri(-1024, 1024, (12, 64)) * (rng.random((12, 64)) < 0.8))
        .astype(np.int16))
    big = []
    for i in range(40):
        groups = [(8, syms(32)), (8, syms(32)), (7, syms(32)),
                  (7, syms(32)), (6, syms(32)), (i % 3 + 1, syms(18))]
        big.append(_chunk(groups, _use(groups, [(6, int(ri(0, 32)))])))
    fam["big_trees"] = big
    fam["random_bytes"] = []
    for _ in range(48):  # random trees and payload bits
        groups = [(int(ri(1, 9)), syms(int(ri(1, 13))))
                  for _ in range(int(ri(1, 6)))]
        bits = list(ri(0, 2, int(ri(0, 160))))
        fam["random_bytes"].append(_chunk(
            groups, bits, enc_bits=max(0, len(bits) - int(ri(0, 9))),
            pad_bits=int(ri(0, 2))))
    for _ in range(16):  # random bytes
        tree = list(ri(0, 256, int(ri(0, 40))))
        pay = list(ri(0, 256, int(ri(0, 30))))
        eb = int(ri(0, 8 * len(pay) + 9))
        fam["random_bytes"].append(np.array(
            [eb & 0xFF, eb >> 8, (len(tree) + int(ri(-2, 3))) % 256]
            + tree + pay, np.uint8))

    out = {name: _pack(rng, chunks) for name, chunks in fam.items()}

    def outside(offs, total):
        offs = offs.copy()
        offs[0], offs[1] = -3, -400          # partly / wholly before
        offs[2], offs[3] = total - 5, total + 100  # partly / wholly past
        return offs

    out["offsets_outside"] = _pack(rng, valid[:5], outside)
    return {name: out[name] for name in DECODER_FAMILIES}


def smooth_picture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth XRGB8888 picture with a little noise, u8 [h, w, 4]."""
    yy, xx = np.mgrid[0:h, 0:w]
    px = np.empty((h, w, 4), np.uint8)
    noise = rng.integers(-6, 7, (3, h, w))
    for c, (fy, fx) in enumerate(((0.11, 0.07), (0.05, 0.13), (0.09, 0.03))):
        base = 128 + 100 * np.sin(yy * fy / 7) * np.cos(xx * fx / 9)
        px[..., c] = np.clip(base + noise[c], 0, 255).astype(np.uint8)
    px[..., 3] = 255
    return px


def every_colour_bgrx(rng: np.random.Generator) -> np.ndarray:
    """u8 [4096, 4096, 4] BGRX: every 24-bit (B, G, R) once, in random
    order, with random X bytes."""
    words = rng.permutation(1 << 24).astype(np.uint32)
    words |= rng.integers(0, 256, words.size, np.uint32) << 24
    return words.reshape(4096, 4096).view(np.uint8).reshape(4096, 4096, 4)


def every_yuv_triple() -> tuple:
    """(y [4096, 4096], u, v [2048, 2048]) u8 whose 2^24 pixels, each read
    with its 2x2 quad's chroma sample, hold every (Y, U, V) once: chroma
    sample s carries (U, V) = divmod(s // 64, 256) and its quad the Y
    values 4 (s % 64) + 0..3."""
    s = np.arange(2048 * 2048).reshape(2048, 2048)
    pair, k = s // 64, s % 64
    y = np.empty((4096, 4096), np.uint8)
    for di in range(2):
        for dj in range(2):
            y[di::2, dj::2] = 4 * k + 2 * di + dj
    return y, (pair >> 8).astype(np.uint8), (pair & 255).astype(np.uint8)


def _sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per ms of device time, from one
    timed sleep."""
    cycles = 1 << 20
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / a.elapsed_time(b)


def cuda_ms(fn, reps: int = 7, calls: int = 10, tries: int = 5) -> float:
    """Median device time of one fn() in ms over ``reps`` readings, after
    two warm-up calls. A reading is CUDA events around ``calls``
    back-to-back calls, divided by ``calls``, queued behind a sleep kernel
    that lasts three times as long as the host took to enqueue them (plus
    2 ms): the card runs the calls one after another, and the host's work
    (checks, allocation, launch) is not in the time. If the start event had
    passed by the time the host had queued the calls, the card may have
    waited on the host: the reading is dropped and taken again behind a
    sleep twice as long, so a pause of the host's own (another process on
    its cores) costs a reading, not the timer. Raises RuntimeError when
    ``tries`` readings in a row were so paced: a fn that synchronises lets
    every sleep end, however long (time it with ``host_inclusive_ms``)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(_sleep_cycles_per_ms() * (3 * enqueue_ms + 2.0))
    times = []
    paced = 0
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles << paced)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        host_paced = a.query()
        torch.cuda.synchronize()
        if not host_paced:
            times.append(a.elapsed_time(b) / calls)
            paced = 0
            continue
        paced += 1
        if paced == tries:
            raise RuntimeError("cuda_ms: the card ran out of queued work "
                               f"before the host had queued the calls, "
                               f"{tries} times in a row")
    return statistics.median(times)


def card_ran_dry(drive, item, n: int = 16, tries: int = 3) -> bool:
    """Whether the card ran out of queued work while ``drive(frames)``
    took ``n`` copies of ``item`` from the iterable ``frames``. A sleep
    kernel lasting twice a warm run of ``drive`` (plus 50 ms) is queued
    first, and before handing over each copy, and after the last, the
    iterable checks whether the sleep has ended: a driver that
    synchronises the host before it has taken (and queued) its last frame
    lets it end. A sleep that ended is tried again, up to ``tries`` times,
    each twice as long as the last, so a pause of the host's own (another
    process on its cores) is not taken for a sync; a driver that
    synchronises lets every sleep end."""
    t0 = time.perf_counter()
    drive([item] * n)
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(_sleep_cycles_per_ms() * (2 * warm_ms + 50.0))
    for attempt in range(tries):
        slept = torch.cuda.Event()
        ended = []

        def frames():
            for _ in range(n):
                ended.append(slept.query())
                yield item
            ended.append(slept.query())

        torch.cuda._sleep(cycles << attempt)
        slept.record()
        drive(frames())
        torch.cuda.synchronize()
        if not any(ended):
            return False
    return True


def host_inclusive_ms(fn, reps: int = 7) -> float:
    """Median time of fn() in ms over ``reps`` readings, after two warm-up
    calls: CUDA events around one call each on an idle card. The reading
    starts before fn's host work, so it counts whatever of that work the
    card waits for."""
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
