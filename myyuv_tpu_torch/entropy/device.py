"""Plain PyTorch canonical Huffman coder, vectorised over blocks.

Port of ``myyuv_tpu/entropy/device.py`` (``encode_lanes`` :216,
``decode_lanes`` :129) with the byte-level semantics of
``myyuv_tpu/native/entropy.cpp`` (``encode_block`` :134, ``decode_block``
:245). These are the plain versions of the entropy halves of the codec
kernels, and ``parse_tree_lanes`` that of T5, the decoder's tree stage
alone; ``entropy/encode.py`` and ``entropy/decode.py`` call them for
tensors that lie on the CPU, and the chip check holds the kernels against
them on the card.

Chunk layout (Huffman.cpp; ``myyuv_tpu/entropy/reference.py:8-26``)::

  u16 encoded_bits (LE), u8 tree_size,
  groups: u8 ((len-1) << 5 | (count-1)), count 11-bit symbols LSB-first,
  payload: each code MSB-first, bits packed LSB-first in bytes.

The encoder's tie-breaks are native's, so its bytes equal native's:
symbols ascending, a stable sort of the distinct symbols by weight, the
two-queue merge where a leaf wins a tie, then a stable sort by length for
the canonical order. The decoder returns native's error codes 1..8 per
block (0 = valid).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

LANE = 256
# zigzag scan: message position i reads coefficient ZIGZAG[i] of the block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)
I32 = torch.int32
_BIG = 1 << 20
# sorts after every int16 symbol (and its negation before every one)
_PAST_INT16 = 1 << 16
# at most 85 tree groups fit a 255-byte tree section (each takes >= 3 bytes)
_MAX_GROUPS = 85


def _bitrev8(v: torch.Tensor) -> torch.Tensor:
    v = ((v & 0xF0) >> 4) | ((v & 0x0F) << 4)
    v = ((v & 0xCC) >> 2) | ((v & 0x33) << 2)
    return ((v & 0xAA) >> 1) | ((v & 0x55) << 1)


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1, dtype=I32) - x


def encode_lanes(coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """[N, 64] int16 row-major coefficients -> (lanes u8 [N, 256], sizes
    i32 [N], err i32 [N]).

    Lane b holds chunk b's bytes, zero beyond ``sizes[b]``. Distinct
    symbols are the full int16 values, each stored as its low 11 bits
    (native's ``& 0x7FF``). ``err`` is 1 only for a chunk longer than the
    format's 255 bytes (its lane is then zero); no int16 input makes one.
    """
    dev = coeffs.device
    n = coeffs.shape[0]
    pos64 = torch.arange(64, device=dev, dtype=I32)[None, :]
    m = coeffs.to(I32)[:, torch.as_tensor(ZIGZAG, device=dev)]

    # zigzag message with trailing zeros trimmed (all-zero -> one 0 symbol)
    mlen = torch.where(m != 0, pos64 + 1, 0).amax(dim=1).clamp(min=1)
    valid = pos64 < mlen[:, None]

    # distinct symbols ascending + their frequencies (valid entries sort
    # first; group id gid per sorted entry)
    sv, sidx = torch.sort(torch.where(valid, m, _PAST_INT16), dim=1,
                          stable=True)
    prev = torch.cat([torch.full((n, 1), -_PAST_INT16, dtype=I32,
                                 device=dev),
                      sv[:, :-1]], dim=1)
    is_new = (sv != prev) & valid
    gid = torch.cumsum(is_new, dim=1, dtype=I32) - 1
    n_sym = is_new.sum(dim=1, dtype=I32)
    freq = torch.zeros((n, 65), dtype=I32, device=dev).scatter_add_(
        1, torch.where(valid, gid, 64).long(), valid.to(I32))[:, :64]
    symval = torch.zeros((n, 65), dtype=I32, device=dev).scatter_(
        1, torch.where(is_new, gid, 64).long(), sv)[:, :64]
    gorig = torch.zeros((n, 64), dtype=I32, device=dev).scatter_(
        1, sidx, torch.where(valid, gid, 0))        # group per message pos

    # optimal lengths: stable sort by weight, two-queue merge (leaf wins
    # ties), depths by a descending sweep over node ids. Node ids: sorted
    # leaves 0..63, internal node k at 64 + k.
    in_range = pos64 < n_sym[:, None]
    leafw, order = torch.sort(torch.where(in_range, freq, _BIG), dim=1,
                              stable=True)
    zero = torch.zeros(n, dtype=I32, device=dev)
    lh, ih, it = zero.clone(), zero.clone(), zero.clone()
    intw = torch.full((n, 65), _BIG, dtype=I32, device=dev)
    parent = torch.zeros((n, 129), dtype=I32, device=dev)
    for _ in range(63):
        active = it < n_sym - 1
        picks, wsum = [], zero
        for _p in range(2):
            lw = leafw.gather(1, lh.clamp(max=63).long()[:, None])[:, 0]
            iw = intw.gather(1, ih.clamp(max=63).long()[:, None])[:, 0]
            take_leaf = (lh < n_sym) & ((ih >= it) | (lw <= iw))
            picks.append(torch.where(take_leaf, lh, 64 + ih))
            wsum = wsum + torch.where(take_leaf, lw, iw)
            lh = lh + (take_leaf & active).to(I32)
            ih = ih + (~take_leaf & active).to(I32)
        for node in picks:
            parent.scatter_(1, torch.where(active, node, 128).long()[:, None],
                            (64 + it)[:, None])
        intw.scatter_(1, torch.where(active, it, 64).long()[:, None],
                      wsum[:, None])
        it = it + active.to(I32)
    root = 64 + n_sym - 2
    depth = torch.zeros((n, 129), dtype=I32, device=dev)
    for nid in range(126, 63, -1):
        pd = depth.gather(1, parent[:, nid:nid + 1].long())[:, 0] + 1
        depth[:, nid] = torch.where(root == nid, 0, pd)
    leaf_len = depth.gather(1, parent[:, :64].long()) + 1
    leaf_len = torch.where(n_sym[:, None] == 1, 1, leaf_len)
    glen = torch.zeros((n, 65), dtype=I32, device=dev).scatter_(
        1, torch.where(in_range, order, 64).long(), leaf_len)[:, :64]

    # canonical order (length, symbol) ascending and Kraft-sum codes
    corder = torch.sort(torch.where(in_range, glen * 64 + pos64, _BIG),
                        dim=1).indices
    len_c = glen.gather(1, corder).clamp(1, 8)
    sym_c = symval.gather(1, corder)
    kraft = torch.where(in_range, 1 << (8 - len_c), 0)
    code_c = _excl_cumsum(kraft) >> (8 - len_c)
    gcode = torch.zeros((n, 65), dtype=I32, device=dev).scatter_(
        1, torch.where(in_range, corder, 64), code_c)[:, :64]
    enc_bits = torch.where(in_range, freq * glen, 0).sum(dim=1, dtype=I32)

    # tree groups: runs of equal length in canonical order, <= 32 per group
    prev_len = torch.cat([torch.full((n, 1), -1, dtype=I32, device=dev),
                          len_c[:, :-1]], dim=1)
    run_start = in_range & (len_c != prev_len)
    idx_in_run = pos64 - torch.cummax(
        torch.where(run_start, pos64, -1), dim=1).values
    grp_start = in_range & (idx_in_run % 32 == 0)
    idx_in_grp = pos64 - torch.cummax(
        torch.where(grp_start, pos64, -1), dim=1).values
    tgid = torch.cumsum(grp_start, dim=1, dtype=I32) - 1
    tgid_s = torch.where(in_range, tgid, 64).long()
    gcnt = torch.zeros((n, 65), dtype=I32, device=dev).scatter_add_(
        1, tgid_s, in_range.to(I32))[:, :64]
    grp_bytes = torch.where(gcnt > 0, 1 + (gcnt * 11 + 7) // 8, 0)
    goff = _excl_cumsum(grp_bytes)
    tree_size = grp_bytes.sum(dim=1, dtype=I32)
    sizes = 3 + tree_size + (enc_bits + 7) // 8

    # serialise: every contribution owns disjoint bits, so adding them into
    # an int32 canvas equals OR-ing them; column 263 is a sink
    canvas = torch.zeros((n, LANE + 8), dtype=I32, device=dev)
    canvas[:, 0] = enc_bits & 0xFF
    canvas[:, 1] = enc_bits >> 8
    canvas[:, 2] = tree_size & 0xFF

    def add(byte_pos, val, mask):
        idx = torch.where(mask, byte_pos.clamp(0, LANE + 6), LANE + 7)
        canvas.scatter_add_(1, idx.long(), torch.where(mask, val, 0))

    g_off = 3 + goff.gather(1, tgid_s.clamp(max=63))
    hdr = ((len_c - 1) << 5) | (gcnt.gather(1, tgid_s.clamp(max=63)) - 1)
    add(g_off, hdr, grp_start)
    sbit = idx_in_grp * 11
    sval = (sym_c & 0x7FF) << (sbit & 7)
    for k in range(3):
        add(g_off + 1 + (sbit >> 3) + k, (sval >> (8 * k)) & 0xFF, in_range)
    plen = glen.gather(1, gorig.long())
    prev_bits = _excl_cumsum(torch.where(valid, plen, 0))
    rcode = _bitrev8(gcode.gather(1, gorig.long())) >> (8 - plen)
    pbit = (3 + tree_size)[:, None] * 8 + prev_bits
    pval = rcode << (pbit & 7)
    for k in range(2):
        add((pbit >> 3) + k, (pval >> (8 * k)) & 0xFF, valid)

    err = (sizes > 255).to(I32)
    lanes = torch.where(err[:, None] != 0, 0, canvas[:, :LANE])
    return lanes.to(torch.uint8), sizes, err


def gather_lanes(content: torch.Tensor, sizes: torch.Tensor,
                 offsets: torch.Tensor) -> torch.Tensor:
    """Ragged stream -> [N, 256] u8 lanes, zero beyond each chunk's size
    and outside ``content``."""
    j = torch.arange(LANE, device=content.device)
    idx = offsets.long()[:, None] + j[None, :]
    mask = ((j[None, :] < sizes.long()[:, None]) & (idx >= 0)
            & (idx < content.numel()))
    if content.numel() == 0:
        return torch.zeros(idx.shape, dtype=torch.uint8, device=content.device)
    vals = content[idx.clamp(0, content.numel() - 1)]
    return torch.where(mask, vals, 0).to(torch.uint8)


def _byte_at(L: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return L.gather(1, idx.clamp(0, LANE + 7).long()[:, None])[:, 0]


def _tree_tables(L: torch.Tensor, sizes: torch.Tensor):
    """The tree stage of the decoder: [N, 264] i32 lane bytes (zero past
    byte 256) + i32 sizes -> (counts i32 [N, 9] per code length 0..8,
    symtab i32 [N, 577] (the symbols of length L at L * 64 + 0..63, in
    stream order), err i32 [N] (0 or native's code 1..4), enc_bits,
    tree_size)."""
    dev = L.device
    n = L.shape[0]
    enc_bits = L[:, 0] | (L[:, 1] << 8)
    tree_size = L[:, 2]
    err = torch.where(sizes < 3, 1, 0).to(I32)
    err = torch.where(
        (err == 0) & (3 + tree_size + (enc_bits + 7) // 8 > sizes), 2, err)

    # tree groups -> counts[len] and symtab[len][0..63] (slot 576 = sink)
    counts = torch.zeros((n, 9), dtype=I32, device=dev)
    symtab = torch.zeros((n, 9 * 64 + 1), dtype=I32, device=dev)
    pos = torch.full((n,), 3, dtype=I32, device=dev)
    toff = torch.arange(32, device=dev, dtype=I32)[None, :]
    for _ in range(_MAX_GROUPS):
        active = (err == 0) & (pos - 3 < tree_size)
        if not bool(active.any()):
            break
        info = _byte_at(L, pos)
        ln = (info >> 5) + 1
        cnt = (info & 31) + 1
        have = counts.gather(1, ln.long()[:, None])[:, 0]
        err = torch.where(active & (have + cnt > 64), 3, err)
        ok = active & (err == 0)
        bit = (pos[:, None] + 1) * 8 + toff * 11
        b = (bit >> 3).clamp(0, LANE + 5).long()
        word = L.gather(1, b) | (L.gather(1, b + 1) << 8) \
            | (L.gather(1, b + 2) << 16)
        v = (word >> (bit & 7)) & 0x7FF
        sym = torch.where(v >= 1024, v - 2048, v)
        slot = ln[:, None] * 64 + have[:, None] + toff
        put = ok[:, None] & (toff < cnt[:, None])
        symtab.scatter_(1, torch.where(put, slot, 9 * 64).long(), sym)
        counts.scatter_add_(1, ln.long()[:, None],
                            torch.where(ok, cnt, 0)[:, None])
        pos = torch.where(active, pos + 1 + (cnt * 11 + 7) // 8, pos)
    err = torch.where((err == 0) & (pos - 3 != tree_size), 4, err)
    return counts, symtab, err, enc_bits, tree_size


def parse_tree_lanes(lanes: torch.Tensor, sizes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The decoder's tree stage alone: [N, 256] u8 lanes (zero beyond each
    size) + sizes -> (symbols int16 [N, 64], counts i32 [N, 8], err i32
    [N]).

    ``symbols`` holds the first 64 symbols of the tree section in
    canonical order (by code length, then as stored within a length: the
    order in which canonical codes are assigned, which is the stored order
    of every encoder's stream), sign-extended from 11 bits, zero past
    their count; ``counts[:, L - 1]`` the number of codes of length L;
    ``err`` native ``decode_block``'s code 1..4 for a bad tree, else 0 (a
    bad payload, codes 5..8, is the payload stage's to find). A bad
    block's symbols and counts are 0.
    """
    L = torch.nn.functional.pad(lanes.to(I32), (0, 8))
    counts, symtab, err, _, _ = _tree_tables(L, sizes.to(I32))
    counts = torch.where(err[:, None] != 0, 0, counts[:, 1:])
    incl = torch.cumsum(counts, dim=1, dtype=I32)
    k = torch.arange(64, device=lanes.device, dtype=I32)
    # code length - 1 of canonical symbol k (8: past the count)
    l0 = (k[None, :, None] >= incl[:, None, :]).sum(dim=2, dtype=I32)
    start = (incl - counts).gather(1, l0.clamp(max=7).long())
    idx = (l0 + 1) * 64 + k[None, :] - start
    syms = symtab.gather(1, idx.clamp(0, 9 * 64 - 1).long())
    return torch.where(l0 < 8, syms, 0).to(torch.int16), counts, err


def decode_lanes(lanes: torch.Tensor, sizes: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, 256] u8 lanes (zero beyond each size) + sizes -> (coefficients
    int16 [N, 64] row-major, err i32 [N]).

    ``err`` is native ``decode_block``'s code: 1 chunk < 3 bytes, 2
    sections longer than the chunk, 3 more than 64 symbols of one length,
    4 tree section size mismatch, 5 payload ends inside a code, 6 bad
    code, 7 no code of <= 8 bits, 8 trailing bits. A bad block's
    coefficients are 0.
    """
    dev = lanes.device
    n = lanes.shape[0]
    # bytes past the lane read as 0, as in the kernel
    L = torch.nn.functional.pad(lanes.to(I32), (0, 8))
    counts, symtab, err, enc_bits, tree_size = _tree_tables(
        L, sizes.to(I32))

    # canonical decode, one bit at a time (puff.c first/count walk)
    coeffs = torch.zeros((n, 64), dtype=I32, device=dev)
    bitpos = torch.zeros(n, dtype=I32, device=dev)
    pbit0 = (3 + tree_size) * 8
    zero = torch.zeros(n, dtype=I32, device=dev)
    for j in range(64):
        step = (err == 0) & (bitpos < enc_bits)
        if not bool(step.any()):
            break
        code, first, sym = zero, zero, zero
        found = torch.zeros(n, dtype=torch.bool, device=dev)
        for ln in range(1, 9):
            out = step & (bitpos >= enc_bits)
            err = torch.where(out, 5, err)
            step = step & ~out
            p = pbit0 + bitpos
            bit = (_byte_at(L, p >> 3) >> (p & 7)) & 1
            code = torch.where(step, code | bit, code)
            bitpos = torch.where(step, bitpos + 1, bitpos)
            c = counts[:, ln]
            hit = step & (code < first + c)
            err = torch.where(hit & (c == 0), 6, err)
            good = hit & (c > 0)
            idx = (ln * 64 + code - first).clamp(0, 9 * 64 - 1)
            looked_up = symtab.gather(1, idx.long()[:, None])[:, 0]
            sym = torch.where(good, looked_up, sym)
            found = found | good
            step = step & ~hit
            first = torch.where(step, (first + c) << 1, first)
            code = torch.where(step, code << 1, code)
        err = torch.where(step, 7, err)
        col = int(ZIGZAG[j])
        coeffs[:, col] = torch.where(found, sym, coeffs[:, col])
    err = torch.where((err == 0) & (bitpos != enc_bits), 8, err)
    coeffs = torch.where(err[:, None] != 0, 0, coeffs)
    return coeffs.to(torch.int16), err
