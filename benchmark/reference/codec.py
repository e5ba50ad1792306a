"""Plain reference of the `.myyuv` DCT codec, for the benchmark's output check.

A frozen, self-contained copy of the codec's semantics in plain PyTorch. It
imports nothing of the program under test, nor JAX, and takes nothing the
program made: the tables are worked out here from the format's constants.
Every function runs on whatever device its inputs lie on.

The arithmetic is the reference codec's (myyuv_lib DCT.cpp, Huffman.cpp):

* the 8x8 DCT-II as sequential float32 products and sums, k ascending, each
  rounded (separate elementwise operations never contract into an FMA, and
  no matmul is used, so TF32 cannot enter);
* quantisation ``int16(round_half_away(RN(coef / q)))``, decided without
  trusting the device's divide;
* reconstruction ``clamp(round_half_away(x) + 128, 0, 255)``;
* per-block canonical Huffman chunks with the native coder's tie-breaks:
  symbols ascending, a stable sort by weight, the two-queue merge where a
  leaf wins a tie, then a stable sort by length.

Chunk layout: u16 encoded_bits (LE), u8 tree_size, tree groups
(u8 ``(len-1) << 5 | (count-1)``, then ``count`` 11-bit symbols LSB-first),
then the payload (each code MSB-first, bits packed LSB-first in bytes).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

F32 = torch.float32
I32 = torch.int32
LANE = 256

DCT_MATRIX8 = np.array([
    [0.3535533845424652, 0.3535533845424652, 0.3535533845424652,
     0.3535533845424652, 0.3535533845424652, 0.3535533845424652,
     0.3535533845424652, 0.3535533845424652],
    [0.4903925955295563, 0.4157347679138184, 0.277785062789917,
     0.09754510968923569, -0.09754515439271927, -0.2777851521968842,
     -0.4157347977161407, -0.4903926253318787],
    [0.4619397222995758, 0.1913416981697083, -0.1913417428731918,
     -0.4619397819042206, -0.4619397222995758, -0.1913415491580963,
     0.1913417875766754, 0.4619397521018982],
    [0.4157347679138184, -0.09754515439271927, -0.4903926253318787,
     -0.2777849733829498, 0.2777851819992065, 0.4903925955295563,
     0.09754502773284912, -0.4157348573207855],
    [0.3535533547401428, -0.3535533547401428, -0.353553295135498,
     0.3535534739494324, 0.3535533547401428, -0.3535535931587219,
     -0.3535532355308533, 0.3535533845424652],
    [0.277785062789917, -0.4903926253318787, 0.09754519909620285,
     0.4157346487045288, -0.4157348573207855, -0.09754510223865509,
     0.4903926253318787, -0.2777853906154633],
    [0.1913416981697083, -0.4619397222995758, 0.4619397521018982,
     -0.1913419365882874, -0.1913414746522903, 0.4619396328926086,
     -0.4619398415088654, 0.1913419365882874],
    [0.09754510968923569, -0.2777849733829498, 0.4157346487045288,
     -0.4903925657272339, 0.4903926849365234, -0.4157347679138184,
     0.2777855396270752, -0.09754576534032822],
], dtype=np.float32)  # DCT.cpp:221-230, not the correctly rounded cosines

LUM_Q50 = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)

CHROMA_Q50 = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
] + [[99] * 8] * 4, dtype=np.float32)

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

_BIG = 1 << 20
_PAST_INT16 = 1 << 16


def qtable(plane: int, quality: int) -> np.ndarray:
    """The quality-scaled float32 [8, 8] table of plane 0 (Y) or 1, 2
    (U, V): mul = (100 - q) / 50 from q 50.5 up, else 50 / q; entries
    rounded half away and clamped to [1, 255] (DCT.cpp:286-290)."""
    base = LUM_Q50 if plane == 0 else CHROMA_Q50
    q = np.float32(quality)
    mul = ((np.float32(100) - q) / np.float32(50) if q >= np.float32(50.5)
           else np.float32(50) / q)
    return np.clip(np.floor(base * mul + np.float32(0.5)), np.float32(1),
                   np.float32(255)).astype(np.float32)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    r = torch.trunc(x)
    return r + torch.where((x - r).abs() >= 0.5, torch.sign(x),
                           torch.zeros_like(x))


def _seq_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] @ [..., 8, 8], each multiply and add rounded, k
    ascending, the first product not added to 0."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, 8):
        acc = acc + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return acc


def _quantize(coef: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int16 round_half_away(RN(coef / q)): the quotient only seeds a
    candidate n0; the two half-integer boundaries around it are decided
    with products that are exact in float32."""
    a = coef.abs()
    sign = torch.where(coef < 0, -1, 1).to(I32)
    n0 = torch.trunc(a / q + 0.5)

    def at_or_past_tie(b: torch.Tensor) -> torch.Tensor:
        bits = b.view(I32)
        exp = (bits >> 23) & 0xFF
        pow2 = (bits & 0x7FFFFF) == 0
        half_ulp = ((exp - 24 - pow2.to(I32)) << 23).view(F32)
        c1 = a - b * q
        p2 = half_ulp * q
        return (c1 > -p2) | (((bits & 1) == 0) & (c1 == -p2))

    n = (n0.to(I32) - 1 + at_or_past_tie(n0 - 0.5).to(I32)
         + at_or_past_tie(n0 + 0.5).to(I32))
    return (sign * n).to(torch.int16)


def plane_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H/8 * W/8, 8, 8] raster-ordered blocks."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // 8, 8, w // 8, 8).transpose(-3, -2)
    return x.reshape(*lead, (h // 8) * (w // 8), 8, 8)


def blocks_plane(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., N, 8, 8] -> [..., H, W]."""
    *lead, _, _, _ = blocks.shape
    x = blocks.reshape(*lead, h // 8, w // 8, 8, 8).transpose(-3, -2)
    return x.reshape(*lead, h, w)


def tables(quality: Sequence[int], device) -> torch.Tensor:
    """[3, 8, 8] float32 tables of (Y, U, V) at ``quality`` on ``device``."""
    return torch.from_numpy(np.stack([qtable(i, int(quality[i]))
                                      for i in range(3)])).to(device)


def forward(blocks: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[N, 8, 8] uint8 pixels -> [N, 8, 8] int16 quantised coefficients."""
    c = torch.as_tensor(DCT_MATRIX8, device=blocks.device)
    x = blocks.to(F32) - 128.0
    return _quantize(_seq_product(_seq_product(c, x), c.t()), q)


def inverse(coeffs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[N, 8, 8] int16 coefficients -> [N, 8, 8] uint8 pixels."""
    c = torch.as_tensor(DCT_MATRIX8, device=coeffs.device)
    x = coeffs.to(F32) * q
    pix = _seq_product(_seq_product(c.t(), x), c)
    return (round_half_away(pix).to(I32) + 128).clamp(0, 255).to(torch.uint8)


def frame_coefficients(planes: Sequence[torch.Tensor],
                       quality: Sequence[int], rows: int = 1 << 16
                       ) -> List[torch.Tensor]:
    """Per plane [..., n, 8, 8] int16 coefficients of (y, u, v) uint8
    planes [..., H, W] (+ 2x [..., H/2, W/2]), in blocks of ``rows`` block
    rows so that the temporaries stay small."""
    qt = tables(quality, planes[0].device)
    out = []
    for i, p in enumerate(planes):
        blocks = plane_blocks(p)
        flat = blocks.reshape(-1, 8, 8)
        parts = [forward(flat[s:s + rows], qt[i])
                 for s in range(0, flat.shape[0], rows)]
        out.append(torch.cat(parts).view(blocks.shape))
    return out


def reconstruct(coeffs: Sequence[torch.Tensor], quality: Sequence[int],
                shapes: Sequence[Tuple[int, int]], rows: int = 1 << 16
                ) -> List[torch.Tensor]:
    """Per plane coefficients [..., n, 8, 8] -> uint8 planes [..., H, W]."""
    qt = tables(quality, coeffs[0].device)
    out = []
    for i, (c, (h, w)) in enumerate(zip(coeffs, shapes)):
        flat = c.reshape(-1, 8, 8)
        pix = torch.cat([inverse(flat[s:s + rows], qt[i])
                         for s in range(0, flat.shape[0], rows)])
        out.append(blocks_plane(pix.view(c.shape), h, w))
    return out


# ---------------------------------------------------------------------------
# Canonical Huffman chunks
# ---------------------------------------------------------------------------

def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=1, dtype=I32) - x


def _bitrev8(v: torch.Tensor) -> torch.Tensor:
    v = ((v & 0xF0) >> 4) | ((v & 0x0F) << 4)
    v = ((v & 0xCC) >> 2) | ((v & 0x33) << 2)
    return ((v & 0xAA) >> 1) | ((v & 0x55) << 1)


def _code_lengths(leafw: torch.Tensor, n_sym: torch.Tensor) -> torch.Tensor:
    """Code lengths [N, 64] of leaves sorted by weight (the first n_sym of
    each row real): the two-queue merge, a leaf winning a tie, then depths
    by a sweep over node ids (leaves 0..63, internal node k at 64 + k)."""
    n, dev = leafw.shape[0], leafw.device
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
            leaf = (lh < n_sym) & ((ih >= it) | (lw <= iw))
            picks.append(torch.where(leaf, lh, 64 + ih))
            wsum = wsum + torch.where(leaf, lw, iw)
            lh = lh + (leaf & active).to(I32)
            ih = ih + (~leaf & active).to(I32)
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
    length = depth.gather(1, parent[:, :64].long()) + 1
    return torch.where(n_sym[:, None] == 1, 1, length)


def encode_chunks(coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, 64] int16 row-major coefficients -> (lanes u8 [N, 256], sizes
    i32 [N]): lane b holds chunk b's bytes, zero past ``sizes[b]``. A
    chunk over 255 bytes (no int16 block makes one) raises ValueError."""
    dev = coeffs.device
    n = coeffs.shape[0]
    pos64 = torch.arange(64, device=dev, dtype=I32)[None, :]
    m = coeffs.to(I32)[:, torch.as_tensor(ZIGZAG, device=dev)]
    mlen = torch.where(m != 0, pos64 + 1, 0).amax(dim=1).clamp(min=1)
    valid = pos64 < mlen[:, None]

    sv, sidx = torch.sort(torch.where(valid, m, _PAST_INT16), dim=1,
                          stable=True)
    prev = torch.cat([torch.full((n, 1), -_PAST_INT16, dtype=I32,
                                 device=dev), sv[:, :-1]], dim=1)
    is_new = (sv != prev) & valid
    gid = torch.cumsum(is_new, dim=1, dtype=I32) - 1
    n_sym = is_new.sum(dim=1, dtype=I32)
    freq = torch.zeros((n, 65), dtype=I32, device=dev).scatter_add_(
        1, torch.where(valid, gid, 64).long(), valid.to(I32))[:, :64]
    symval = torch.zeros((n, 65), dtype=I32, device=dev).scatter_(
        1, torch.where(is_new, gid, 64).long(), sv)[:, :64]
    gorig = torch.zeros((n, 64), dtype=I32, device=dev).scatter_(
        1, sidx, torch.where(valid, gid, 0))

    in_range = pos64 < n_sym[:, None]
    leafw, order = torch.sort(torch.where(in_range, freq, _BIG), dim=1,
                              stable=True)
    glen = torch.zeros((n, 65), dtype=I32, device=dev).scatter_(
        1, torch.where(in_range, order, 64).long(),
        _code_lengths(leafw, n_sym))[:, :64]

    corder = torch.sort(torch.where(in_range, glen * 64 + pos64, _BIG),
                        dim=1).indices
    len_c = glen.gather(1, corder).clamp(1, 8)
    sym_c = symval.gather(1, corder)
    kraft = torch.where(in_range, 1 << (8 - len_c), 0)
    code_c = _excl_cumsum(kraft) >> (8 - len_c)
    gcode = torch.zeros((n, 65), dtype=I32, device=dev).scatter_(
        1, torch.where(in_range, corder, 64), code_c)[:, :64]
    enc_bits = torch.where(in_range, freq * glen, 0).sum(dim=1, dtype=I32)

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
    if bool((sizes > 255).any()):
        raise ValueError("a chunk is longer than 255 bytes")

    # each contribution owns disjoint bits: adding equals OR-ing
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
    rcode = _bitrev8(gcode.gather(1, gorig.long())) >> (8 - plen)
    pbit = (3 + tree_size)[:, None] * 8 + _excl_cumsum(
        torch.where(valid, plen, 0))
    pval = rcode << (pbit & 7)
    for k in range(2):
        add((pbit >> 3) + k, (pval >> (8 * k)) & 0xFF, valid)
    return canvas[:, :LANE].to(torch.uint8), sizes


def encode_stream(coeffs: torch.Tensor, rows: int = 1 << 15
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 8, 8] int16 coefficients -> (sizes i32 [N], content u8 [T]):
    the chunks back to back in block order, in blocks of ``rows``."""
    flat = coeffs.reshape(-1, 64)
    sizes, content = [], []
    for s in range(0, flat.shape[0], rows):
        lanes, sz = encode_chunks(flat[s:s + rows])
        col = torch.arange(LANE, device=lanes.device)
        sizes.append(sz)
        content.append(lanes[col[None, :] < sz[:, None]])
    return torch.cat(sizes), torch.cat(content)
