// Canonical Huffman stages of the codec kernels. The encoder half is the
// stage of K1 (dct_encode.cu) and K5 (huffman_encode.cu), a group of 8 lanes
// per 8x8 block; the decoder half is the stage of K2 (decode_idct.cu) and K6
// (huffman_decode.cu), and its tree stage alone that of T5
// (huffman_tree.cu), 32 blocks per warp, staged by the warp and its groups
// of 8 lanes, each block's serial chain on one lane. The fused and the
// staged kernels call the same functions, so their bytes and error codes
// cannot drift apart.
//
// Both reproduce the scalar routines of myyuv_tpu/native/entropy.cpp
// (encode_block :134, huffman_lengths :85, decode_block :245) exactly: its
// bytes and its error codes 1..8. Chunk layout (Huffman.cpp): u16
// encoded_bits (LE), u8 tree_size, groups of u8 ((len-1) << 5 |
// (count-1)) + count 11-bit symbols LSB-first, then the payload, each code
// MSB-first.
#pragma once

#include "codec_common.cuh"

namespace myyuv {

// ---- encoder: one block per group of 8 lanes --------------------------
//
// The stages follow the plain version (entropy/device.py::encode_lanes),
// native's algorithm in data-parallel form. Lane `lane` of a group owns
// message positions and symbol indices k * 8 + lane (k < 8) in registers
// indexed only by constants, and code length lane + 1 in stage 4; whatever
// is indexed by data lives in the group's EncodeScratch in shared memory.
// All lanes of a warp run the same phases and meet at __syncwarp(); every
// shuffle, ballot and reduction is called by the whole warp, in loops whose
// bounds are warp-uniform.
// 1. message: msg_len from ballots of the nonzero positions (all-zero: 1);
// 2. symbols: round by round, a position looks its value up among the
//    distinct values seen so far; __match_any_sync groups the round's equal
//    values, whose lowest lane appends a new one and counts them; the
//    distinct values' ascending order is then a rank;
// 3. lengths: the stable weight order as a rank, then native's two-queue
//    merge (a leaf wins a tie) and depth sweep on one lane of the group;
// 4. canonical codes: a mask of the symbols of each length; a symbol's
//    index within its length is a popcount, its code the length's first
//    code (an exclusive scan of the Kraft terms) plus that index;
// 5. serialization: tree groups at per-length byte offsets, payload bit
//    offsets from a scan of the code lengths in message order; every field
//    owns disjoint bits, so atomicOr into the group's words is exact;
// 6. store: the group writes the 256-byte lane as 16-byte stores.

// Eight lanes a block keep four merges of a warp side by side; sixteen
// were slower (PERF.md).
constexpr int kEncodeLanes = 8;
// K1's and K5's CTA: 32 groups. Their __launch_bounds__ ask for six CTAs
// an SM (at most 42 registers), which their shared memory also allows.
constexpr int kEncodeThreads = 256;
constexpr int kEncodeGroups = kEncodeThreads / kEncodeLanes;  // blocks a CTA
constexpr int kEncodeMinCtas = 6;
constexpr unsigned kWarpMask = 0xffffffffu;

// One group's working set in shared memory (1,104 bytes). K1's pixels
// share storage with the Huffman arrays, which are written only after the
// message exists.
struct alignas(16) EncodeScratch {
  uint32_t words[kLaneWords];        // the chunk, OR-ed together
  unsigned long long len_mask[8];    // bit s: symbol s has code length L + 1
  int16_t msg[64];                   // the zigzag message
  union {
    float pixels[64];                // K1: pixels - 128, row-major
    struct {
      int16_t sym[64];               // distinct symbols ascending
      uint8_t freq[64];              // their frequencies
      uint8_t len[64];               // their code lengths
      uint8_t code[64];              // their canonical codes
      uint8_t tree_off[8];           // tree-section offset of length L + 1
      uint8_t first[8];              // first code of length L + 1
      union {
        struct {                     // distinct values, order of appearance
          int16_t val[64];
          uint8_t cnt[64];           // their frequencies
          uint8_t rank[64];          // their index in sym
        } seen;
        struct {                     // the Huffman tree
          uint8_t leafw[64];         // frequencies in stable weight order
          uint8_t intw[64];          // weight of internal node n + m
          uint8_t depth[64];         // depth of internal node n + m
          uint8_t parent[128];       // parent id of leaf i / node n + m
        } tree;
      };
    } huff;
  };
};

// izz[p]: the message position of row-major coefficient p. Every thread of
// the CTA calls this; the caller synchronises the CTA after it.
__device__ __forceinline__ void load_inverse_zigzag(uint8_t* izz) {
  for (int i = threadIdx.x; i < 64; i += blockDim.x) izz[kZigzag[i]] = i;
}

// The group's bits of a warp ballot, lane order.
__device__ __forceinline__ unsigned group_ballot(bool pred) {
  const unsigned all = __ballot_sync(kWarpMask, pred);
  return (all >> ((threadIdx.x & 31) & ~7u)) & 0xFFu;
}

// Inclusive sum over the group's lanes 0..lane.
__device__ __forceinline__ int group_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const int u = __shfl_up_sync(kWarpMask, v, o, 8);
    if (lane >= o) v += u;
  }
  return v;
}

// OR the nbits-bit field v in at stream bit bitpos; a field that crosses a
// 32-bit word takes two ORs.
__device__ __forceinline__ void or_bits(uint32_t* w, int bitpos, uint32_t v,
                                        int nbits) {
  const int i = bitpos >> 5, sh = bitpos & 31;
  atomicOr(&w[i], v << sh);
  if (sh + nbits > 32) atomicOr(&w[i + 1], v >> (32 - sh));
}

// Native's two-queue merge over the n leaves in stable weight order (a leaf
// wins a tie), then the depths of the internal nodes by a sweep over node
// ids descending. Node ids: leaves 0..n-1 by weight rank, internal node m
// at n + m (the root is n + n - 2). One lane runs it.
__device__ __forceinline__ void huffman_tree(EncodeScratch& s, int n) {
  auto& t = s.huff.tree;
  int lh = 0, ih = 0;
  for (int m = 0; m < n - 1; ++m) {
    int wsum = 0;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if (lh < n && (ih >= m || t.leafw[lh] <= t.intw[ih])) {
        wsum += t.leafw[lh];
        t.parent[lh++] = n + m;
      } else {
        wsum += t.intw[ih];
        t.parent[n + ih++] = n + m;
      }
    }
    t.intw[m] = wsum;  // total weight <= 64
  }
  t.depth[n - 2] = 0;
  for (int m = n - 3; m >= 0; --m) t.depth[m] = t.depth[t.parent[n + m] - n] + 1;
}

// The group's message (s.msg, written and synchronised by the caller) ->
// block b's lane, size and error flag: err 1, and a zero lane, for a chunk
// the u8 size field cannot hold (no int16 input makes one). Every lane of
// the warp calls this; a group with active false (past the last block)
// codes its message and stores nothing.
__device__ __forceinline__ void encode_group_to_lane(
    EncodeScratch& s, int lane, bool active, int64_t b, uint8_t* lanes,
    int32_t* sizes, int32_t* err) {
  static_assert(kEncodeLanes == 8, "the stages assume 8 lanes a block");
  for (int i = lane; i < kLaneWords / 4; i += 8)
    reinterpret_cast<uint4*>(s.words)[i] = make_uint4(0, 0, 0, 0);
  s.len_mask[lane] = 0;
  for (int i = lane; i < 64 / 4; i += 8)
    reinterpret_cast<uint32_t*>(s.huff.seen.cnt)[i] = 0;
  __syncwarp();

  // 1. message, trailing zeros trimmed
  int v[8];
  unsigned long long nz = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = s.msg[k * 8 + lane];
    nz |= (unsigned long long)group_ballot(v[k] != 0) << (k * 8);
  }
  const int msg_len = nz ? 64 - __clzll(nz) : 1;
  const int warp_rounds = (__reduce_max_sync(kWarpMask, msg_len) + 7) / 8;

  // 2. distinct values in order of first appearance, their counts and
  //    each own position's entry among them
  const unsigned me = threadIdx.x & 31, gw = me / 8;  // lane, group in warp
  int entry[8];
  int n_sym = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    entry[k] = 0;
    if (k >= warp_rounds) break;
    const bool valid = k * 8 + lane < msg_len;
    int e = -1;
    if (valid)
      for (int t = 0; t < n_sym && e < 0; ++t)
        if (s.huff.seen.val[t] == v[k]) e = t;
    // the round's equal values in the group; the lowest lane leads
    const unsigned peers = __match_any_sync(
        kWarpMask, valid ? (gw << 16) | (v[k] & 0xFFFF) : (1u << 31) | me);
    const int leader = __ffs(peers) - 1;
    const bool lead = valid && leader == int(me);
    const unsigned fresh = group_ballot(lead && e < 0);
    if (lead && e < 0) {
      e = n_sym + __popc(fresh & ((1u << lane) - 1));
      s.huff.seen.val[e] = v[k];
    }
    e = __shfl_sync(kWarpMask, e, leader);
    if (lead) s.huff.seen.cnt[e] += __popc(peers);
    entry[k] = e;
    n_sym += __popc(fresh);
    __syncwarp();
  }
  // distinct symbols ascending, and each own position's symbol index
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = k * 8 + lane;
    if (e >= n_sym) break;
    const int val = s.huff.seen.val[e];
    int r = 0;
    for (int t = 0; t < n_sym; ++t) r += s.huff.seen.val[t] < val;
    s.huff.sym[r] = val;
    s.huff.freq[r] = s.huff.seen.cnt[e];
    s.huff.seen.rank[e] = r;
  }
  __syncwarp();
  int sidx[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    sidx[k] = k * 8 + lane < msg_len ? s.huff.seen.rank[entry[k]] : 0;
  __syncwarp();  // the tree reuses `seen`

  // 3. code lengths: leaf index = stable rank by weight
  int wr[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    wr[k] = 0;
    const int sk = k * 8 + lane;
    if (sk >= n_sym) continue;
    const int key = s.huff.freq[sk] * 64 + sk;
    for (int t = 0; t < n_sym; ++t) wr[k] += s.huff.freq[t] * 64 + t < key;
    s.huff.tree.leafw[wr[k]] = s.huff.freq[sk];
  }
  __syncwarp();
  if (lane == 0 && n_sym > 1) huffman_tree(s, n_sym);
  __syncwarp();
  int len[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    len[k] = 0;
    const int sk = k * 8 + lane;
    if (sk >= n_sym) continue;
    len[k] = n_sym == 1 ? 1
                        : s.huff.tree.depth[s.huff.tree.parent[wr[k]] - n_sym] + 1;
    s.huff.len[sk] = len[k];
    atomicOr(&s.len_mask[len[k] - 1], 1ull << sk);
  }
  __syncwarp();

  // 4. per length L = lane + 1: tree-section offset and first code
  const int cnt = __popcll(s.len_mask[lane]);
  const int bytes = (cnt >> 5) * 45 + (cnt & 31 ? 1 + (11 * (cnt & 31) + 7) / 8 : 0);
  const int kraft = cnt << (7 - lane);
  const int bytes_end = group_scan(bytes, lane);
  const int kraft_end = group_scan(kraft, lane);
  s.huff.tree_off[lane] = bytes_end - bytes;
  s.huff.first[lane] = (kraft_end - kraft) >> (7 - lane);
  const int tree_size = __shfl_sync(kWarpMask, bytes_end, 7, 8);
  __syncwarp();

  // 5. tree groups (runs of one length, 32 symbols at most) and codes
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int sk = k * 8 + lane;
    if (sk >= n_sym) continue;
    const int l1 = len[k] - 1;
    const unsigned long long same = s.len_mask[l1];
    const int idx = __popcll(same & ((1ull << sk) - 1));
    s.huff.code[sk] = s.huff.first[l1] + idx;
    const int at = 3 + s.huff.tree_off[l1] + 45 * (idx >> 5);
    if ((idx & 31) == 0)
      or_bits(s.words, 8 * at,
              (l1 << 5) | (min(32, __popcll(same) - idx) - 1), 8);
    or_bits(s.words, 8 * (at + 1) + 11 * (idx & 31),
            uint32_t(s.huff.sym[sk]) & 0x7FFu, 11);
  }
  __syncwarp();
  // payload: each code MSB-first at its position's bit offset
  const int pbit = 8 * (3 + tree_size);
  int enc_bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= warp_rounds) break;
    const bool valid = k * 8 + lane < msg_len;
    const int plen = valid ? s.huff.len[sidx[k]] : 0;
    const int end = group_scan(plen, lane);
    if (valid)
      or_bits(s.words, pbit + enc_bits + end - plen,
              __brev(uint32_t(s.huff.code[sidx[k]])) >> (32 - plen), plen);
    enc_bits += __shfl_sync(kWarpMask, end, 7, 8);
  }
  if (lane == 0)
    atomicOr(&s.words[0], uint32_t(enc_bits) | (uint32_t(tree_size) << 16));
  __syncwarp();

  // 6. store
  const int size = 3 + tree_size + (enc_bits + 7) / 8;
  const bool bad = size > 255;
  if (!active) return;
  uint4* dst = reinterpret_cast<uint4*>(lanes + b * 4 * kLaneWords);
  const uint4* src = reinterpret_cast<const uint4*>(s.words);
  for (int i = lane; i < kLaneWords / 4; i += 8)
    dst[i] = bad ? make_uint4(0, 0, 0, 0) : src[i];
  if (lane == 0) {
    sizes[b] = size;
    err[b] = bad ? 1 : 0;
  }
}

// K5's staging: each lane of the group reads its row of coefficient block
// `row` (row-major, 16-byte aligned) as one 16-byte load and scatters it
// into the message in zigzag order; a group with active false stages zeros.
__device__ __forceinline__ void stage_coeff_row(const int16_t* row,
                                                bool active, int lane,
                                                const uint8_t* izz,
                                                int16_t* msg) {
  const uint4 r = active ? reinterpret_cast<const uint4*>(row)[lane]
                         : make_uint4(0, 0, 0, 0);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 8; ++q)
    msg[izz[8 * lane + q]] = int16_t(w[q >> 1] >> (16 * (q & 1)));
  __syncwarp();
}

// ---- decoder: 32 blocks per warp ------------------------------------
//
// The decoder computes what myyuv_tpu/entropy/pallas_decode8.py's
// _payload_body (:203-316) computes: no bit-at-a-time walk, but an 8-bit
// peek per code. With per-length counts c_L, canonical first codes fc_L
// (fc_1 = 0, fc_{L+1} = (fc_L + c_L) << 1) and the eight limits
// K_L = (fc_L + c_L) << (8 - L) = sum_{j <= L} c_j << (8 - j), the first L
// bits of the peek p are a code of length L iff p < K_L. K_L never
// decreases, so the lengths that miss are 1..m and the code's length is
// m + 1 (9: no code of <= 8 bits); its index among the codes of that length
// is (p - K_m) >> (8 - len), because K_m is a multiple of 2^(9 - len).
// Native's walk would stop at the same length: it tests the same
// inequalities, one bit at a time. Its code 6 (a hit at length L with
// c_L = 0) cannot happen: code_L < fc_L means code_{L-1} < fc_{L-1} +
// c_{L-1}, a hit one length earlier, where the walk already stopped.
// Error codes are native's: with r = enc_bits - bit payload bits left, the
// walk reads min(len, 8) bits, so min(len, 8) > r is code 5, else len = 9 is
// code 7. Bits past enc_bits enter the peek but never decide: if no length
// <= r hits, the code is 5 whatever follows.
//
// A CTA is one warp and decodes 32 blocks, whose working set (DecodeWarp)
// is in shared memory. The parallel stages run on the whole warp or on
// groups of kDecodeLanes = 8 lanes, one block at a time: staging (coalesced
// word loads, issued together) and, in the kernels, the stores or the
// transform. The stages that are a serial chain within a block (the
// tree-group headers, whose positions depend on the counts before them,
// and the codes, each starting where the one before ends) run one block per
// lane, so the warp follows 32 chains side by side. The staging buffer and
// the symbol tables are sized for what a stream typically needs, not for
// 32 worst-case chunks, so that more warps fit an SM: blocks whose chunks
// or tables do not fit wait for a later pass of the same warp. The
// coefficients are stored with their words XOR-swizzled, so lanes in step
// touch distinct banks. Whatever is indexed by data lives in shared memory;
// registers are indexed by constants only.

constexpr int kDecodeLanes = 8;
// K2's, K6's and T5's CTA: one warp, one block per lane.
constexpr int kDecodeBlocks = 32;
// A chunk staged on its own takes 72 words: at most 65 hold its <= 255
// bytes (3 more when it starts off a word boundary).
constexpr int kStageWords = 72;
// The staging buffer: 16 chunks staged on their own, or any run of back to
// back chunks up to 4,608 bytes (a 4032x3008 noise frame at q50 averages
// 48 bytes a chunk).
constexpr int kBufWords = 16 * kStageWords;
// A tree section that passes native's size check holds at most 181 symbols:
// it is <= 255 bytes, and a group of c symbols takes 1 + ceil(11 c / 8)
// bytes, so five groups of 32 (225 bytes) and one of 21 (30 bytes) are the
// most. The warp's tables share a pool of 2,048 (64 a block on average).
constexpr int kMaxTreeSymbols = 181;
constexpr int kSymbolPool = 2048;
static_assert(kSymbolPool >= kMaxTreeSymbols, "one tree fits the pool");

// One warp's working set in shared memory (13,840 bytes).
struct alignas(16) DecodeWarp {
  // staged chunks; the reads of a field or window may run a word past them
  uint32_t buf[kBufWords + 4];
  uint32_t coef[32 * kDecodeBlocks];    // coefficient pairs, coef_word()
  int32_t tab[8 * kDecodeBlocks];       // m: K_m | (first row of m + 1) << 16
  union {
    int16_t sym[kSymbolPool];           // canonical symbol tables
    float x[kDecodeBlocks / kDecodeLanes][64];  // K2: one block a group
  };
};

// The word of block b's coefficients 2w and 2w + 1 (row-major).
__device__ __forceinline__ int coef_word(int b, int w) {
  return w * kDecodeBlocks + (b ^ w);
}

// Coefficients 8 * slice .. 8 * slice + 7 of block b as one uint4.
__device__ __forceinline__ uint4 coef_row(const DecodeWarp& d, int b,
                                          int slice) {
  const int w = 4 * slice;
  return make_uint4(d.coef[coef_word(b, w)], d.coef[coef_word(b, w + 1)],
                    d.coef[coef_word(b, w + 2)], d.coef[coef_word(b, w + 3)]);
}

// zz[i]: the row-major position of message symbol i. Every thread of the CTA
// calls this; the caller synchronises the CTA after it.
__device__ __forceinline__ void load_zigzag(uint8_t* zz) {
  for (int i = threadIdx.x; i < 64; i += blockDim.x) zz[i] = kZigzag[i];
}

__device__ __forceinline__ int staged_byte(const uint32_t* w, int j) {
  return int(w[j >> 2] >> (8 * (j & 3))) & 0xFF;
}

// The 32 staged bits from bit q on.
__device__ __forceinline__ uint32_t staged_bits(const uint32_t* w, int q) {
  return __funnelshift_r(w[q >> 5], w[(q >> 5) + 1], q & 31);
}

// The chunk's byte offset in the first staged word.
__device__ __forceinline__ int chunk_shift(const uint8_t* content,
                                           int64_t off) {
  return int((off + int64_t(reinterpret_cast<uintptr_t>(content) & 3)) & 3);
}

// Stage bytes [off, off + nbytes) of content[0, content_len) into
// words[0, limit) as the aligned 32-bit words that hold them: word m is
// read by lane `first` of `step` lanes (m = first, first + step, ...), kPer
// loads a lane issued together; bytes outside the range or outside content
// are zeroed. Only words that straddle content's ends take byte loads.
template <int kPer>
__device__ __forceinline__ void stage_range(uint32_t* words, int first,
                                            int step, int limit,
                                            const uint8_t* content,
                                            int64_t content_len, int64_t off,
                                            int nbytes) {
  const int shift = chunk_shift(content, off);
  const int64_t q_first = off - shift;  // content position of word 0
  const int nwords = (shift + nbytes + 3) >> 2;
  // words [m_lo, m_hi) lie wholly inside content
  const int m_lo = int(min(max(3 - q_first, int64_t(0)) >> 2, int64_t(limit)));
  const int m_hi = int(min(max(content_len - q_first, int64_t(0)) >> 2,
                           int64_t(nwords)));
  for (int m0 = first; m0 < limit; m0 += kPer * step) {
    uint32_t v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int m = m0 + k * step;
      v[k] = m >= m_lo && m < m_hi ? *reinterpret_cast<const uint32_t*>(
                                         content + q_first + 4 * m)
                                   : 0u;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int m = m0 + k * step;
      if (m >= limit) break;
      if (m < nwords && (m < m_lo || m >= m_hi)) {  // across content's ends
        for (int t = 0; t < 4; ++t) {
          const int64_t q = q_first + 4 * m + t;
          if (q >= 0 && q < content_len)
            v[k] |= uint32_t(content[q]) << (8 * t);
        }
      }
      const int j0 = 4 * m - shift;  // range byte of the word's byte 0
      const int lo = min(max(-j0, 0), 4), hi = min(max(nbytes - j0, 0), 4);
      const uint32_t keep =
          hi > lo ? uint32_t((1ull << (8 * hi)) - (1ull << (8 * lo))) : 0u;
      words[m] = v[k] & keep;
    }
  }
}

// Staged word i, bit-reversed, with the bits from bit `end` on zeroed (the
// chunk ends there): bit 31 is stream bit 32 i.
__device__ __forceinline__ uint32_t chunk_word_rev(const uint32_t* w, int i,
                                                   int end) {
  const int keep = min(max(end - 32 * i, 0), 32);
  return __brev(w[i] & uint32_t((1ull << keep) - 1u));
}

// Lane: parse the tree section of the chunk of `size` bytes staged from
// byte `base` of buf. Returns 0 or native decode_block's error code 1..4;
// cnt8 gets the count of length L in byte L - 1.
__device__ __forceinline__ int parse_tree(const uint32_t* w, int base,
                                          int size,
                                          unsigned long long& cnt8) {
  cnt8 = 0;
  if (size < 3) return 1;
  const int enc_bits = staged_byte(w, base) | (staged_byte(w, base + 1) << 8);
  const int tree_size = staged_byte(w, base + 2);
  if (3 + tree_size + (enc_bits + 7) / 8 > size) return 2;
  int pos = 3;
  while (pos - 3 < tree_size) {
    const int info = staged_byte(w, base + pos);
    const int sh = 8 * (info >> 5), cnt = (info & 31) + 1;
    // native stops at this group's symbol number 65 of the length
    if (int(cnt8 >> sh & 0xFF) + cnt > 64) return 3;
    cnt8 += (unsigned long long)cnt << sh;
    pos += 1 + (cnt * 11 + 7) / 8;
  }
  return pos - 3 != tree_size ? 4 : 0;
}

// Lane `me`: decode the valid tree section and the payload of the chunk
// staged from byte `base` of buf into block me's coefficients (zeroed
// before; a bad block's values are partial, the caller stores zeros for
// it), with its symbol table at sym[pool]. Returns 0 or native
// decode_block's error code 5, 7 or 8.
__device__ __forceinline__ int decode_payload(DecodeWarp& d,
                                              const uint8_t* zz, int me,
                                              int base, int size,
                                              unsigned long long cnt8,
                                              int pool) {
  const uint32_t* w = d.buf;
  const int enc_bits = staged_byte(w, base) | (staged_byte(w, base + 1) << 8);
  const int tree_size = staged_byte(w, base + 2);
  // limits K_L of lengths L = i + 1 and the table's first row per length;
  // a valid tree has <= 181 symbols, so the bytes of run never carry
  int lim[8];
  unsigned long long run = 0;
  {
    int k_acc = 0, c_acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = int(cnt8 >> (8 * i) & 0xFF);
      d.tab[i * kDecodeBlocks + me] = k_acc | ((pool + c_acc) << 16);
      run |= (unsigned long long)c_acc << (8 * i);
      c_acc += c;
      k_acc += c << (7 - i);
      lim[i] = k_acc;
    }
  }
  int pos = 3;
  while (pos - 3 < tree_size) {  // the symbols, in canonical order
    const int info = staged_byte(w, base + pos);
    const int sh = 8 * (info >> 5), cnt = (info & 31) + 1;
    int16_t* row = d.sym + pool + int(run >> sh & 0xFF);
    const int q0 = 8 * (base + pos + 1);
    for (int k = 0; k < cnt; ++k) {
      const int v = int(staged_bits(w, q0 + 11 * k) & 0x7FFu);
      row[k] = int16_t(v >= 1024 ? v - 2048 : v);
    }
    run += (unsigned long long)cnt << sh;
    pos += 1 + (cnt * 11 + 7) / 8;
  }

  // the stream, MSB-first, in a window of three reversed words; the symbol
  // of each code is stored one code later, so its table reads overlap the
  // next code's compares
  const int end = 8 * (base + min(size, 4 * kLaneWords));
  const int p0 = 8 * (base + pos);
  int wi = p0 >> 5, at = p0 & 31;
  uint32_t w0 = chunk_word_rev(w, wi, end);
  uint32_t w1 = chunk_word_rev(w, wi + 1, end);
  uint32_t w2 = chunk_word_rev(w, min(wi + 2, kBufWords - 1), end);
  int16_t* coef = reinterpret_cast<int16_t*>(d.coef);
  int bit = 0, out_i = 0, held = -1;
  int16_t held_val = 0;
  while (bit < enc_bits && out_i < 64) {
    const int peek = int(__funnelshift_l(w1, w0, at) >> 24);
    // m = the number of lengths that miss, by a binary search of lim
    const int b2 = peek >= lim[3];
    const int b1 = peek >= (b2 ? lim[5] : lim[1]);
    const int b0 =
        peek >= (b2 ? (b1 ? lim[6] : lim[4]) : (b1 ? lim[2] : lim[0]));
    const int m = 4 * b2 + 2 * b1 + b0 + (peek >= lim[7]);
    const int len = m + 1;
    if (min(len, 8) > enc_bits - bit) return 5;
    if (len == 9) return 7;
    const int t = d.tab[m * kDecodeBlocks + me];
    bit += len;
    at += len;
    if (at >= 32) {  // one code crosses at most one word boundary
      at -= 32;
      w0 = w1;
      w1 = w2;
      ++wi;
      w2 = chunk_word_rev(w, min(wi + 2, kBufWords - 1), end);
    }
    if (held >= 0) coef[held] = held_val;
    const int p = zz[out_i++];
    held = 2 * coef_word(me, p >> 1) + (p & 1);
    held_val = d.sym[(t >> 16) + ((peek - (t & 0xFFFF)) >> (7 - m))];
  }
  if (held >= 0) coef[held] = held_val;
  return bit != enc_bits ? 8 : 0;
}

// Inclusive sum over the warp's lanes 0..me.
__device__ __forceinline__ int warp_scan(int v, int me) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kWarpMask, v, o);
    if (me >= o) v += u;
  }
  return v;
}

// Zero the warp's rows of d.coef, then stage the chunks of blocks b0 .. b0 +
// 31 (those < n) into d.buf, pass by pass: a pass stages as many chunks as
// the buffer holds (one pass for a typical stream), then every lane of the
// warp calls body(staged, base, size): staged is true on the lanes whose
// chunk this pass staged, from byte `base` of d.buf, and size is the lane's
// chunk size. Passes repeat until every block's chunk has been staged.
// Every lane of the warp calls this.
template <class Body>
__device__ __forceinline__ void stage_passes(DecodeWarp& d,
                                             const uint8_t* content,
                                             int64_t content_len,
                                             const int32_t* sizes,
                                             const int64_t* offsets,
                                             int64_t b0, int64_t n,
                                             Body&& body) {
  const int me = threadIdx.x & 31;
  const bool mine = b0 + me < n;
  const int size = mine ? sizes[b0 + me] : 0;
  const int64_t off = mine ? offsets[b0 + me] : 0;
  for (int i = me; i < 32 * kDecodeBlocks / 4; i += kDecodeBlocks)
    reinterpret_cast<uint4*>(d.coef)[i] = make_uint4(0, 0, 0, 0);

  // a valid stream holds the warp's chunks back to back: stage runs of them
  // as one range; otherwise each chunk on its own, a group of 8 lanes a chunk
  const int last = __popc(__ballot_sync(kWarpMask, mine)) - 1;
  const int64_t next = __shfl_down_sync(kWarpMask, off, 1);
  const bool linked =
      size >= 0 && size <= 255 && (me >= last || next == off + size);
  const bool in_order = __all_sync(kWarpMask, linked);
  bool pending = mine;
  while (__any_sync(kWarpMask, pending)) {
    const int first = __ffs(__ballot_sync(kWarpMask, pending)) - 1;
    const int64_t off_first = __shfl_sync(kWarpMask, off, first);
    bool staged;
    int base;
    if (in_order) {
      const int shift = chunk_shift(content, off_first);
      staged = pending && shift + (off + size - off_first) <= 4 * kBufWords;
      const int top = 31 - __clz(__ballot_sync(kWarpMask, staged));
      const int nbytes =
          int(__shfl_sync(kWarpMask, off + size, top) - off_first);
      stage_range<8>(d.buf, me, kDecodeBlocks, (shift + nbytes + 3) >> 2,
                     content, content_len, off_first, nbytes);
      base = shift + int(off - off_first);
    } else {
      staged = pending && me < first + kBufWords / kStageWords;
      const int lane = me % kDecodeLanes, group = me / kDecodeLanes;
#pragma unroll 1
      for (int r = 0; r < kBufWords / kStageWords / 4; ++r) {
        const int slot = 4 * r + group, blk = first + slot;
        const int64_t blk_off = __shfl_sync(kWarpMask, off, blk & 31);
        const int blk_size = __shfl_sync(kWarpMask, size, blk & 31);
        stage_range<kStageWords / kDecodeLanes>(
            d.buf + slot * kStageWords, lane, kDecodeLanes, kStageWords,
            content, content_len, blk_off,
            blk < 32 ? max(0, min(blk_size, 4 * kLaneWords)) : 0);
      }
      base = 4 * kStageWords * (me - first) + chunk_shift(content, off);
    }
    __syncwarp();
    body(staged, base, size);
    pending = pending && !staged;
  }
}

// Decode blocks b0 .. b0 + 31 (those < n) of the stream into d. Lane l
// decodes block b0 + l; passes of the warp stage as many chunks as the
// buffer holds and table as many trees as the pool holds, and repeat until
// every block is done (one pass for a typical stream). Returns lane l's
// block's code (0 or native's 1..8; code 1 past n). Every lane of the warp
// calls this.
__device__ __forceinline__ int decode_warp(DecodeWarp& d, const uint8_t* zz,
                                           const uint8_t* content,
                                           int64_t content_len,
                                           const int32_t* sizes,
                                           const int64_t* offsets, int64_t b0,
                                           int64_t n) {
  static_assert(kDecodeLanes == 8 && kDecodeBlocks == 32,
                "a warp of 4 groups of 8 lanes");
  const int me = threadIdx.x & 31;
  int e = 1;
  stage_passes(d, content, content_len, sizes, offsets, b0, n,
               [&](bool staged, int base, int size) {
    unsigned long long cnt8 = 0;
    if (staged) e = parse_tree(d.buf, base, size, cnt8);
    bool waiting = staged && e == 0;
    int nsym = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) nsym += int(cnt8 >> (8 * i) & 0xFF);
    while (__any_sync(kWarpMask, waiting)) {  // trees that fit the pool
      const int upto = warp_scan(waiting ? nsym : 0, me);
      const bool go = waiting && upto <= kSymbolPool;
      if (go)
        e = decode_payload(d, zz, me, base, size, cnt8, upto - nsym);
      waiting = waiting && !go;
      __syncwarp();
    }
  });
  return e;
}

// Lane me: the symbols of the valid tree section of the chunk staged from
// byte `base` of d.buf, with counts cnt8 (parse_tree's), into block me's
// row of d.coef (zeroed by stage_passes): the first 64 in canonical order
// (by code length, then as stored within a length, decode_payload's table
// order), sign-extended from 11 bits.
__device__ __forceinline__ void tree_symbols(DecodeWarp& d, int me, int base,
                                             unsigned long long cnt8) {
  const uint32_t* w = d.buf;
  const int tree_size = staged_byte(w, base + 2);
  // the symbols before each length, a byte a length (<= 181: no carry)
  unsigned long long run = 0;
  int c_acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    run |= (unsigned long long)c_acc << (8 * i);
    c_acc += int(cnt8 >> (8 * i) & 0xFF);
  }
  int16_t* row = reinterpret_cast<int16_t*>(d.coef);
  int pos = 3;
  while (pos - 3 < tree_size) {
    const int info = staged_byte(w, base + pos);
    const int sh = 8 * (info >> 5), cnt = (info & 31) + 1;
    const int at = int(run >> sh & 0xFF);
    const int q0 = 8 * (base + pos + 1);
    for (int k = 0; k < cnt && at + k < 64; ++k) {
      const int v = int(staged_bits(w, q0 + 11 * k) & 0x7FFu);
      const int s = at + k;
      row[2 * coef_word(me, s >> 1) + (s & 1)] =
          int16_t(v >= 1024 ? v - 2048 : v);
    }
    run += (unsigned long long)cnt << sh;
    pos += 1 + (cnt * 11 + 7) / 8;
  }
}

// The tree stage alone for blocks b0 .. b0 + 31 (those < n): lane l parses
// block b0 + l's tree section into its row of d.coef (tree_symbols) and
// cnt8 (the count of length L in byte L - 1). Returns 0 or native
// decode_block's code 1..4 (1 past n); a bad block's cnt8 is 0 and its
// row partial (the caller stores zeros for it). Every lane of the warp
// calls this.
__device__ __forceinline__ int tree_warp(DecodeWarp& d,
                                         const uint8_t* content,
                                         int64_t content_len,
                                         const int32_t* sizes,
                                         const int64_t* offsets, int64_t b0,
                                         int64_t n,
                                         unsigned long long& cnt8) {
  const int me = threadIdx.x & 31;
  int e = 1;
  cnt8 = 0;
  stage_passes(d, content, content_len, sizes, offsets, b0, n,
               [&](bool staged, int base, int size) {
    if (staged) {
      e = parse_tree(d.buf, base, size, cnt8);
      if (e == 0)
        tree_symbols(d, me, base, cnt8);
      else
        cnt8 = 0;
    }
    __syncwarp();  // a next pass stages over d.buf
  });
  return e;
}

}  // namespace myyuv
