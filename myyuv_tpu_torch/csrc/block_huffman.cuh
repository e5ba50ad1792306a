// Canonical Huffman stages of the codec kernels. The encoder half is the
// lane-group stage of K1 (dct_encode.cu) and K5 (huffman_encode.cu): a group
// of kEncodeLanes = 8 lanes codes one 8x8 block. The decoder half serves K2
// (decode_idct.cu) and K6 (huffman_decode.cu), one block per calling
// thread. The fused and the staged kernels call the same functions, so
// their bytes and error codes cannot drift apart.
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

// ---- decoder: one block per calling thread ----------------------------

__device__ __forceinline__ uint32_t lane_word(const uint32_t* cw, int i) {
  return i < kLaneWords ? cw[i] : 0u;  // bytes past the lane read as 0
}

__device__ __forceinline__ int byte_at(const uint32_t* cw, int j) {
  return int(lane_word(cw, j >> 2) >> (8 * (j & 3))) & 0xFF;
}

__device__ __forceinline__ uint32_t bits_at(const uint32_t* cw, int bitpos,
                                            int nbits) {
  const int i = bitpos >> 5;
  const uint64_t v = lane_word(cw, i) | (uint64_t(lane_word(cw, i + 1)) << 32);
  return uint32_t(v >> (bitpos & 31)) & ((1u << nbits) - 1u);
}

// Decode one chunk (bytes zero past `size`) into row-major coefficients.
// Returns 0 or entropy.cpp decode_block's error code; a bad block's
// coefficients are unspecified here (callers zero or discard them).
__device__ inline int decode_block(const uint32_t* cw, int size,
                                   int16_t* coef) {
  if (size < 3) return 1;
  const int enc_bits = byte_at(cw, 0) | (byte_at(cw, 1) << 8);
  const int tree_size = byte_at(cw, 2);
  if (3 + tree_size + (enc_bits + 7) / 8 > size) return 2;

  // tree groups -> per-length counts and symbols in stored order
  int counts[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  int16_t symtab[9][64];
  int pos = 3;
  while (pos - 3 < tree_size) {
    const int info = byte_at(cw, pos++);
    const int len = (info >> 5) + 1;
    const int cnt = (info & 31) + 1;
    for (int k = 0; k < cnt; ++k) {
      if (counts[len] >= 64) return 3;
      const int v = int(bits_at(cw, pos * 8 + 11 * k, 11));
      symtab[len][counts[len]++] = int16_t(v >= 1024 ? v - 2048 : v);
    }
    pos += (cnt * 11 + 7) / 8;
  }
  if (pos - 3 != tree_size) return 4;

  // canonical decode (puff.c-style first/count walk)
  for (int i = 0; i < 64; ++i) coef[i] = 0;
  const int pbit = pos * 8;
  int bit = 0, out_i = 0;
  while (bit < enc_bits && out_i < 64) {
    int code = 0, first = 0;
    int16_t sym = 0;
    bool found = false;
    for (int len = 1; len <= 8; ++len) {
      if (bit >= enc_bits) return 5;
      code |= int(bits_at(cw, pbit + bit, 1));
      ++bit;
      const int c = counts[len];
      if (code < first + c) {
        if (c == 0) return 6;
        sym = symtab[len][code - first];
        found = true;
        break;
      }
      first = (first + c) << 1;
      code <<= 1;
    }
    if (!found) return 7;
    coef[kZigzag[out_i++]] = sym;
  }
  if (bit != enc_bits) return 8;
  return 0;
}

// Chunk b of the stream (`size` bytes at `off` in content[0..content_len))
// -> row-major coefficients; returns decode_block's code. The chunk is copied
// into a zero-padded local lane; bytes outside content read as 0, so
// inconsistent offsets cannot reach past the buffer.
__device__ __forceinline__ int decode_chunk(const uint8_t* content,
                                            int64_t content_len, int size,
                                            int64_t off, int16_t* coef) {
  uint32_t cw[kLaneWords];
  for (int i = 0; i < kLaneWords; ++i) cw[i] = 0;
  for (int j = 0; j < min(size, 4 * kLaneWords); ++j) {
    const int64_t at = off + j;
    if (at >= 0 && at < content_len)
      cw[j >> 2] |= uint32_t(content[at]) << (8 * (j & 3));
  }
  return decode_block(cw, size, coef);
}

}  // namespace myyuv
