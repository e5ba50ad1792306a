// Per-block canonical Huffman stages, one block per calling thread: the
// encoder of K1 (dct_encode.cu) and K5 (huffman_encode.cu), and the decoder
// of K2 (decode_idct.cu) and K6 (huffman_decode.cu). The fused and the staged
// kernels call the same functions, so their bytes and error codes cannot
// drift apart.
//
// Direct ports of the scalar routines in myyuv_tpu/native/entropy.cpp
// (encode_block :134, huffman_lengths :85, decode_block :245), whose bytes
// and error codes 1..8 they reproduce exactly. Chunk layout (Huffman.cpp):
// u16 encoded_bits (LE), u8 tree_size, groups of u8 ((len-1) << 5 |
// (count-1)) + count 11-bit symbols LSB-first, then the payload, each code
// MSB-first.
#pragma once

#include "codec_common.cuh"

namespace myyuv {

constexpr int kOutWords = 72;  // a chunk is < 180 bytes for any int16 input

__device__ __forceinline__ void put_bits(uint32_t* w, int bitpos, uint32_t v,
                                         int nbits) {
  const int i = bitpos >> 5, sh = bitpos & 31;
  w[i] |= v << sh;
  if (sh + nbits > 32) w[i + 1] |= v >> (32 - sh);
}

// Optimal code lengths for n symbols of weights w (entropy.cpp:85): stable
// sort by weight, two-queue merge where a leaf wins a tie, depths by a sweep
// over node ids descending (ids 0..n-1 sorted leaves, n.. internal nodes).
__device__ inline void huffman_lengths(const uint8_t* w, int n,
                                       uint8_t* len_out) {
  if (n == 1) {
    len_out[0] = 1;
    return;
  }
  uint8_t order[64];
  for (int i = 0; i < n; ++i) {  // stable insertion sort by weight
    int j = i;
    while (j > 0 && w[order[j - 1]] > w[i]) {
      order[j] = order[j - 1];
      --j;
    }
    order[j] = uint8_t(i);
  }
  uint8_t leafw[64], intw[64], parent[128], depth[128];
  for (int i = 0; i < n; ++i) leafw[i] = w[order[i]];
  int lh = 0, ih = 0, it = 0;
  for (int m = 0; m < n - 1; ++m) {
    int picks[2], wsum = 0;
    for (int p = 0; p < 2; ++p) {
      const bool take_leaf = lh < n && (ih >= it || leafw[lh] <= intw[ih]);
      if (take_leaf) {
        wsum += leafw[lh];
        picks[p] = lh++;
      } else {
        wsum += intw[ih];
        picks[p] = n + ih++;
      }
    }
    intw[it] = uint8_t(wsum);  // total weight <= 64
    parent[picks[0]] = parent[picks[1]] = uint8_t(n + it);
    ++it;
  }
  depth[n + it - 1] = 0;
  for (int id = n + it - 2; id >= 0; --id) depth[id] = depth[parent[id]] + 1;
  for (int i = 0; i < n; ++i) len_out[order[i]] = depth[i];
}

// One block's chunk into out[0..kOutWords) (zeroed here); returns its size in
// bytes (entropy.cpp:134). Distinct symbols are the full int16 values, each
// serialized as its low 11 bits (native's & 0x7FF).
__device__ inline int encode_block(const int16_t* coef, uint32_t* out) {
  int16_t msg[64];
  int msg_len = 0;
  for (int i = 0; i < 64; ++i) {
    msg[i] = coef[kZigzag[i]];
    if (msg[i] != 0) msg_len = i + 1;
  }
  if (msg_len == 0) msg_len = 1;  // all-zero block -> one 0 symbol

  // distinct symbols ascending with their frequencies
  int16_t srt[64];
  for (int i = 0; i < msg_len; ++i) {
    const int16_t v = msg[i];
    int j = i;
    while (j > 0 && srt[j - 1] > v) {
      srt[j] = srt[j - 1];
      --j;
    }
    srt[j] = v;
  }
  int16_t syms[64];
  uint8_t freq[64];
  int n_sym = 0;
  for (int i = 0; i < msg_len; ++i) {
    if (n_sym == 0 || srt[i] != syms[n_sym - 1]) {
      syms[n_sym] = srt[i];
      freq[n_sym] = 1;
      ++n_sym;
    } else {
      ++freq[n_sym - 1];
    }
  }

  uint8_t lens[64];
  huffman_lengths(freq, n_sym, lens);

  // canonical order: stable by length (syms is already symbol-ascending)
  uint8_t corder[64];
  for (int i = 0; i < n_sym; ++i) {
    int j = i;
    while (j > 0 && lens[corder[j - 1]] > lens[i]) {
      corder[j] = corder[j - 1];
      --j;
    }
    corder[j] = uint8_t(i);
  }
  uint8_t code_val[64];
  {
    uint32_t code = 0;
    int prev_len = 0;
    for (int i = 0; i < n_sym; ++i) {
      const int s = corder[i];
      code <<= (lens[s] - prev_len);
      prev_len = lens[s];
      code_val[s] = uint8_t(code);
      ++code;
    }
  }
  int enc_bits = 0;
  for (int i = 0; i < n_sym; ++i) enc_bits += freq[i] * lens[i];

  // serialize: u16 enc_bits, u8 tree_size, tree groups, payload
  for (int i = 0; i < kOutWords; ++i) out[i] = 0;
  put_bits(out, 0, uint32_t(enc_bits) & 0xFFFFu, 16);
  int pos = 3;
  for (int i = 0; i < n_sym;) {
    const int len = lens[corder[i]];
    int run_end = i;
    while (run_end < n_sym && lens[corder[run_end]] == len) ++run_end;
    for (int start = i; start < run_end; start += 32) {
      const int cnt = min(32, run_end - start);
      put_bits(out, pos * 8, uint32_t(((len - 1) << 5) | (cnt - 1)), 8);
      ++pos;
      for (int k = 0; k < cnt; ++k)  // 11-bit two's complement, LSB first
        put_bits(out, pos * 8 + 11 * k,
                 uint32_t(int(syms[corder[start + k]]) & 0x7FF), 11);
      pos += (cnt * 11 + 7) / 8;
    }
    i = run_end;
  }
  put_bits(out, 16, uint32_t(pos - 3) & 0xFFu, 8);

  // payload: each code MSB-first in stream order
  int bit = pos * 8;
  for (int i = 0; i < msg_len; ++i) {
    int lo = 0, hi = n_sym - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (syms[mid] < msg[i]) lo = mid + 1; else hi = mid;
    }
    const int len = lens[lo];
    put_bits(out, bit, __brev(uint32_t(code_val[lo])) >> (32 - len), len);
    bit += len;
  }
  return pos + (enc_bits + 7) / 8;
}

// Block b's coefficients -> its 256-byte lane (16 aligned 16-byte stores),
// size and error flag: err 1, and a zero lane, for a chunk the u8 size field
// cannot hold.
__device__ __forceinline__ void encode_to_lane(const int16_t* coef, int64_t b,
                                               uint8_t* lanes, int32_t* sizes,
                                               int32_t* err) {
  uint32_t out[kOutWords];
  const int size = encode_block(coef, out);
  const bool bad = size > 255;
  sizes[b] = size;
  err[b] = bad ? 1 : 0;
  uint4* dst = reinterpret_cast<uint4*>(lanes + b * 4 * kLaneWords);
  for (int k = 0; k < kLaneWords / 4; ++k)
    dst[k] = bad ? make_uint4(0, 0, 0, 0)
                 : make_uint4(out[4 * k], out[4 * k + 1], out[4 * k + 2],
                              out[4 * k + 3]);
}

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
