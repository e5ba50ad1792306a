// K2: fused canonical Huffman decode + dequantize + IDCT, one thread per 8x8
// block, reading the on-disk chunk stream as the file holds it.
//
// Replaces the TPU kernel
// myyuv_tpu/entropy/pallas_decode8.py::_fused_decode_idct_kernel8 (launched by
// _decode8_idct_fused_raw / decode_idct_words8_split_fused), whose body is
// _tree_body + _payload_body + kernels/pallas_dct8.py::_idct_words. The port
// keeps what it computes, not its layout: no packed-8 W0/Wc windows, no host
// expand_split step, no continuation tiers. The per-block code is a direct
// port of myyuv_tpu/native/entropy.cpp (decode_block :245,
// dequantize_idct_block :459), so it accepts exactly what the host decoder
// accepts and returns its error codes 1..8.
//
// What bounds it on the H100: per-thread latency. Each thread copies its
// chunk (3..255 bytes at a device-computed offset) into a local 256-byte
// lane, parses the tree into a [9][64] symbol table (~1.2 KB of local
// memory), walks the canonical code one bit at a time, then runs two 8-term
// f32 chains per pixel. Dependent instructions and local-memory traffic
// dominate; HBM traffic is small (a 4032x3008 frame reads ~4-10 MB of chunks
// and writes ~18 MB of planes).
// What the design does about it: 284k independent threads per 4K frame keep
// the schedulers fed while others wait; chunk bytes are read once from HBM;
// tables are shared memory; planes are written straight into [H, W] layout,
// so nothing follows the kernel. Shortening the per-thread machine (a table
// decode instead of the bit walk, warp-cooperative parsing) is later work.
//
// Exactness: dequantize is one exact f32 product; both IDCT chains are
// __fmul_rn/__fadd_rn, k ascending, the first product not added to 0 (and
// -fmad=false); pixels are clamp(roundf(x) + 128, 0, 255), half away from
// zero as std::round in DCT.cpp:358.

#include "codec_common.cuh"

namespace myyuv {
namespace {

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
// Returns 0 or entropy.cpp decode_block's error code.
__device__ int decode_block(const uint32_t* cw, int size, int16_t* coef) {
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

__global__ void __launch_bounds__(kThreads)
decode_idct_kernel(const uint8_t* __restrict__ content, int64_t content_len,
                   const int32_t* __restrict__ sizes,
                   const int64_t* __restrict__ offsets, int h, int w,
                   const float* __restrict__ qt, const float* __restrict__ dct,
                   uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                   uint8_t* __restrict__ v, int32_t* __restrict__ err) {
  __shared__ CodecParams prm;
  load_params(prm, dct, qt);
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= frame_blocks(h, w)) return;
  const BlockLoc loc = locate_block(b, h, w);
  uint8_t* px = (loc.plane == 0 ? y : loc.plane == 1 ? u : v) + loc.offset;
  const float* q = prm.q + 64 * loc.plane;

  // the chunk into a zero-padded local lane; bytes outside content read as
  // 0, so inconsistent offsets cannot reach past the buffer
  const int size = sizes[b];
  const int64_t off = offsets[b];
  uint32_t cw[kLaneWords];
  for (int i = 0; i < kLaneWords; ++i) cw[i] = 0;
  for (int j = 0; j < min(size, 4 * kLaneWords); ++j) {
    const int64_t at = off + j;
    if (at >= 0 && at < content_len)
      cw[j >> 2] |= uint32_t(content[at]) << (8 * (j & 3));
  }

  int16_t coef[64];
  const int e = decode_block(cw, size, coef);
  err[b] = e;
  if (e != 0) {  // a bad block's pixels are 0
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) px[int64_t(i) * loc.stride + j] = 0;
    return;
  }

  float x[64];
  for (int i = 0; i < 64; ++i) x[i] = __fmul_rn(float(coef[i]), q[i]);
  float t[64];  // C^T . X
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(prm.c[i], x[j]);
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(prm.c[k * 8 + i], x[k * 8 + j]));
      t[i * 8 + j] = acc;
    }
  for (int i = 0; i < 8; ++i)  // (C^T . X) . C
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(t[i * 8], prm.c[j]);
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(t[i * 8 + k], prm.c[k * 8 + j]));
      const int r = int(roundf(acc)) + 128;
      px[int64_t(i) * loc.stride + j] = uint8_t(r < 0 ? 0 : (r > 255 ? 255 : r));
    }
}

}  // namespace
}  // namespace myyuv

// content u8 [content_len] (the file's chunk bytes back to back), sizes i32
// [N] in 0..255, offsets i64 [N] (exclusive prefix sum of sizes); qt f32
// [3, 64]; dct f32 [64]; outputs y [h, w], u and v [h/2, w/2] u8 planes and
// err i32 [N]. Launches on `stream` and returns cudaGetLastError().
extern "C" int myyuv_decode_idct(const void* content, int64_t content_len,
                                 const void* sizes, const void* offsets,
                                 int64_t h, int64_t w,
                                 const void* qt, const void* dct, void* y,
                                 void* u, void* v, void* err, void* stream) {
  const int64_t n = myyuv::frame_blocks(h, w);
  if (n > 0) {
    const int64_t grid = (n + myyuv::kThreads - 1) / myyuv::kThreads;
    myyuv::decode_idct_kernel<<<unsigned(grid), myyuv::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(content), content_len,
        static_cast<const int32_t*>(sizes),
        static_cast<const int64_t*>(offsets), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v), static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}
