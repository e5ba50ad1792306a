// K2: fused canonical Huffman decode + dequantize + IDCT, reading the
// on-disk chunk stream as the file holds it, 32 blocks per warp.
//
// Replaces the TPU kernel
// myyuv_tpu/entropy/pallas_decode8.py::_fused_decode_idct_kernel8 (launched by
// _decode8_idct_fused_raw / decode_idct_words8_split_fused), whose body is
// _tree_body + _payload_body + kernels/pallas_dct8.py::_idct_words. The port
// keeps what it computes, not its layout: no packed-8 W0/Wc windows, no host
// expand_split step, no continuation tiers, no one-hot symbol scan. It
// accepts exactly what myyuv_tpu/native/entropy.cpp (decode_block :245,
// dequantize_idct_block :459) accepts and returns its error codes 1..8;
// code 6 cannot occur (block_huffman.cuh says why).
//
// What bounds it on the H100: latency of the per-block chains, not HBM. A
// 4032x3008 frame reads ~4-10 MB of chunks and writes ~18 MB of planes
// (microseconds at 3.35 TB/s); each block runs a serial chain of up to 85
// tree-group headers and up to 64 codes, each code starting where the one
// before ends, then two 8-term f32 chains per pixel.
// What the design does about it: the decode is K6's,
// block_huffman.cuh::decode_warp (coalesced staging of the warp's 32 chunks,
// one block's chain per lane, an 8-bit peek per code). The transform runs
// on groups of 8 lanes, four blocks a round (dequantize_idct_group: lane r
// computes row r of both chains, with the DCT matrix held in registers
// across the rounds), and each lane writes its row of 8 pixels as one
// 8-byte store. Nothing goes to local memory (ptxas: 0-byte stack frame).
//
// It is K6's stage followed by K4's chains, so K4(K6(s)) == K2(s); the
// exactness rules are stated in block_dct.cuh.

#include "block_dct.cuh"
#include "block_huffman.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kDecodeBlocks)
decode_idct_kernel(const uint8_t* __restrict__ content, int64_t content_len,
                   const int32_t* __restrict__ sizes,
                   const int64_t* __restrict__ offsets, int h, int w,
                   const float* __restrict__ qt, const float* __restrict__ dct,
                   uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                   uint8_t* __restrict__ v, int32_t* __restrict__ err) {
  __shared__ __align__(16) CodecParams prm;  // read as float4
  __shared__ uint8_t zz[64];
  __shared__ DecodeWarp d;
  load_zigzag(zz);
  load_params(prm, dct, qt);  // synchronises the CTA
  const int64_t n = frame_blocks(h, w);
  const int64_t b0 = int64_t(blockIdx.x) * kDecodeBlocks;
  const int e = decode_warp(d, zz, content, content_len, sizes, offsets, b0,
                            n);
  const int me = threadIdx.x, lane = me % kDecodeLanes;
  const int group = me / kDecodeLanes;
  if (b0 + me < n) err[b0 + me] = e;
  // each lane places its own block; the groups then transform four a round
  const BlockLoc loc = locate_block(min(b0 + me, n - 1), h, w);
  uint8_t* px = (loc.plane == 0 ? y : loc.plane == 1 ? u : v) + loc.offset;
  IdctRegs c;
  load_idct_regs(prm.c, lane, c);
#pragma unroll 1
  for (int r = 0; r < kDecodeBlocks / 4; ++r) {
    const int blk = 4 * r + group;
    const int plane = __shfl_sync(kWarpMask, loc.plane, blk);
    dequantize_idct_group(
        coef_row(d, blk, lane), c, prm.q + 64 * plane, d.x[group], lane,
        b0 + blk < n, __shfl_sync(kWarpMask, e, blk) != 0,
        reinterpret_cast<uint8_t*>(__shfl_sync(
            kWarpMask, reinterpret_cast<uintptr_t>(px), blk)),
        __shfl_sync(kWarpMask, loc.stride, blk));
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
    const int64_t grid = (n + myyuv::kDecodeBlocks - 1) / myyuv::kDecodeBlocks;
    myyuv::decode_idct_kernel<<<unsigned(grid), myyuv::kDecodeBlocks, 0,
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
