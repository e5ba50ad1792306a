// K6: canonical Huffman decode of N chunks of the on-disk stream into
// row-major int16 coefficient rows and per-block codes, 32 blocks per warp.
//
// Replaces the TPU kernels myyuv_tpu/entropy/pallas_decode8.py::_tree_kernel8
// + _payload_kernel8 (launched by _decode8_raw; entry points decode_words8,
// decode_words8_packed(_split) and decode_lanes8), and through its entry
// points entropy/pallas_decode.py::_tree_kernel + _payload_kernel (K10,
// decode_lanes / decode_words). With K4 after it, it is also the port's
// two-kernel decompress K2' (pallas_decode8.py::_tree_kernel8 +
// _payload_idct_kernel8). The port keeps what they compute, not their
// layout: one kernel instead of two, the tree tables in shared memory
// instead of HBM, no packed-8 windows, no continuation tiers, no one-hot
// symbol scan. It returns native decode_block's codes 1..8 (code 6 cannot
// occur; block_huffman.cuh says why) and writes a bad block's coefficients
// as 0.
//
// What bounds it on the H100: latency of the per-block chains. Memory
// traffic by count is the stream plus 3.4 MB of sizes and offsets in,
// 36.4 MB of coefficients and 1.1 MB of codes out for a 4032x3008 frame,
// >= 12 us at 3.35 TB/s; each block runs a serial chain of up to 85
// tree-group headers and up to 64 codes, each code starting where the one
// before ends.
// What the design does about it: block_huffman.cuh::decode_warp, which K2
// runs too. The warp stages its 32 chunks into shared memory with coalesced
// word loads (one range for a valid stream), then each lane follows one
// block's chain: the tree into a table in a shared pool, and each code from
// an 8-bit peek with a 3-compare search of the eight limits instead of a
// walk of up to 8 one-bit steps. Groups of 8 lanes then store four blocks'
// 128-byte rows a round, 16 bytes a lane. Nothing goes to local memory
// (ptxas: 0-byte stack frame).

#include "block_huffman.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kDecodeBlocks)
huffman_decode_kernel(const uint8_t* __restrict__ content,
                      int64_t content_len, const int32_t* __restrict__ sizes,
                      const int64_t* __restrict__ offsets, int64_t n,
                      int16_t* __restrict__ coeffs,
                      int32_t* __restrict__ err) {
  __shared__ uint8_t zz[64];
  __shared__ DecodeWarp d;
  load_zigzag(zz);
  __syncthreads();
  const int64_t b0 = int64_t(blockIdx.x) * kDecodeBlocks;
  const int e = decode_warp(d, zz, content, content_len, sizes, offsets, b0,
                            n);
  const int me = threadIdx.x, lane = me % kDecodeLanes;
  if (b0 + me < n) err[b0 + me] = e;
#pragma unroll
  for (int r = 0; r < kDecodeBlocks / 4; ++r) {  // four 128-byte rows a round
    const int blk = 4 * r + me / kDecodeLanes;
    const bool bad = __shfl_sync(kWarpMask, e, blk) != 0;
    if (b0 + blk < n)
      reinterpret_cast<uint4*>(coeffs + (b0 + blk) * 64)[lane] =
          bad ? make_uint4(0, 0, 0, 0) : coef_row(d, blk, lane);
  }
}

}  // namespace
}  // namespace myyuv

// content u8 [content_len] (the chunks back to back), sizes i32 [n] in
// 0..255, offsets i64 [n]; outputs coeffs i16 [n, 64] row-major (16-byte
// aligned) and err i32 [n] (0 or native decode_block's code 1..8). Launches
// on `stream` and returns cudaGetLastError().
extern "C" int myyuv_huffman_decode(const void* content, int64_t content_len,
                                    const void* sizes, const void* offsets,
                                    int64_t n, void* coeffs, void* err,
                                    void* stream) {
  if (n > 0) {
    const int64_t grid = (n + myyuv::kDecodeBlocks - 1) / myyuv::kDecodeBlocks;
    myyuv::huffman_decode_kernel<<<unsigned(grid), myyuv::kDecodeBlocks, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(content), content_len,
        static_cast<const int32_t*>(sizes),
        static_cast<const int64_t*>(offsets), n,
        static_cast<int16_t*>(coeffs), static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}
