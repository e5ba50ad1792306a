// K6: canonical Huffman decode of N chunks of the on-disk stream, one thread
// per block, into row-major int16 coefficient rows and per-block codes.
//
// Replaces the TPU kernels myyuv_tpu/entropy/pallas_decode8.py::_tree_kernel8
// + _payload_kernel8 (launched by _decode8_raw; entry points decode_words8,
// decode_words8_packed(_split) and decode_lanes8), and through its entry
// points entropy/pallas_decode.py::_tree_kernel + _payload_kernel (K10,
// decode_lanes / decode_words). With K4 after it, it is also the port's
// two-kernel decompress K2' (pallas_decode8.py::_tree_kernel8 +
// _payload_idct_kernel8). The port keeps what they compute, not their
// layout: one kernel instead of two, the tree tables in the thread's local
// memory instead of HBM, no packed-8 windows, no continuation tiers.
//
// What bounds it on the H100: per-thread latency. Each thread copies its
// chunk (3..255 bytes at a device-computed offset) into a local lane, parses
// the tree into a [9][64] symbol table (~1.2 KB of local memory) and walks
// the canonical code one bit at a time; memory traffic by count is the
// stream plus 3.4 MB of sizes and offsets in, 36.4 MB of coefficients and
// 1.1 MB of codes out for a 4032x3008 frame, >= 12 us at 3.35 TB/s.
// What the design does about it: 284k independent threads per 4K frame keep
// the schedulers fed while others wait; chunk bytes are read once from HBM;
// each row is written as 8 aligned 16-byte stores. The stage is
// block_huffman.cuh's decode_chunk, which K2 runs too, so K6 returns K2's
// error code on every chunk. A bad block's coefficients are written as 0.

#include "block_huffman.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint8_t* __restrict__ content,
                      int64_t content_len, const int32_t* __restrict__ sizes,
                      const int64_t* __restrict__ offsets, int64_t n,
                      int16_t* __restrict__ coeffs,
                      int32_t* __restrict__ err) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n) return;
  __align__(16) int16_t coef[64];
  const int e = decode_chunk(content, content_len, sizes[b], offsets[b], coef);
  err[b] = e;
  if (e != 0)
    for (int i = 0; i < 64; ++i) coef[i] = 0;
  store_coeffs(coef, coeffs + b * 64);
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
    const int64_t grid = (n + myyuv::kThreads - 1) / myyuv::kThreads;
    myyuv::huffman_decode_kernel<<<unsigned(grid), myyuv::kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(content), content_len,
        static_cast<const int32_t*>(sizes),
        static_cast<const int64_t*>(offsets), n,
        static_cast<int16_t*>(coeffs), static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}
