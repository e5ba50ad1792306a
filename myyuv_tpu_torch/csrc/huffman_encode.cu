// K5: canonical Huffman encode of N coefficient rows, one thread per block,
// into block-major 256-byte chunk lanes.
//
// Replaces the TPU kernel myyuv_tpu/entropy/pallas_encode8.py::_encode_kernel8
// (launched by encode_words_packed; entry points encode_words8 and
// encode_lanes8), and through its entry points entropy/pallas_encode.py::
// _encode_kernel (K9, encode_words_pairs / encode_words / encode_lanes). The
// port keeps what they compute, not their layout: no coefficient pairs, no
// bit-reversed A/C word regions, no continuation tiers, no one-hot register
// machine. Output is K1's contract (lanes, sizes, err).
//
// What bounds it on the H100: per-thread latency. Each thread runs native's
// sequential machine (three insertion sorts of <= 64 entries, a two-queue
// merge, bit packing) on ~1 KB of local arrays; memory traffic by count is
// 36.4 MB of coefficients in and 72.8 MB of lanes (+ 2.3 MB of sizes and
// flags) out for a 4032x3008 frame, ~33 us at 3.35 TB/s.
// What the design does about it: 284k independent threads per 4K frame keep
// the warp schedulers fed; each row is read as 8 aligned 16-byte loads and
// each lane written as 16 aligned 16-byte stores. The stage is
// block_huffman.cuh's encode_to_lane, which K1 runs too.
// Distinct symbols are the full int16 values, each serialized as its low 11
// bits, as native does; no int16 input makes a chunk longer than 255 bytes.

#include "block_huffman.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kThreads)
huffman_encode_kernel(const int16_t* __restrict__ coeffs, int64_t n,
                      uint8_t* __restrict__ lanes,
                      int32_t* __restrict__ sizes,
                      int32_t* __restrict__ err) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= n) return;
  __align__(16) int16_t coef[64];
  load_coeffs(coeffs + b * 64, coef);
  encode_to_lane(coef, b, lanes, sizes, err);
}

}  // namespace
}  // namespace myyuv

// coeffs i16 [n, 64] row-major (16-byte aligned); outputs lanes u8 [n, 256]
// (16-byte aligned), sizes i32 [n], err i32 [n]. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int myyuv_huffman_encode(const void* coeffs, int64_t n,
                                    void* lanes, void* sizes, void* err,
                                    void* stream) {
  if (n > 0) {
    const int64_t grid = (n + myyuv::kThreads - 1) / myyuv::kThreads;
    myyuv::huffman_encode_kernel<<<unsigned(grid), myyuv::kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coeffs), n, static_cast<uint8_t*>(lanes),
        static_cast<int32_t*>(sizes), static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}
