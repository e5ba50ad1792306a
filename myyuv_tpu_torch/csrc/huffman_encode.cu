// K5: canonical Huffman encode of N coefficient rows, one row per group of
// kEncodeLanes = 8 lanes, into block-major 256-byte chunk lanes.
//
// Replaces the TPU kernel myyuv_tpu/entropy/pallas_encode8.py::_encode_kernel8
// (launched by encode_words_packed; entry points encode_words8 and
// encode_lanes8), and through its entry points entropy/pallas_encode.py::
// _encode_kernel (K9, encode_words_pairs / encode_words / encode_lanes). The
// port keeps what they compute, not their layout: no coefficient pairs, no
// bit-reversed A/C word regions, no continuation tiers, no one-hot register
// machine. Output is K1's contract (lanes, sizes, err).
//
// What bounds it on the H100: latency of the per-block work, not HBM.
// Memory traffic by count is 36.4 MB of coefficients in and ~2.5 MB of
// chunk bytes (in 72.8 MB of lanes) plus 2.3 MB of sizes and flags out for
// a 4032x3008 frame, ~33 us at 3.35 TB/s for the lanes; the work is two
// sorting networks as deep as the warp's widest block needs (21 steps at
// 64 keys), a merge of <= 63 sequential steps and bit packing, all of which
// depend on the content.
// What the design does about it: the group reads its row as eight 16-byte
// loads, stages the zigzag message in shared memory and runs
// block_huffman.cuh's lane-group encoder, which K1 runs too: the networks
// in registers and shuffles, code tables and bit packing spread over the
// lanes, only the merge on one lane,
// nothing in local memory (ptxas: 0-byte stack frame), and the lane leaves
// as 16-byte stores. Distinct symbols are the full int16 values, each
// serialized as its low 11 bits, as native does; no int16 input makes a
// chunk longer than 255 bytes.

#include "block_huffman.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kEncodeThreads, kEncodeMinCtas)
huffman_encode_kernel(const int16_t* __restrict__ coeffs, int64_t n,
                      uint8_t* __restrict__ lanes,
                      int32_t* __restrict__ sizes,
                      int32_t* __restrict__ err) {
  __shared__ uint8_t izz[64];
  __shared__ EncodeScratch scratch[kEncodeGroups];
  load_inverse_zigzag(izz);
  __syncthreads();
  const int lane = threadIdx.x % kEncodeLanes;
  EncodeScratch& s = scratch[threadIdx.x / kEncodeLanes];
  const int64_t b =
      int64_t(blockIdx.x) * kEncodeGroups + threadIdx.x / kEncodeLanes;
  const bool active = b < n;
  stage_coeff_row(coeffs + b * 64, active, lane, izz, s.msg);
  encode_group_to_lane(s, lane, active, b, lanes, sizes, err);
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
    const int64_t grid = (n + myyuv::kEncodeGroups - 1) / myyuv::kEncodeGroups;
    myyuv::huffman_encode_kernel<<<unsigned(grid), myyuv::kEncodeThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coeffs), n, static_cast<uint8_t*>(lanes),
        static_cast<int32_t*>(sizes), static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}
