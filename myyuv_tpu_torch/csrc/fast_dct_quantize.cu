// F1: the forward transform of precision="fast" over a whole frame: DCT +
// quantize with FMA-contracted float32 chains, one 8x8 block per group of 8
// lanes, into row-major int16 coefficient rows (K3's layout and contract).
//
// Replaces no Pallas kernel: the JAX package's fast path is an XLA product,
// myyuv_tpu/kernels/device.py::dct_quantize(precision="fast") (:158-186):
// _mxu_transform's two einsums at Precision.HIGHEST, centred pixels in, then
// round_half_away(coef / qtable). It runs wherever the JAX engine takes
// precision (engine/device_stream.py::_fwd_transform :158 and the batch
// API), ahead of the entropy kernel (K5 in the port).
//
// What it computes: coef = (C . (B - 128)) . C^T, each of the 2 x 64 chains
// a block __fmul_rn of the first product then seven __fmaf_rn, k ascending,
// in float32 on the CUDA cores (no tensor core: Hopper's float32 products
// there are TF32, 10 mantissa bits, not HIGHEST); then roundf(__fdiv_rn(
// coef, q)), IEEE division as XLA's float32 divide. Against the exact K3 a
// coefficient may differ by 1 where coef / q lies within a few ulps of a
// rounding tie (PERF.md has the measured shares).
//
// What bounds it on the H100: the bytes by count (18.2 MB of planes read,
// 36.4 MB of coefficients written at 4032x3008, 0.0163 ms at 3.35 TB/s);
// in practice the issue of its instructions (inputs in device memory time
// as warm ones): per lane and block 128 FMAs, 8 IEEE divisions (a
// reciprocal, five FMAs, a range check and its branch each), 8 roundings
// and conversions, and the transposition of the block through shared
// memory (PERF.md §6: the divisions are ~13 % of its time).
// What the design does about it: fast_transform.cuh (its header says how):
// a transposition with 16-byte shared stores and no bank conflicts, all of
// C and the q row in registers across blocks (two CTAs an SM), two rounds
// of rows in flight, row pointers stepped a round at a time, and an
// instance for aligned planes with one 8-byte load a row.

#include "fast_transform.cuh"

namespace myyuv {
namespace fast {
namespace {

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinCtas)
fast_dct_quantize_kernel(const uint8_t* __restrict__ y,
                         const uint8_t* __restrict__ u,
                         const uint8_t* __restrict__ v, int h, int w,
                         const float* __restrict__ qt,
                         const float* __restrict__ dct,
                         int16_t* __restrict__ coeffs) {
  forward_frame<kAligned>(y, u, v, h, w, qt, dct, coeffs);
}

}  // namespace
}  // namespace fast
}  // namespace myyuv

// y [h, w], u and v [h/2, w/2] u8 planes (any byte alignment); qt f32
// [3, 64] (Y, U, V tables); dct f32 [64]; output coeffs i16 [N, 64]
// (16-byte aligned), N = frame_blocks(h, w), blocks Y, then U, then V
// raster. Launches on `stream` and returns cudaGetLastError().
extern "C" int myyuv_fast_dct_quantize(const void* y, const void* u,
                                       const void* v, int64_t h, int64_t w,
                                       const void* qt, const void* dct,
                                       void* coeffs, void* stream) {
  namespace f = myyuv::fast;
  const int64_t n = myyuv::frame_blocks(h, w);
  if (n > 0) {
    // a plane's rows are 8-byte aligned where the plane is (w is a
    // multiple of 16): one instance for those, one with byte accesses
    const bool aligned = ((reinterpret_cast<uintptr_t>(y) |
                           reinterpret_cast<uintptr_t>(u) |
                           reinterpret_cast<uintptr_t>(v)) & 7) == 0;
    const auto kernel = aligned ? f::fast_dct_quantize_kernel<true>
                                : f::fast_dct_quantize_kernel<false>;
    static std::atomic<int64_t> held[2][myyuv::kMaxDevices];
    const unsigned grid = myyuv::resident_grid(
        reinterpret_cast<const void*>(kernel), f::kThreads, f::kGroups, n,
        held[aligned]);
    kernel<<<grid, f::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<int16_t*>(coeffs));
  }
  return int(cudaGetLastError());
}
