// F2: the inverse transform of precision="fast" over a whole frame:
// dequantize + IDCT with FMA-contracted float32 chains, one 8x8 block per
// group of 8 lanes, from row-major int16 coefficient rows straight into the
// [H, W] planes (K4's layout and contract).
//
// Replaces no Pallas kernel: the JAX package's fast path is an XLA product,
// myyuv_tpu/kernels/device.py::dequantize_idct(precision="fast")
// (:188-209): coefficients times the table, _mxu_transform(C^T, x, C) at
// Precision.HIGHEST, then clip(round_half_away(x) + 128, 0, 255). It runs
// after the entropy decoder (K6 in the port) wherever the JAX engine takes
// precision (engine/device_stream.py::_inv_transform :175, the batch API).
//
// What it computes: one exact product a coefficient, then (C^T . X) . C,
// each chain a __fmul_rn then seven __fmaf_rn, k ascending, in float32 on
// the CUDA cores (no tensor core, no TF32); then clamp(roundf(x) + 128, 0,
// 255). Against the exact K4 a pixel may differ by 1 where x lies within a
// few ulps of a rounding tie.
//
// What bounds it on the H100: the bytes by count (36.4 MB of coefficients
// read, 18.2 MB of planes written at 4032x3008, 0.0163 ms at 3.35 TB/s);
// in practice the issue of its instructions (inputs in device memory time
// as warm ones): per lane and block 128 FMAs, 8 conversions and
// dequantizing products, 8 roundings and clamps, and the transposition of
// the block through shared memory.
// What the design does about it: fast_transform.cuh (its header says how):
// a transposition with 16-byte shared stores and no bank conflicts, all of
// C, C's column and the q row in registers across blocks (two CTAs an
// SM), two rounds of coefficient rows in flight, row pointers stepped a
// round at a time, and an instance for aligned planes with one 8-byte
// store a row.

#include "fast_transform.cuh"

namespace myyuv {
namespace fast {
namespace {

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinCtas)
fast_dequantize_idct_kernel(const int16_t* __restrict__ coeffs, int h, int w,
                            const float* __restrict__ qt,
                            const float* __restrict__ dct,
                            uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                            uint8_t* __restrict__ v) {
  inverse_frame<kAligned>(coeffs, h, w, qt, dct, y, u, v);
}

}  // namespace
}  // namespace fast
}  // namespace myyuv

// coeffs i16 [N, 64] (16-byte aligned), N = frame_blocks(h, w), blocks Y,
// then U, then V raster; qt f32 [3, 64]; dct f32 [64]; outputs y [h, w], u
// and v [h/2, w/2] u8 planes (any byte alignment). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int myyuv_fast_dequantize_idct(const void* coeffs, int64_t h,
                                          int64_t w, const void* qt,
                                          const void* dct, void* y, void* u,
                                          void* v, void* stream) {
  namespace f = myyuv::fast;
  const int64_t n = myyuv::frame_blocks(h, w);
  if (n > 0) {
    // a plane's rows are 8-byte aligned where the plane is (w is a
    // multiple of 16): one instance for those, one with byte accesses
    const bool aligned = ((reinterpret_cast<uintptr_t>(y) |
                           reinterpret_cast<uintptr_t>(u) |
                           reinterpret_cast<uintptr_t>(v)) & 7) == 0;
    const auto kernel = aligned ? f::fast_dequantize_idct_kernel<true>
                                : f::fast_dequantize_idct_kernel<false>;
    static std::atomic<int64_t> held[2][myyuv::kMaxDevices];
    const unsigned grid = myyuv::resident_grid(
        reinterpret_cast<const void*>(kernel), f::kThreads, f::kGroups, n,
        held[aligned]);
    kernel<<<grid, f::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coeffs), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v));
  }
  return int(cudaGetLastError());
}
