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
// What bounds it on the H100: as K3, the bytes (18.2 MB of planes read,
// 36.4 MB of coefficients written at 4032x3008, ~16 us at 3.35 TB/s); K3 in
// practice issues its instructions at 3.6x that bound. Each FMA takes a
// multiply and an add, so the chains issue 8 instructions where K3's
// issue 15; the 64 divisions a block are the same.
// What the design does about it: K3's own kernel,
// frame_transform.cuh::dct_quantize_frame, instantiated with kFast = true
// (block_dct.cuh::dct_quantize_group<true>): same grid, same loads and
// stores, the next block's row in flight. -fmad=false stays on the build:
// the explicit intrinsic is an FMA whatever the flag says.

#include "frame_transform.cuh"

// myyuv::launch_dct_quantize's contract (frame_transform.cuh), fast.
extern "C" int myyuv_fast_dct_quantize(const void* y, const void* u,
                                       const void* v, int64_t h, int64_t w,
                                       const void* qt, const void* dct,
                                       void* coeffs, void* stream) {
  return myyuv::launch_dct_quantize<true>(y, u, v, h, w, qt, dct, coeffs,
                                          stream);
}
