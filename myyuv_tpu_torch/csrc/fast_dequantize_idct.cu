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
// What bounds it on the H100: as K4, the bytes (36.4 MB of coefficients
// read, 18.2 MB of planes written at 4032x3008, ~16 us at 3.35 TB/s); K4
// issues its instructions at 2.8x that bound, and the FMA chains issue 8
// instructions where K4's issue 15.
// What the design does about it: K4's own kernel,
// frame_transform.cuh::dequantize_idct_frame, instantiated with kFast =
// true (block_dct.cuh::dequantize_idct_group<true>): the DCT matrix in
// registers, the same grid, loads and stores, the next block's row in
// flight.

#include "frame_transform.cuh"

// myyuv::launch_dequantize_idct's contract (frame_transform.cuh), fast.
extern "C" int myyuv_fast_dequantize_idct(const void* coeffs, int64_t h,
                                          int64_t w, const void* qt,
                                          const void* dct, void* y, void* u,
                                          void* v, void* stream) {
  return myyuv::launch_dequantize_idct<true>(coeffs, h, w, qt, dct, y, u, v,
                                             stream);
}
