// K4: dequantize + IDCT of a whole frame, one 8x8 block per group of 8
// lanes, from row-major int16 coefficient rows straight into the [H, W]
// planes.
//
// Replaces the TPU kernels myyuv_tpu/kernels/pallas_dct8.py::
// _dequantize_idct_kernel8p (launched by dequantize_idct_words), and through
// its entry points _dequantize_idct_kernel8 (K7, dequantize_idct_packed) and
// kernels/pallas_dct.py::_dequantize_idct_kernel (K8,
// dequantize_idct_rows). The port keeps what they compute, not their
// layout: no message-order coefficient pairs, no pixel quad words.
//
// What bounds it on the H100: memory traffic by count (a 4032x3008 frame
// reads 36.4 MB of coefficients and writes 18.2 MB of planes, ~16 us at
// 3.35 TB/s), in practice the issue of its instructions: with -fmad=false
// every product and sum of the chains is one.
// What the design does about it: block_dct.cuh's dequantize_idct_group,
// K2's transform too, so K4(K6(s)) == K2(s), in frame_transform.cuh's
// dequantize_idct_frame (whose fast instance is F2,
// fast_dequantize_idct.cu). A group of 8 lanes takes a block, lane r row r:
// it reads the row's coefficients with one 16-byte load (a warp reads 512
// contiguous bytes), computes row r of both chains in registers, and
// writes its 8 pixels with one 8-byte store; the DCT
// matrix stays in registers (IdctRegs, as in K2). Nothing goes to local
// memory. The grid is the CTAs the card holds at once; each warp
// walks its own run of blocks four at a time (step_block: no division per
// block), with the next block's row loaded before the current block's
// chains.

#include "frame_transform.cuh"

// myyuv::launch_dequantize_idct's contract (frame_transform.cuh), exact.
extern "C" int myyuv_dequantize_idct(const void* coeffs, int64_t h,
                                     int64_t w, const void* qt,
                                     const void* dct, void* y, void* u,
                                     void* v, void* stream) {
  return myyuv::launch_dequantize_idct<false>(coeffs, h, w, qt, dct, y, u,
                                              v, stream);
}
