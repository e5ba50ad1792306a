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
// dequantize_idct_frame. A group of 8 lanes takes a block, lane r row r:
// it reads the row's coefficients with one 16-byte load (a warp reads 512
// contiguous bytes), computes row r of both chains in registers, and
// writes its 8 pixels with one 8-byte store; the DCT
// matrix stays in registers (IdctRegs, as in K2). Nothing goes to local
// memory. The grid is the CTAs the card holds at once; each warp
// walks its own run of blocks four at a time (step_block: no division per
// block), with the next block's row loaded before the current block's
// chains.

#include "frame_transform.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kTransformThreads)
dequantize_idct_kernel(const int16_t* __restrict__ coeffs, int h, int w,
                       const float* __restrict__ qt,
                       const float* __restrict__ dct,
                       uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                       uint8_t* __restrict__ v) {
  dequantize_idct_frame(coeffs, h, w, qt, dct, y, u, v);
}

}  // namespace
}  // namespace myyuv

// coeffs i16 [N, 64] (16-byte aligned), N = frame_blocks(h, w), blocks Y,
// then U, then V raster; qt f32 [3, 64]; dct f32 [64]; outputs y [h, w], u
// and v [h/2, w/2] u8 planes. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int myyuv_dequantize_idct(const void* coeffs, int64_t h,
                                     int64_t w, const void* qt,
                                     const void* dct, void* y, void* u,
                                     void* v, void* stream) {
  const int64_t n = myyuv::frame_blocks(h, w);
  if (n > 0) {
    static std::atomic<int64_t> held[myyuv::kMaxDevices];
    const unsigned grid = myyuv::resident_grid(
        reinterpret_cast<const void*>(myyuv::dequantize_idct_kernel),
        myyuv::kTransformThreads, myyuv::kTransformGroups, n, held);
    myyuv::dequantize_idct_kernel<<<grid, myyuv::kTransformThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coeffs), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v));
  }
  return int(cudaGetLastError());
}
