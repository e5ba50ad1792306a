// K4: dequantize + IDCT of a whole frame, one thread per 8x8 block, from
// row-major int16 coefficient rows straight into the [H, W] planes.
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
// 3.35 TB/s), in practice the per-thread chain of 2 x 512 dependent f32
// operations on local arrays.
// What the design does about it: 284k independent threads per 4K frame hide
// the chains' latency; each row is read as 8 aligned 16-byte loads; the DCT
// matrix and tables sit in shared memory; pixels go straight into the plane
// layout, so nothing follows the kernel. The stage is block_dct.cuh's
// dequantize_idct_block, whose chains K2's dequantize_idct_group computes
// too, so K4(K6(s)) equals K2(s).

#include "block_dct.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kThreads)
dequantize_idct_kernel(const int16_t* __restrict__ coeffs, int h, int w,
                       const float* __restrict__ qt,
                       const float* __restrict__ dct,
                       uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                       uint8_t* __restrict__ v) {
  __shared__ CodecParams prm;
  load_params(prm, dct, qt);
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= frame_blocks(h, w)) return;
  const BlockLoc loc = locate_block(b, h, w);
  uint8_t* px = (loc.plane == 0 ? y : loc.plane == 1 ? u : v) + loc.offset;
  __align__(16) int16_t coef[64];
  load_coeffs(coeffs + b * 64, coef);
  dequantize_idct_block(coef, prm.c, prm.q + 64 * loc.plane, px, loc.stride);
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
    const int64_t grid = (n + myyuv::kThreads - 1) / myyuv::kThreads;
    myyuv::dequantize_idct_kernel<<<unsigned(grid), myyuv::kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coeffs), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v));
  }
  return int(cudaGetLastError());
}
