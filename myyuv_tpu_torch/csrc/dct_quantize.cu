// K3: DCT + quantize of a whole frame, one thread per 8x8 block, into
// row-major int16 coefficient rows.
//
// Replaces the TPU kernels myyuv_tpu/kernels/pallas_dct8.py::
// _dct_quantize_kernel8p (launched by dct_quantize_words), and through its
// entry points _dct_quantize_kernel8 (K7, dct_quantize_packed) and
// kernels/pallas_dct.py::_dct_quantize_kernel (K8, dct_quantize_rows). The
// port keeps what they compute, not their layout: no packed pixel quad words,
// no coefficient pairs in message order, no MXU relayouts. Its output is the
// JAX flat route's [n, 64] i16 interface (engine/device_stream.py:158-172);
// zigzag order stays inside the encoder (K5), as in JAX.
//
// What bounds it on the H100: memory traffic by count (a 4032x3008 frame
// reads 18.2 MB of planes and writes 36.4 MB of coefficients, ~16 us at
// 3.35 TB/s; its ~0.6 GFLOP of f32 is ~9 us at 67 TFLOP/s), in practice the
// per-thread chain of 2 x 512 dependent f32 operations on local arrays.
// What the design does about it: 284k independent threads per 4K frame hide
// the chains' latency; the DCT matrix and tables sit in shared memory; each
// row is written as 8 aligned 16-byte stores. The stage is block_dct.cuh's
// dct_quantize_block, which K1 runs too, so K5(K3(x)) equals K1(x).

#include "block_dct.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kThreads)
dct_quantize_kernel(const uint8_t* __restrict__ y,
                    const uint8_t* __restrict__ u,
                    const uint8_t* __restrict__ v, int h, int w,
                    const float* __restrict__ qt,
                    const float* __restrict__ dct,
                    int16_t* __restrict__ coeffs) {
  __shared__ CodecParams prm;
  load_params(prm, dct, qt);
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= frame_blocks(h, w)) return;
  const BlockLoc loc = locate_block(b, h, w);
  const uint8_t* px = (loc.plane == 0 ? y : loc.plane == 1 ? u : v) + loc.offset;
  __align__(16) int16_t coef[64];
  dct_quantize_block(px, loc.stride, prm.c, prm.q + 64 * loc.plane, coef);
  store_coeffs(coef, coeffs + b * 64);
}

}  // namespace
}  // namespace myyuv

// y [h, w], u and v [h/2, w/2] u8 planes; qt f32 [3, 64] (Y, U, V tables);
// dct f32 [64]; output coeffs i16 [N, 64] (16-byte aligned), N =
// frame_blocks(h, w), blocks Y, then U, then V raster. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int myyuv_dct_quantize(const void* y, const void* u, const void* v,
                                  int64_t h, int64_t w, const void* qt,
                                  const void* dct, void* coeffs,
                                  void* stream) {
  const int64_t n = myyuv::frame_blocks(h, w);
  if (n > 0) {
    const int64_t grid = (n + myyuv::kThreads - 1) / myyuv::kThreads;
    myyuv::dct_quantize_kernel<<<unsigned(grid), myyuv::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<int16_t*>(coeffs));
  }
  return int(cudaGetLastError());
}
