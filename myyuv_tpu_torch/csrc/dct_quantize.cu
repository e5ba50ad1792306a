// K3: DCT + quantize of a whole frame, one 8x8 block per group of 8 lanes,
// into row-major int16 coefficient rows.
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
// issue of its instructions: with -fmad=false every product and sum is one,
// and each of the 64 IEEE divisions a block is a reciprocal, three FMAs and
// a range check.
// What the design does about it: block_dct.cuh's dct_quantize_group, K1's
// transform too, so K5(K3(x)) == K1(x). A group of 8 lanes takes a block,
// lane r row r: it reads the row's 8 pixels with one 8-byte load (a warp's
// four blocks are 8 rows of 32 contiguous bytes), computes row r of both
// chains in registers, and writes its 8 coefficients with one 16-byte store
// (a warp writes 512 contiguous bytes). Nothing goes to local memory. The
// grid is the CTAs the card holds at once; each warp walks its own run of
// blocks four at a time (step_block: no division per block), with the next
// block's row loaded before the current block's chains.

#include "block_dct.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kTransformThreads)
dct_quantize_kernel(const uint8_t* __restrict__ y,
                    const uint8_t* __restrict__ u,
                    const uint8_t* __restrict__ v, int h, int w,
                    const float* __restrict__ qt,
                    const float* __restrict__ dct,
                    int16_t* __restrict__ coeffs) {
  __shared__ __align__(16) CodecParams prm;  // read as float4
  __shared__ __align__(16) float x[kTransformGroups][64];
  load_params(prm, dct, qt);  // synchronises the CTA
  const int lane = threadIdx.x % 8, group = threadIdx.x / 8;
  int64_t b, last;
  warp_run(frame_blocks(h, w), b, last);
  b += group % 4;  // a round of the warp: four blocks side by side
  BlockLoc loc = locate_block(b, h, w);
  const auto plane_row = [&](bool active) {
    return load_pixel_row(
        (loc.plane == 0 ? y : loc.plane == 1 ? u : v) + loc.offset,
        loc.stride, active, lane);
  };
  uint2 pix = plane_row(b < last);
  // b - group % 4 is the round's first block: the loop is warp-uniform
  for (; b - group % 4 < last; b += 4) {
    const int plane = loc.plane;
    const uint2 here = pix;
    step_block(loc, b, 4, h, w);
    pix = plane_row(b + 4 < last);  // the next block's row, in flight
    int16_t row[8];
    __syncwarp();  // the group's previous block is read out of x
    dct_quantize_group(here, prm.c, prm.q + 64 * plane, x[group], lane, row);
    uint32_t word[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word[k] = uint32_t(uint16_t(row[2 * k])) |
                uint32_t(uint16_t(row[2 * k + 1])) << 16;
    if (b < last)
      reinterpret_cast<uint4*>(coeffs + 64 * b)[lane] =
          make_uint4(word[0], word[1], word[2], word[3]);
  }
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
    static std::atomic<int64_t> held[myyuv::kMaxDevices];
    const unsigned grid = myyuv::resident_grid(
        reinterpret_cast<const void*>(myyuv::dct_quantize_kernel),
        myyuv::kTransformThreads, myyuv::kTransformGroups, n, held);
    myyuv::dct_quantize_kernel<<<grid, myyuv::kTransformThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<int16_t*>(coeffs));
  }
  return int(cudaGetLastError());
}
