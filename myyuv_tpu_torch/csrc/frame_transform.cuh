// The whole-frame transform kernels over block_dct.cuh's group transforms,
// one template for the exact and the fast instance of each: K3
// (dct_quantize.cu) and F1 (fast_dct_quantize.cu) run dct_quantize_frame,
// K4 (dequantize_idct.cu) and F2 (fast_dequantize_idct.cu)
// dequantize_idct_frame. Each .cu file is the C entry point of one
// instance; the two instances share their layout, grid and launch.
//
// A group of 8 lanes takes a block, lane r row r. The grid is the CTAs the
// card holds at once (resident_grid, asked once per device); each warp walks
// its own run of blocks four at a time (warp_run, step_block: no division
// per block), with the next block's row loaded before the current block's
// chains. Nothing goes to local memory.
#pragma once

#include "block_dct.cuh"

namespace myyuv {

template <bool kFast>
__global__ void __launch_bounds__(kTransformThreads)
dct_quantize_frame(const uint8_t* __restrict__ y,
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
    dct_quantize_group<kFast>(here, prm.c, prm.q + 64 * plane, x[group],
                              lane, row);
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

template <bool kFast>
__global__ void __launch_bounds__(kTransformThreads)
dequantize_idct_frame(const int16_t* __restrict__ coeffs, int h, int w,
                      const float* __restrict__ qt,
                      const float* __restrict__ dct,
                      uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                      uint8_t* __restrict__ v) {
  __shared__ __align__(16) CodecParams prm;  // read as float4
  __shared__ __align__(16) float x[kTransformGroups][64];
  load_params(prm, dct, qt);  // synchronises the CTA
  const int lane = threadIdx.x % 8, group = threadIdx.x / 8;
  IdctRegs c;
  load_idct_regs(prm.c, lane, c);
  int64_t b, last;
  warp_run(frame_blocks(h, w), b, last);
  b += group % 4;  // a round of the warp: four blocks side by side
  BlockLoc loc = locate_block(b, h, w);
  const auto coeff_row = [&](int64_t blk) {
    return blk < last
               ? reinterpret_cast<const uint4*>(coeffs + 64 * blk)[lane]
               : make_uint4(0, 0, 0, 0);
  };
  uint4 next = coeff_row(b);
  // b - group % 4 is the round's first block: the loop is warp-uniform
  for (; b - group % 4 < last; b += 4) {
    const uint4 row = next;
    next = coeff_row(b + 4);  // the next block's row, in flight
    uint8_t* px = (loc.plane == 0 ? y : loc.plane == 1 ? u : v) + loc.offset;
    __syncwarp();  // the group's previous block is read out of x
    dequantize_idct_group<kFast>(row, c, prm.q + 64 * loc.plane, x[group],
                                 lane, b < last, false, px, loc.stride);
    step_block(loc, b, 4, h, w);
  }
}

// y [h, w], u and v [h/2, w/2] u8 planes; qt f32 [3, 64] (Y, U, V tables);
// dct f32 [64]; output coeffs i16 [N, 64] (16-byte aligned), N =
// frame_blocks(h, w), blocks Y, then U, then V raster. Launches on `stream`
// and returns cudaGetLastError().
template <bool kFast>
int launch_dct_quantize(const void* y, const void* u, const void* v,
                        int64_t h, int64_t w, const void* qt,
                        const void* dct, void* coeffs, void* stream) {
  const int64_t n = frame_blocks(h, w);
  if (n > 0) {
    static std::atomic<int64_t> held[kMaxDevices];
    const unsigned grid = resident_grid(
        reinterpret_cast<const void*>(dct_quantize_frame<kFast>),
        kTransformThreads, kTransformGroups, n, held);
    dct_quantize_frame<kFast><<<grid, kTransformThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<int16_t*>(coeffs));
  }
  return int(cudaGetLastError());
}

// coeffs i16 [N, 64] (16-byte aligned), N = frame_blocks(h, w), blocks Y,
// then U, then V raster; qt f32 [3, 64]; dct f32 [64]; outputs y [h, w], u
// and v [h/2, w/2] u8 planes. Launches on `stream` and returns
// cudaGetLastError().
template <bool kFast>
int launch_dequantize_idct(const void* coeffs, int64_t h, int64_t w,
                           const void* qt, const void* dct, void* y,
                           void* u, void* v, void* stream) {
  const int64_t n = frame_blocks(h, w);
  if (n > 0) {
    static std::atomic<int64_t> held[kMaxDevices];
    const unsigned grid = resident_grid(
        reinterpret_cast<const void*>(dequantize_idct_frame<kFast>),
        kTransformThreads, kTransformGroups, n, held);
    dequantize_idct_frame<kFast><<<grid, kTransformThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coeffs), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v));
  }
  return int(cudaGetLastError());
}

}  // namespace myyuv
