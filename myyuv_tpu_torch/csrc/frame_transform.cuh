// The whole-frame loops of K3 (dct_quantize.cu) and K4
// (dequantize_idct.cu) over block_dct.cuh's exact group transforms: each
// .cu file wraps its loop in a kernel of its own and launches it. (The fast
// transforms F1 and F2 have their own design, fast_transform.cuh.)
//
// A group of 8 lanes takes a block, lane r row r. The grid is the CTAs the
// card holds at once (resident_grid, asked once per device); each warp walks
// its own run of blocks four at a time (warp_run, step_block: no division
// per block), with the next block's row loaded before the current block's
// chains. Nothing goes to local memory.
#pragma once

#include "block_dct.cuh"

namespace myyuv {

// K3's kernel body: y [h, w], u and v [h/2, w/2] u8 planes; qt f32 [3, 64];
// dct f32 [64]; coeffs i16 [N, 64], 16-byte aligned.
__device__ __forceinline__ void dct_quantize_frame(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
    const uint8_t* __restrict__ v, int h, int w,
    const float* __restrict__ qt, const float* __restrict__ dct,
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
    dct_quantize_group(here, prm.c, prm.q + 64 * plane, x[group], lane,
                       row);
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

// K4's kernel body: coeffs i16 [N, 64], 16-byte aligned; qt f32 [3, 64];
// dct f32 [64]; y [h, w], u and v [h/2, w/2] u8 planes.
__device__ __forceinline__ void dequantize_idct_frame(
    const int16_t* __restrict__ coeffs, int h, int w,
    const float* __restrict__ qt, const float* __restrict__ dct,
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
    dequantize_idct_group(row, c, prm.q + 64 * loc.plane, x[group], lane,
                          b < last, false, px, loc.stride);
    step_block(loc, b, 4, h, w);
  }
}

}  // namespace myyuv
