// F1 and F2, the transforms of precision="fast" (fast_dct_quantize.cu,
// fast_dequantize_idct.cu): kernels of their own, not instances of K3's and
// K4's (frame_transform.cuh), with K3's and K4's layouts, grid and launch
// contract.
//
// Arithmetic (the plain versions, kernels/device.py's fast transforms,
// repeat it exactly): each chain is a __fmul_rn of its first product then
// seven __fmaf_rn, k ascending; the forward quantizes with roundf(__fdiv_rn(
// coef, q)); the inverse dequantizes with one exact product and writes
// clamp(roundf(x) + 128, 0, 255). No tensor core, no TF32.
//
// Layout: a group of 8 lanes takes an 8x8 block, lane r row r; a warp's four
// groups take four blocks side by side (a round), and each warp walks its own
// run of blocks (warp_run). A lane's first chain needs every row of its
// block: the design's one shared-memory round trip. The kernels are bound by
// the issue of their instructions (inputs in device memory time as warm
// ones; PERF.md §6), so the design spends as few as it can around the
// chains:
// - The transposition: a lane writes its row with two 16-byte stores into
//   its group's slice, the row's halves swapped where r >= 4, so that the 8
//   lanes of a group cover the 32 banks once; slices are kSliceFloats = 72
//   floats apart, so the four groups' row reads, each a broadcast within
//   its group, fall on distinct banks. Two slices a group, used in turns:
//   one __syncwarp a round.
// - Operands that are the same for every block stay in registers for the
//   whole launch: all of C (the second chain's operands, the same in every
//   lane: cheaper there than as a broadcast load per row and block), C's
//   row `lane` (F1) or column `lane` (F2), and the group's q row of its
//   block's plane, reloaded only where the group's plane changes (a round
//   of four blocks can straddle U and V). The tables are read from the
//   device tensors at every launch: no host sync, no __constant__ written.
// - Bytes in flight: each lane holds its rows of the next kDepth rounds in
//   registers while it computes the current one.
// - Addressing: the loop counts rounds in 32 bits; a lane keeps pointers to
//   its coefficient row and its pixel row, stepped 512 and 32 bytes a round
//   (RowWalk), and locates a block anew only where a walk leaves a row of
//   blocks.
// - Planes at 8-byte aligned addresses (the launcher checks the pointers)
//   take an instance with one 8-byte access a row; any other plane view the
//   byte accesses where a row is not aligned.
#pragma once

#include "block_dct.cuh"

namespace myyuv {
namespace fast {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 8;
// CTAs an SM the kernels are built for: 128 registers a thread, all of C
// among them (left alone, ptxas gives F1 159 and one CTA an SM)
constexpr int kMinCtas = 2;
constexpr int kSliceFloats = 72;
constexpr int kDepth = 2;  // rounds whose rows are in flight

struct Slices {
  float x[2][kGroups][kSliceFloats];  // [turn][group]
};

// Row r of a group's slice: two 16-byte halves, swapped where r >= 4.
__device__ __forceinline__ void store_slice_row(float* s, int r,
                                                const float (&v)[8]) {
  float4* p = reinterpret_cast<float4*>(s + 8 * r);
  const int sw = (r >> 2) & 1;
  p[sw] = make_float4(v[0], v[1], v[2], v[3]);
  p[sw ^ 1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load_slice_row(const float* s, int r,
                                               float (&v)[8]) {
  const float4* p = reinterpret_cast<const float4*>(s + 8 * r);
  const int sw = (r >> 2) & 1;
  const float4 lo = p[sw], hi = p[sw ^ 1];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// The 8 pixels of a row, 4 to a word, minus 128 (exact).
__device__ __forceinline__ void centred_pixels(uint2 pix, float (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = float(((k < 4 ? pix.x : pix.y) >> (8 * (k % 4))) & 0xFF) - 128.0f;
}

// The 8 int16 coefficients of a row, 2 to a word, as floats (exact).
__device__ __forceinline__ void coefficient_floats(uint4 row,
                                                   float (&v)[8]) {
  const uint32_t cw[4] = {row.x, row.y, row.z, row.w};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    v[k] = float(int16_t(cw[k / 2] >> (16 * (k % 2))));
}

// Row `lane` of plane p's table.
__device__ __forceinline__ void load_q(const float* q, int p, int lane,
                                       float (&qr)[8]) {
  load_row(q + 64 * p + 8 * lane, qr);
}

// All of C, c[8 * k + j] = C[k][j], from the CTA's copy.
__device__ __forceinline__ void load_matrix(const float* cs,
                                            float (&c)[64]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float r[8];
    load_row(cs + 8 * k, r);
#pragma unroll
    for (int j = 0; j < 8; ++j) c[8 * k + j] = r[j];
  }
}

// A group's walk over its warp's run, four blocks a round: the place of
// the block it is at, as a pointer to its row `lane`. A step along a row of
// blocks adds 32 bytes; leaving the row locates the block anew.
template <typename Byte>
struct RowWalk {
  Byte* row;  // row `lane` of the block
  int plane, stride, col, pbw;

  __device__ __forceinline__ void locate(int64_t b, Byte* y, Byte* u,
                                         Byte* v, int h, int w, int lane) {
    const BlockLoc loc = locate_block(b, h, w);
    plane = loc.plane;
    stride = loc.stride;
    col = loc.col;
    pbw = loc.pbw;
    row = (plane == 0 ? y : plane == 1 ? u : v) + loc.offset +
          int64_t(lane) * stride;
  }
  // to block b + 4, from block b
  __device__ __forceinline__ void step(int64_t b, Byte* y, Byte* u, Byte* v,
                                       int h, int w, int lane) {
    col += 4;
    if (col < pbw)
      row += 32;
    else
      locate(b + 4, y, u, v, h, w, lane);
  }
};

// The rounds of this thread's warp, and of them those in which its group
// has a block: the warp's run [first, last) from warp_run, b its group's
// first block.
__device__ __forceinline__ void group_rounds(int64_t b, int64_t last,
                                             int group, int& rounds,
                                             int& mine) {
  const int64_t first = b - group % 4;
  rounds = last > first ? int((last - first + 3) / 4) : 0;
  mine = last > b ? int((last - b + 3) / 4) : 0;
}

// Row `lane` of a block, 8 pixels 4 to a word, at `row`; 0 where active is
// false. kAligned: `row` is 8-byte aligned, one 8-byte load; else
// load_pixel_row's byte loads where it is not.
template <bool kAligned>
__device__ __forceinline__ uint2 pixel_row(const uint8_t* row, bool active) {
  if (!kAligned) return load_pixel_row(row, 0, active, 0);
  return active ? *reinterpret_cast<const uint2*>(row) : make_uint2(0, 0);
}

// F1's kernel body (fast_dct_quantize.cu): y [h, w], u and v [h/2, w/2]
// u8 planes, 8-byte aligned where kAligned; qt f32 [3, 64]; dct f32 [64];
// coeffs i16 [N, 64], 16-byte aligned.
template <bool kAligned>
__device__ __forceinline__ void forward_frame(
    const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
    const uint8_t* __restrict__ v, int h, int w,
    const float* __restrict__ qt, const float* __restrict__ dct,
    int16_t* __restrict__ coeffs) {
  __shared__ __align__(16) CodecParams prm;
  __shared__ __align__(16) Slices sl;
  load_params(prm, dct, qt);  // synchronises the CTA
  const int lane = threadIdx.x % 8, group = threadIdx.x / 8;
  float crow[8];  // row `lane` of C
  load_row(prm.c + 8 * lane, crow);
  float c[64];  // all of C
  load_matrix(prm.c, c);
  int64_t b, last;
  warp_run(frame_blocks(h, w), b, last);
  b += group % 4;  // a round of the warp: four blocks side by side
  int rounds, mine;
  group_rounds(b, last, group, rounds, mine);
  uint4* out = reinterpret_cast<uint4*>(coeffs + 64 * b) + lane;
  RowWalk<const uint8_t> ahead;  // the next block to load
  ahead.locate(b, y, u, v, h, w, lane);
  uint2 pend[kDepth];  // rows of the next kDepth rounds, in flight
  int pplane[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    pplane[d] = ahead.plane;
    pend[d] = pixel_row<kAligned>(ahead.row, d < mine);
    ahead.step(b + 4 * d, y, u, v, h, w, lane);
  }
  float qr[8];  // row `lane` of the table of plane qplane
  int qplane = 0;
  load_q(prm.q, 0, lane, qr);
  for (int r = 0; r < rounds; ++r, out += 32) {  // warp-uniform
    const uint2 here = pend[0];
    if (pplane[0] != qplane) {
      qplane = pplane[0];
      load_q(prm.q, qplane, lane, qr);
    }
#pragma unroll
    for (int d = 0; d + 1 < kDepth; ++d) {
      pend[d] = pend[d + 1];
      pplane[d] = pplane[d + 1];
    }
    pplane[kDepth - 1] = ahead.plane;
    pend[kDepth - 1] = pixel_row<kAligned>(ahead.row, r + kDepth < mine);
    ahead.step(b + 4 * int64_t(r + kDepth), y, u, v, h, w, lane);
    float* xs = sl.x[r & 1][group];
    {
      float xr[8];
      centred_pixels(here, xr);
      store_slice_row(xs, lane, xr);
    }
    __syncwarp();  // the group's rows are in xs
    float cb[8];   // row `lane` of C . B, k ascending in every chain
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float xr[8];
      load_slice_row(xs, kk, xr);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        cb[k] = kk == 0 ? __fmul_rn(crow[0], xr[k])
                        : __fmaf_rn(crow[kk], xr[k], cb[k]);
    }
    float acc[8];  // row `lane` of (C . B) . C^T
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[k] = __fmul_rn(cb[0], c[8 * k]);
#pragma unroll
      for (int kk = 1; kk < 8; ++kk)
        acc[k] = __fmaf_rn(cb[kk], c[8 * k + kk], acc[k]);
    }
    uint32_t bits[8];  // quantized; the int16 is the low half
#pragma unroll
    for (int k = 0; k < 8; ++k)
      bits[k] = uint32_t(int(roundf(__fdiv_rn(acc[k], qr[k]))));
    if (r < mine)
      *out = make_uint4(__byte_perm(bits[0], bits[1], 0x5410),
                        __byte_perm(bits[2], bits[3], 0x5410),
                        __byte_perm(bits[4], bits[5], 0x5410),
                        __byte_perm(bits[6], bits[7], 0x5410));
  }
}

// F2's kernel body (fast_dequantize_idct.cu): coeffs i16 [N, 64], 16-byte
// aligned; qt f32 [3, 64]; dct f32 [64]; y [h, w], u and v [h/2, w/2] u8
// planes, 8-byte aligned where kAligned.
template <bool kAligned>
__device__ __forceinline__ void inverse_frame(
    const int16_t* __restrict__ coeffs, int h, int w,
    const float* __restrict__ qt, const float* __restrict__ dct,
    uint8_t* __restrict__ y, uint8_t* __restrict__ u,
    uint8_t* __restrict__ v) {
  __shared__ __align__(16) CodecParams prm;
  __shared__ __align__(16) Slices sl;
  load_params(prm, dct, qt);  // synchronises the CTA
  const int lane = threadIdx.x % 8, group = threadIdx.x / 8;
  float ccol[8];  // column `lane` of C
#pragma unroll
  for (int k = 0; k < 8; ++k) ccol[k] = prm.c[8 * k + lane];
  float c[64];  // all of C
  load_matrix(prm.c, c);
  int64_t b, last;
  warp_run(frame_blocks(h, w), b, last);
  b += group % 4;  // a round of the warp: four blocks side by side
  int rounds, mine;
  group_rounds(b, last, group, rounds, mine);
  const uint4* in = reinterpret_cast<const uint4*>(coeffs + 64 * b) + lane;
  RowWalk<uint8_t> at;  // the block of the round
  at.locate(b, y, u, v, h, w, lane);
  uint4 pend[kDepth];  // coefficient rows of the next kDepth rounds
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    pend[d] = d < mine ? in[32 * d] : make_uint4(0, 0, 0, 0);
  float qr[8];  // row `lane` of the table of plane qplane
  int qplane = 0;
  load_q(prm.q, 0, lane, qr);
  for (int r = 0; r < rounds; ++r, in += 32) {  // warp-uniform
    if (at.plane != qplane) {
      qplane = at.plane;
      load_q(prm.q, qplane, lane, qr);
    }
    const uint4 row = pend[0];
#pragma unroll
    for (int d = 0; d + 1 < kDepth; ++d) pend[d] = pend[d + 1];
    pend[kDepth - 1] =
        r + kDepth < mine ? in[32 * kDepth] : make_uint4(0, 0, 0, 0);
    float* xs = sl.x[r & 1][group];
    {
      float xr[8];
      coefficient_floats(row, xr);
#pragma unroll
      for (int k = 0; k < 8; ++k) xr[k] = __fmul_rn(xr[k], qr[k]);
      store_slice_row(xs, lane, xr);
    }
    __syncwarp();  // the group's rows are in xs
    float t[8];    // row `lane` of C^T . X, k ascending in every chain
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float xr[8];
      load_slice_row(xs, kk, xr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t[j] = kk == 0 ? __fmul_rn(ccol[0], xr[j])
                       : __fmaf_rn(ccol[kk], xr[j], t[j]);
    }
    float acc[8];  // row `lane` of (C^T . X) . C
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j] = kk == 0 ? __fmul_rn(t[0], c[j])
                         : __fmaf_rn(t[kk], c[8 * kk + j], acc[j]);
    }
    uint32_t px[8];  // clamp(roundf(x) + 128, 0, 255)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pv = int(roundf(acc[j])) + 128;
      px[j] = uint32_t(pv < 0 ? 0 : (pv > 255 ? 255 : pv));
    }
    const uint2 pix = make_uint2(
        __byte_perm(__byte_perm(px[0], px[1], 0x0040),
                    __byte_perm(px[2], px[3], 0x0040), 0x5410),
        __byte_perm(__byte_perm(px[4], px[5], 0x0040),
                    __byte_perm(px[6], px[7], 0x0040), 0x5410));
    if (r < mine) {
      if (kAligned || (reinterpret_cast<uintptr_t>(at.row) & 7) == 0) {
        *reinterpret_cast<uint2*>(at.row) = pix;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          at.row[k] = uint8_t((k < 4 ? pix.x : pix.y) >> (8 * (k % 4)));
      }
    }
    at.step(b + 4 * int64_t(r), y, u, v, h, w, lane);
  }
}

}  // namespace fast
}  // namespace myyuv
