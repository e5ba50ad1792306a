// Group transform stages: one 8x8 block per group of 8 lanes, lane r
// computing row r in registers. dct_quantize_group is the DCT + quantize of
// K1 (dct_encode.cu) and K3 (dct_quantize.cu); dequantize_idct_group is the
// dequantize + IDCT of K2 (decode_idct.cu) and K4 (dequantize_idct.cu). The
// fused and the staged kernels call the same function, so the fused and the
// staged route's coefficients and pixels cannot drift apart.
//
// Exactness (applyDCTBlock / restoreDCTBlock, DCT.cpp:232-277,325-361):
// every product and sum of the chains is __fmul_rn/__fadd_rn, k ascending,
// the first product not added to 0 (and the build passes -fmad=false);
// quantize is roundf(__fdiv_rn(coef, q)), IEEE division and half-away
// rounding, as int16(std::round(coef / q)) in DCT.cpp:273; dequantize is one
// exact f32 product; pixels are clamp(roundf(x) + 128, 0, 255).
//
// kFast = true is precision="fast" (F1 fast_dct_quantize.cu, F2
// fast_dequantize_idct.cu): each step of a chain after the first product is
// one __fmaf_rn, rounded once, k ascending; everything else as above. The
// explicit intrinsic is an FMA whatever -fmad says. No tensor core, no TF32.
// The exact instances (kFast = false, the default) are the code K1-K4 had.
#pragma once

#include "codec_common.cuh"

namespace myyuv {

// K3's and K4's CTA: 32 groups of 8 lanes, each group one block at a time.
constexpr int kTransformThreads = 256;
constexpr int kTransformGroups = kTransformThreads / 8;

// acc + a * b of a transform chain: two roundings (__fmul_rn, then
// __fadd_rn) in the exact transforms, one (__fmaf_rn) in the fast ones.
template <bool kFast>
__device__ __forceinline__ float mul_add(float a, float b, float acc) {
  return kFast ? __fmaf_rn(a, b, acc) : __fadd_rn(acc, __fmul_rn(a, b));
}

// 8 consecutive floats of 16-byte aligned shared memory as two vector loads.
__device__ __forceinline__ void load_row(const float* p, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// Row `lane` of the 8x8 block at px (row stride `stride`): its 8 pixels,
// 4 to a word, with one 8-byte load where the row is 8-byte aligned, else
// byte loads; 0 where active is false.
__device__ __forceinline__ uint2 load_pixel_row(const uint8_t* px,
                                                int stride, bool active,
                                                int lane) {
  uint2 pix = make_uint2(0, 0);
  if (!active) return pix;
  const uint8_t* src = px + int64_t(lane) * stride;
  if ((reinterpret_cast<uintptr_t>(src) & 7) == 0)
    return *reinterpret_cast<const uint2*>(src);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pix.x |= uint32_t(src[k]) << (8 * k);
    pix.y |= uint32_t(src[k + 4]) << (8 * k);
  }
  return pix;
}

// The forward transform of one 8x8 block per group of 8 lanes: lane `lane`
// holds row `lane` of the pixels (load_pixel_row) and computes row `lane`
// of C . B and then of the quantized (C . B) . C^T into out, in registers.
// x is the group's 64-float slice of shared memory for the pixels - 128; c
// and q are 16-byte aligned. Every lane of the warp calls this.
template <bool kFast = false>
__device__ __forceinline__ void dct_quantize_group(uint2 pix, const float* c,
                                                   const float* q, float* x,
                                                   int lane,
                                                   int16_t (&out)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    x[lane * 8 + k] =
        float(((k < 4 ? pix.x : pix.y) >> (8 * (k % 4))) & 0xFF) - 128.0f;
  __syncwarp();
  float crow[8];
  load_row(c + lane * 8, crow);
  float cb[8];  // row `lane` of C . B, k ascending in every chain
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    float xr[8];
    load_row(x + kk * 8, xr);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      cb[k] = kk == 0 ? __fmul_rn(crow[0], xr[k])
                      : mul_add<kFast>(crow[kk], xr[k], cb[k]);
  }
  float qr[8];
  load_row(q + lane * 8, qr);
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // (C . B) . C^T, quantized
    float cj[8];
    load_row(c + k * 8, cj);
    float acc = __fmul_rn(cb[0], cj[0]);
#pragma unroll
    for (int kk = 1; kk < 8; ++kk)
      acc = mul_add<kFast>(cb[kk], cj[kk], acc);
    out[k] = int16_t(int(roundf(__fdiv_rn(acc, qr[k]))));
  }
}

// The DCT matrix in registers for dequantize_idct_group: all of C, and
// column `lane` of it. c is 16-byte aligned.
struct IdctRegs {
  float c[64];
  float col[8];
};

__device__ __forceinline__ void load_idct_regs(const float* c, int lane,
                                               IdctRegs& r) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float row[8];
    load_row(c + k * 8, row);
#pragma unroll
    for (int j = 0; j < 8; ++j) r.c[k * 8 + j] = row[j];
    r.col[k] = c[k * 8 + lane];
  }
}

// The inverse transform of one 8x8 block per group of 8 lanes: lane `lane`
// dequantizes `row`, row `lane` of the block's int16 coefficients, into x
// (the group's 64-float slice of shared memory), then computes row `lane`
// of C^T . X and of (C^T . X) . C in registers and stores the row's 8
// pixels at px + lane * stride, all 0 if bad. q is 16-byte aligned. A group
// with store false writes nothing. Every lane of the warp calls this.
template <bool kFast = false>
__device__ __forceinline__ void dequantize_idct_group(
    uint4 row, const IdctRegs& c, const float* q, float* x, int lane,
    bool store, bool bad, uint8_t* px, int stride) {
  const uint32_t cw[4] = {row.x, row.y, row.z, row.w};
  float qr[8];
  load_row(q + lane * 8, qr);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    x[lane * 8 + k] =
        __fmul_rn(float(int16_t(cw[k / 2] >> (16 * (k % 2)))), qr[k]);
  __syncwarp();
  const float* ccol = c.col;  // column `lane` of C
  float t[8];  // row `lane` of C^T . X, k ascending in every chain
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    float xr[8];
    load_row(x + kk * 8, xr);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      t[j] = kk == 0 ? __fmul_rn(ccol[0], xr[j])
                     : mul_add<kFast>(ccol[kk], xr[j], t[j]);
  }
  float acc[8];  // row `lane` of (C^T . X) . C
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j] = kk == 0 ? __fmul_rn(t[0], c.c[j])
                       : mul_add<kFast>(t[kk], c.c[kk * 8 + j], acc[j]);
  }
  uint32_t pix[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = int(roundf(acc[j])) + 128;
    pix[j / 4] |= uint32_t(r < 0 ? 0 : (r > 255 ? 255 : r)) << (8 * (j % 4));
  }
  if (bad) pix[0] = pix[1] = 0;  // a bad block's pixels are 0
  if (!store) return;
  uint8_t* dst = px + int64_t(lane) * stride;
  if ((reinterpret_cast<uintptr_t>(dst) & 7) == 0) {  // one 8-byte store
    *reinterpret_cast<uint2*>(dst) = make_uint2(pix[0], pix[1]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[k] = uint8_t(pix[k / 4] >> (8 * (k % 4)));
  }
}

}  // namespace myyuv
