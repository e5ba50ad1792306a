// Per-block transform stages, one 8x8 block per calling thread: the
// DCT + quantize of K1 (dct_encode.cu) and K3 (dct_quantize.cu), and the
// dequantize + IDCT of K2 (decode_idct.cu) and K4 (dequantize_idct.cu). The
// fused and the staged kernels call the same functions, so their
// coefficients and pixels cannot drift apart.
//
// Exactness (applyDCTBlock / restoreDCTBlock, DCT.cpp:232-277,325-361):
// every product and sum of the chains is __fmul_rn/__fadd_rn, k ascending,
// the first product not added to 0 (and the build passes -fmad=false);
// quantize is roundf(__fdiv_rn(coef, q)), IEEE division and half-away
// rounding, as int16(std::round(coef / q)) in DCT.cpp:273; dequantize is one
// exact f32 product; pixels are clamp(roundf(x) + 128, 0, 255).
#pragma once

#include "codec_common.cuh"

namespace myyuv {

// 8x8 pixels at px (row stride `stride`) -> quantized row-major coefficients
// with DCT matrix c and table q (both row-major [64]).
__device__ __forceinline__ void dct_quantize_block(const uint8_t* px,
                                                   int stride, const float* c,
                                                   const float* q,
                                                   int16_t* coef) {
  float x[64];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j)
      x[i * 8 + j] = float(px[int64_t(i) * stride + j]) - 128.0f;  // exact
  float t[64];  // C . B
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(c[i * 8], x[j]);
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(c[i * 8 + k], x[k * 8 + j]));
      t[i * 8 + j] = acc;
    }
  for (int i = 0; i < 8; ++i)  // (C . B) . C^T, quantized
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(t[i * 8], c[j * 8]);
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(t[i * 8 + k], c[j * 8 + k]));
      coef[i * 8 + j] = int16_t(int(roundf(__fdiv_rn(acc, q[i * 8 + j]))));
    }
}

// Row-major coefficients -> 8x8 pixels at px (row stride `stride`).
__device__ __forceinline__ void dequantize_idct_block(const int16_t* coef,
                                                      const float* c,
                                                      const float* q,
                                                      uint8_t* px,
                                                      int stride) {
  float x[64];
  for (int i = 0; i < 64; ++i) x[i] = __fmul_rn(float(coef[i]), q[i]);
  float t[64];  // C^T . X
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(c[i], x[j]);
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(c[k * 8 + i], x[k * 8 + j]));
      t[i * 8 + j] = acc;
    }
  for (int i = 0; i < 8; ++i)  // (C^T . X) . C
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(t[i * 8], c[j]);
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(t[i * 8 + k], c[k * 8 + j]));
      const int r = int(roundf(acc)) + 128;
      px[int64_t(i) * stride + j] = uint8_t(r < 0 ? 0 : (r > 255 ? 255 : r));
    }
}

__device__ __forceinline__ void zero_block(uint8_t* px, int stride) {
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) px[int64_t(i) * stride + j] = 0;
}

}  // namespace myyuv
