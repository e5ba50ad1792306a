// Shared device helpers of the codec kernels (csrc/*.cu).
//
// Block-major frame geometry: block id b counts the Y plane's 8x8 blocks in
// raster order, then U's, then V's (the on-disk plane order, DCT.cpp:112-173).
// A batch of B frames passed as one plane of B*h rows gives the plane-major
// batch order (all Y, then all U, then all V, frames contiguous in each).
// A chunk lane is 256 bytes held as 64 little-endian u32 words, so stream bit
// p is bit (p & 31) of word (p >> 5) and stream byte j is byte (j & 3) of word
// (j >> 2). A coefficient row is 64 int16 in natural row-major 8x8 order
// (128 bytes, 16-byte aligned in every [N, 64] tensor).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace myyuv {

constexpr int kThreads = 128;   // CUDA threads per thread block
constexpr int kLaneWords = 64;  // 256-byte lane

// zigzag scan: message position i reads coefficient kZigzag[i] of the block
static __constant__ uint8_t kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct BlockLoc {
  int plane;       // 0 = Y, 1 = U, 2 = V
  int stride;      // plane row length in bytes
  int64_t offset;  // byte offset of the block's top-left pixel in its plane
};

// Frame of h x w luma (h, w divisible by 16): total 8x8 blocks of Y, U, V.
__host__ __device__ inline int64_t frame_blocks(int64_t h, int64_t w) {
  return (h / 8) * (w / 8) + 2 * (h / 16) * (w / 16);
}

__device__ inline BlockLoc locate_block(int64_t b, int h, int w) {
  const int64_t ny = int64_t(h / 8) * (w / 8);
  const int64_t nc = int64_t(h / 16) * (w / 16);
  BlockLoc r;
  int64_t k, pbw;
  if (b < ny) {
    r.plane = 0;
    r.stride = w;
    k = b;
    pbw = w / 8;
  } else {
    r.plane = b < ny + nc ? 1 : 2;
    r.stride = w / 2;
    k = b - ny - (r.plane == 2 ? nc : 0);
    pbw = w / 16;
  }
  r.offset = (k / pbw) * 8 * r.stride + (k % pbw) * 8;
  return r;
}

// The DCT matrix and the three plane tables, staged in shared memory once per
// thread block (every thread of the block reads all of them).
struct CodecParams {
  float c[64];
  float q[3 * 64];
};

__device__ inline void load_params(CodecParams& p, const float* dct,
                                   const float* qt) {
  for (int i = threadIdx.x; i < 64; i += blockDim.x) p.c[i] = dct[i];
  for (int i = threadIdx.x; i < 3 * 64; i += blockDim.x) p.q[i] = qt[i];
  __syncthreads();
}

// One coefficient row to or from device memory as 8 aligned 16-byte
// accesses; `coef` is a 16-byte aligned local array.
__device__ __forceinline__ void load_coeffs(const int16_t* row,
                                            int16_t* coef) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
  uint4* dst = reinterpret_cast<uint4*>(coef);
  for (int k = 0; k < 8; ++k) dst[k] = src[k];
}

__device__ __forceinline__ void store_coeffs(const int16_t* coef,
                                             int16_t* row) {
  const uint4* src = reinterpret_cast<const uint4*>(coef);
  uint4* dst = reinterpret_cast<uint4*>(row);
  for (int k = 0; k < 8; ++k) dst[k] = src[k];
}

}  // namespace myyuv
