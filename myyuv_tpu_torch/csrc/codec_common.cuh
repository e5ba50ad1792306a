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

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace myyuv {

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
  int col, pbw;    // the block's column, and its plane's width, in blocks
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
  r.pbw = int(pbw);
  r.col = int(k % pbw);
  r.offset = (k / pbw) * 8 * r.stride + r.col * 8;
  return r;
}

// The place of block b + step, from `loc`, the place of block b: `step`
// columns on along b's block row, or, where that leaves the row, located
// anew. A walk along a row of blocks takes no division per block.
__device__ inline void step_block(BlockLoc& loc, int64_t b, int step, int h,
                                  int w) {
  loc.col += step;
  if (loc.col < loc.pbw)
    loc.offset += 8 * step;
  else
    loc = locate_block(b + step, h, w);
}

// The run of blocks [first, last) of this thread's warp, when the grid's
// warps split n blocks into runs of one length, a multiple of 4.
__device__ inline void warp_run(int64_t n, int64_t& first, int64_t& last) {
  const int64_t warps = int64_t(gridDim.x) * (blockDim.x / 32);
  const int64_t run = (n + 4 * warps - 1) / (4 * warps) * 4;
  first = (int64_t(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32) * run;
  last = first + run < n ? first + run : n;
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

constexpr int kMaxDevices = 64;

// The grid of a kernel whose CTAs of `threads` threads walk n blocks,
// `per_cta` at a time: the CTAs the current device holds at once, and no
// more than the blocks need. The runtime is asked once per device (the
// occupancy query costs host time at every launch) and the answer kept in
// `held`, the launcher's own.
inline unsigned resident_grid(const void* kernel, int threads, int per_cta,
                              int64_t n,
                              std::atomic<int64_t> (&held)[kMaxDevices]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int64_t ctas = dev < kMaxDevices ? held[dev].load() : 0;
  if (ctas == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    ctas = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) held[dev].store(ctas);
  }
  const int64_t needed = (n + per_cta - 1) / per_cta;
  return unsigned(needed < ctas ? needed : ctas);
}

}  // namespace myyuv
