// X1: BGRX pixels -> IYUV 4:2:0 planes (the capture conversion).
//
// Replaces myyuv_tpu/kernels/device.py::bgrx_to_iyuv / bgrx_to_iyuv_vals
// (XLA in the JAX package, not Pallas), bit-exact with kernels/scalar.py's
// model of the reference converter (myyuv_yuv.cpp:34-52, 88-127):
//   yf = (0.299 R + 0.587 G) + 0.114 B      each product and sum rounded
//   Y  = (int) yf                           truncation
//   cb = ((int)((B - yf) * 0.564) + 128) & 255, cr the same with R, 0.713
//   U  = sum over the 2x2 quad of (cb + 2) >> 2, & 255 (V the same with cr)
// The chroma takes the unrounded f32 luma yf, and the quad sum is of the
// per-sample rounded quarters, not the rounded mean. Every product and sum
// is spelled with __fmul_rn / __fadd_rn / __fsub_rn, and the library is
// built with -fmad=false and without -use_fast_math, so nothing contracts.
//
// What bounds it on the H100: bytes. A 4032x3008 frame reads 48.5 MB of
// pixels and writes 18.2 MB of planes, 0.0199 ms at 3.35 TB/s; its ~9 f32
// operations a pixel are ~0.002 ms at 67 TFLOP/s.
// What the design does about it: a thread takes two adjacent 2x2 quads (4
// pixels of two rows): one 16-byte load per pixel row, so a warp reads two
// rows of 512 contiguous bytes, and one 4-byte store per Y row and 2-byte
// stores of U and V. A batch [..., H, W, 4] with H even is one frame of
// prod(...) * H rows: quads never straddle frames. Rows or planes that are
// not aligned for the vector accesses (W not a multiple of 4, a start off
// a 16-byte boundary) take a byte-wise instance of the same kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace myyuv {
namespace {

constexpr int kConvertThreads = 128;
constexpr int64_t kMaxGridY = 65535;

// One BGRX word (b | g << 8 | r << 16 | x << 24) -> its luma and the
// rounded quarters of its two chroma samples.
__device__ inline void convert_pixel(uint32_t px, uint32_t& y, uint32_t& qcb,
                                     uint32_t& qcr) {
  const float b = float(px & 255u);
  const float g = float((px >> 8) & 255u);
  const float r = float((px >> 16) & 255u);
  const float yf = __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r),
                                       __fmul_rn(0.587f, g)),
                             __fmul_rn(0.114f, b));
  y = uint32_t(int(yf)) & 255u;
  const int cb = (int(__fmul_rn(__fsub_rn(b, yf), 0.564f)) + 128) & 255;
  const int cr = (int(__fmul_rn(__fsub_rn(r, yf), 0.713f)) + 128) & 255;
  qcb = uint32_t(cb + 2) >> 2;
  qcr = uint32_t(cr + 2) >> 2;
}

__device__ inline uint32_t load_pixel(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
}

// px [rows, w, 4] with rows = 2 * quad_rows; y [rows, w]; u, v [quad_rows,
// w / 2]. kVec: w % 4 == 0 and px, y, u, v aligned for 16-, 4-, 2- and
// 2-byte accesses.
template <bool kVec>
__global__ void __launch_bounds__(kConvertThreads)
bgrx_to_iyuv_kernel(const uint8_t* __restrict__ px, int64_t quad_rows, int w,
                    uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                    uint8_t* __restrict__ v) {
  const int qw = w / 2;  // quads a row
  const int q0 = 2 * int(blockIdx.x * blockDim.x + threadIdx.x);
  if (q0 >= qw) return;
  const int npx = kVec || qw - q0 >= 2 ? 4 : 2;  // pixels a row, this thread
  for (int64_t qr = blockIdx.y; qr < quad_rows; qr += gridDim.y) {
    const int64_t top = 2 * qr * w + 2 * q0;  // index of the top-left pixel
    uint32_t p[2][4];
    if (kVec) {
      const uint4 a = *reinterpret_cast<const uint4*>(px + 4 * top);
      const uint4 c = *reinterpret_cast<const uint4*>(px + 4 * (top + w));
      p[0][0] = a.x, p[0][1] = a.y, p[0][2] = a.z, p[0][3] = a.w;
      p[1][0] = c.x, p[1][1] = c.y, p[1][2] = c.z, p[1][3] = c.w;
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          p[r][k] = k < npx ? load_pixel(px + 4 * (top + r * w + k)) : 0u;
    }
    uint32_t ys[2][4], su[2] = {0u, 0u}, sv[2] = {0u, 0u};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t qcb, qcr;
        convert_pixel(p[r][k], ys[r][k], qcb, qcr);
        su[k >> 1] += qcb;
        sv[k >> 1] += qcr;
      }
    const int64_t c = qr * qw + q0;  // index of the first chroma sample
    if (kVec) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(y + top + r * w) =
            ys[r][0] | ys[r][1] << 8 | ys[r][2] << 16 | ys[r][3] << 24;
      *reinterpret_cast<uint16_t*>(u + c) =
          uint16_t((su[0] & 255u) | (su[1] & 255u) << 8);
      *reinterpret_cast<uint16_t*>(v + c) =
          uint16_t((sv[0] & 255u) | (sv[1] & 255u) << 8);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < npx) {
          y[top + k] = uint8_t(ys[0][k]);
          y[top + w + k] = uint8_t(ys[1][k]);
        }
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (2 * q < npx) {
          u[c + q] = uint8_t(su[q]);
          v[c + q] = uint8_t(sv[q]);
        }
    }
  }
}

}  // namespace
}  // namespace myyuv

// px u8 [rows, w, 4] BGRX (rows and w even; a batch's frames stacked on
// rows); outputs u8 y [rows, w], u and v [rows / 2, w / 2]. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int myyuv_bgrx_to_iyuv(const void* px, int64_t rows, int64_t w,
                                  void* y, void* u, void* v, void* stream) {
  const int64_t quad_rows = rows / 2, pairs = (w / 2 + 1) / 2;
  if (quad_rows > 0 && pairs > 0) {
    const auto at = [](const void* p, uintptr_t a) {
      return reinterpret_cast<uintptr_t>(p) % a == 0;
    };
    const bool vec = w % 4 == 0 && at(px, 16) && at(y, 4) && at(u, 2) &&
                     at(v, 2);
    const dim3 grid(
        unsigned((pairs + myyuv::kConvertThreads - 1) /
                 myyuv::kConvertThreads),
        unsigned(quad_rows < myyuv::kMaxGridY ? quad_rows
                                              : myyuv::kMaxGridY));
    const auto kernel = vec ? myyuv::bgrx_to_iyuv_kernel<true>
                            : myyuv::bgrx_to_iyuv_kernel<false>;
    kernel<<<grid, myyuv::kConvertThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(px), quad_rows, int(w),
        static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v));
  }
  return int(cudaGetLastError());
}
