// X2: IYUV 4:2:0 planes -> BGRX pixels (the preview conversion).
//
// Replaces myyuv_tpu/kernels/device.py::iyuv_to_bgrx (XLA in the JAX
// package, not Pallas), bit-exact with kernels/scalar.py:72-88 and the
// reference viewer's fragment shader (myyuv_opengl/viewer/frag_yuv.glsl):
// with U' = U - 128 and V' = V - 128 of the chroma sample (i >> 1, j >> 1)
// of the pixel's own frame,
//   R = Y + 1.403 V',  G = (Y - 0.714 V') - 0.344 U',  B = Y + 1.773 U'
// each product and sum rounded (__fmul_rn / __fadd_rn / __fsub_rn, built
// with -fmad=false), each channel rounded half to even (__float2int_rn) and
// clamped to 0..255; the pixel is the word b | g << 8 | r << 16 | 0xFF << 24.
//
// What bounds it on the H100: bytes. A 4032x3008 frame reads 18.2 MB of
// planes and writes 48.5 MB of pixels, 0.0199 ms at 3.35 TB/s; its ~8 f32
// operations a pixel are ~0.002 ms at 67 TFLOP/s.
// What the design does about it: a thread takes 4 columns of a chroma row's
// two luma rows: two chroma samples of U and of V, one 4-byte load of Y and
// one 16-byte store of 4 pixel words per row, so a warp writes rows of 512
// contiguous bytes. A batch [..., H, W] runs as prod(...) frames of H rows;
// each chroma row knows its frame, so an odd H never reads the next frame's
// chroma. Odd W, or planes not aligned for the vector accesses, take a
// byte-wise instance of the same kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace myyuv {
namespace {

constexpr int kConvertThreads = 128;
constexpr int64_t kMaxGridY = 65535;

__device__ inline uint32_t channel(float x) {
  const int c = __float2int_rn(x);
  return uint32_t(c < 0 ? 0 : c > 255 ? 255 : c);
}

__device__ inline uint32_t bgrx_word(uint32_t y, float u, float v) {
  const float yf = float(y);
  const float r = __fadd_rn(yf, __fmul_rn(1.403f, v));
  const float g = __fsub_rn(__fsub_rn(yf, __fmul_rn(0.714f, v)),
                            __fmul_rn(0.344f, u));
  const float b = __fadd_rn(yf, __fmul_rn(1.773f, u));
  return channel(b) | channel(g) << 8 | channel(r) << 16 | 0xFF000000u;
}

// y [frames * h, w]; u, v [frames * hc, wc] with hc = ceil(h / 2), wc =
// ceil(w / 2); out [frames * h, w] words. kVec: w % 4 == 0, y 4-byte and
// out 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kConvertThreads)
iyuv_to_bgrx_kernel(const uint8_t* __restrict__ y,
                    const uint8_t* __restrict__ u,
                    const uint8_t* __restrict__ v, int64_t chroma_rows, int h,
                    int w, uint32_t* __restrict__ out) {
  const int hc = (h + 1) / 2, wc = (w + 1) / 2;
  const int j0 = 4 * int(blockIdx.x * blockDim.x + threadIdx.x);
  if (j0 >= w) return;
  const bool second = j0 + 2 < w;  // columns j0 + 2.. have a chroma sample
  for (int64_t cr = blockIdx.y; cr < chroma_rows; cr += gridDim.y) {
    const int64_t f = cr / hc;              // this chroma row's frame
    const int i0 = 2 * int(cr - f * hc);    // its first luma row there
    const int64_t c = cr * wc + j0 / 2;
    const float u0 = float(int(u[c]) - 128), v0 = float(int(v[c]) - 128);
    const float u1 = second ? float(int(u[c + 1]) - 128) : 0.f;
    const float v1 = second ? float(int(v[c + 1]) - 128) : 0.f;
#pragma unroll
    for (int di = 0; di < 2; ++di) {
      if (i0 + di >= h) break;  // the last chroma row of an odd h
      const int64_t row = (f * h + i0 + di) * w + j0;
      if (kVec) {
        const uint32_t ys = *reinterpret_cast<const uint32_t*>(y + row);
        *reinterpret_cast<uint4*>(out + row) = make_uint4(
            bgrx_word(ys & 255u, u0, v0), bgrx_word((ys >> 8) & 255u, u0, v0),
            bgrx_word((ys >> 16) & 255u, u1, v1), bgrx_word(ys >> 24, u1, v1));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j0 + k < w)
            out[row + k] = bgrx_word(y[row + k], k < 2 ? u0 : u1,
                                     k < 2 ? v0 : v1);
      }
    }
  }
}

}  // namespace
}  // namespace myyuv

// y u8 [frames * h, w], u and v u8 [frames * ceil(h/2), ceil(w/2)]; output
// out u8 [frames * h, w, 4] BGRX. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int myyuv_iyuv_to_bgrx(const void* y, const void* u, const void* v,
                                  int64_t frames, int64_t h, int64_t w,
                                  void* out, void* stream) {
  const int64_t chroma_rows = frames * ((h + 1) / 2), quads = (w + 3) / 4;
  if (chroma_rows > 0 && quads > 0) {
    const auto at = [](const void* p, uintptr_t a) {
      return reinterpret_cast<uintptr_t>(p) % a == 0;
    };
    const bool vec = w % 4 == 0 && at(y, 4) && at(out, 16);
    const dim3 grid(
        unsigned((quads + myyuv::kConvertThreads - 1) /
                 myyuv::kConvertThreads),
        unsigned(chroma_rows < myyuv::kMaxGridY ? chroma_rows
                                                : myyuv::kMaxGridY));
    const auto kernel = vec ? myyuv::iyuv_to_bgrx_kernel<true>
                            : myyuv::iyuv_to_bgrx_kernel<false>;
    kernel<<<grid, myyuv::kConvertThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), chroma_rows, int(h), int(w),
        static_cast<uint32_t*>(out));
  }
  return int(cudaGetLastError());
}
