// T2: o = x * q[row], a per-row scale broadcast across f32 rows.
//
// Replaces the TPU kernel tools/exp_bcast.py::kern (pallas_call :31), a
// probe of whether Mosaic broadcasts a [8, 1] column across the lanes of an
// [8, TP] tile. On Hopper a row's scale is one register a thread; the port
// keeps what the probe computes ([64, 256] f32 times [64, 1] in the tool).
//
// What bounds it on the H100: at the tool's size (64 KB in, 64 KB out) a
// launch; by count, its bytes (each element read and written once).
// What the design does about it: each thread scales one 16-byte run of 4
// elements of a row (rows of a multiple of 4 elements, 16-byte aligned), so
// a warp reads and writes 512 contiguous bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bcast_mul_kernel(const float4* __restrict__ x, const float* __restrict__ q,
                 int64_t cols4, int64_t n4, float4* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float s = q[i / cols4];
  float4 v = x[i];
  v.x = __fmul_rn(v.x, s);
  v.y = __fmul_rn(v.y, s);
  v.z = __fmul_rn(v.z, s);
  v.w = __fmul_rn(v.w, s);
  out[i] = v;
}

}  // namespace

// x f32 [rows, cols] (cols a multiple of 4, 16-byte aligned), q f32 [rows];
// output out f32 [rows, cols] (16-byte aligned). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int myyuv_bcast_mul(const void* x, const void* q, int64_t rows,
                               int64_t cols, void* out, void* stream) {
  const int64_t n4 = rows * (cols / 4);
  if (n4 > 0)
    bcast_mul_kernel<<<unsigned((n4 + kThreads - 1) / kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<const float*>(q),
        cols / 4, n4, static_cast<float4*>(out));
  return int(cudaGetLastError());
}
