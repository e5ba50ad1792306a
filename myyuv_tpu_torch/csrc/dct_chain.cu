// T7: the 8-term float32 chain of one DCT row, acc = c[0] * x_0, then
// acc = acc + c[k] * x_k for k = 1..7, elementwise over [8, cols] slices of
// x [64, cols].
//
// Replaces the TPU kernel tools/check_tpu_bitexact.py::chain (pallas_call
// :94), the sentinel that a bare chain's multiplies and adds are each
// rounded, as the host's double-rounded sequence is. The chain is written
// with plain C++ `*` and `+`, with no __fmul_rn / __fadd_rn: only the build
// flag -fmad=false (kernels/build.py) keeps nvcc from contracting each
// product and sum into one FMA, so this kernel fails its check against the
// host if that flag is ever dropped.
//
// What bounds it on the H100: at the tool's size ([64, 1024] in, 288 KB in
// all) a launch; by count, its bytes.
// What the design does about it: each thread computes a 16-byte run of 4
// columns of one output row, reading 8 16-byte runs of x (a warp reads 512
// contiguous bytes a load).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dct_chain_kernel(const float4* __restrict__ x, int64_t cols4,
                 const float* __restrict__ c, float4* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= 8 * cols4) return;
  const int64_t r = i / cols4, j = i % cols4;
  const float4 x0 = x[r * cols4 + j];
  const float c0 = c[0];
  float4 acc = make_float4(c0 * x0.x, c0 * x0.y, c0 * x0.z, c0 * x0.w);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const float4 t = x[(8 * k + r) * cols4 + j];
    const float ck = c[k];
    acc.x = acc.x + ck * t.x;
    acc.y = acc.y + ck * t.y;
    acc.z = acc.z + ck * t.z;
    acc.w = acc.w + ck * t.w;
  }
  out[i] = acc;
}

}  // namespace

// x f32 [64, cols] (cols a multiple of 4, 16-byte aligned), c f32 [8];
// output out f32 [8, cols]: out[r] = the chain over rows r, 8 + r, ..., 56
// + r of x. Launches on `stream` and returns cudaGetLastError().
extern "C" int myyuv_dct_chain(const void* x, int64_t cols, const void* c,
                               void* out, void* stream) {
  const int64_t n4 = 8 * (cols / 4);
  if (n4 > 0)
    dct_chain_kernel<<<unsigned((n4 + kThreads - 1) / kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), cols / 4, static_cast<const float*>(c),
        static_cast<float4*>(out));
  return int(cudaGetLastError());
}
