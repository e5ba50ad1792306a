// T4: y = a * b + c elementwise over f32, in three forms: bare (plain C++
// `*` and `+` under the repository's build flags), rounded
// (__fadd_rn(__fmul_rn(a, b), c), each step rounded) and fused (__fmaf_rn,
// one rounding).
//
// Replaces the TPU kernels tools/exp_fma.py::_bare and ::_defeated
// (pallas_call :50), the probe of whether Mosaic contracts a multiply and
// an add into one FMA. On the card the question is what nvcc does under
// the port's flags: with -fmad=false (kernels/build.py) bare must equal
// rounded bit for bit, and fused shows what a contraction would change on
// the same inputs.
//
// What bounds it on the H100: at the tool's size (2^16 elements, 1 MB in
// all) a launch; by count, its bytes.
// What the design does about it: each thread computes a 16-byte run of 4
// elements (a warp reads and writes 512 contiguous bytes a load or store).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int kForm>
__device__ __forceinline__ float form(float a, float b, float c) {
  if (kForm == 0) return a * b + c;
  if (kForm == 1) return __fadd_rn(__fmul_rn(a, b), c);
  return __fmaf_rn(a, b, c);
}

template <int kForm>
__global__ void __launch_bounds__(kThreads)
fma_probe_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                 const float4* __restrict__ c, int64_t n4,
                 float4* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const float4 x = a[i], y = b[i], z = c[i];
  out[i] = make_float4(form<kForm>(x.x, y.x, z.x), form<kForm>(x.y, y.y, z.y),
                       form<kForm>(x.z, y.z, z.z), form<kForm>(x.w, y.w, z.w));
}

}  // namespace

// a, b, c f32 [n] (n a multiple of 4, 16-byte aligned); form 0 bare, 1
// rounded, 2 fused; output out f32 [n]. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for another form).
extern "C" int myyuv_fma_probe(const void* a, const void* b, const void* c,
                               int64_t n, int64_t form, void* out,
                               void* stream) {
  const int64_t n4 = n / 4;
  const unsigned grid = unsigned((n4 + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* a4 = static_cast<const float4*>(a);
  const auto* b4 = static_cast<const float4*>(b);
  const auto* c4 = static_cast<const float4*>(c);
  auto* o4 = static_cast<float4*>(out);
  if (form < 0 || form > 2) return int(cudaErrorInvalidValue);
  if (n4 > 0) {
    if (form == 0)
      fma_probe_kernel<0><<<grid, kThreads, 0, s>>>(a4, b4, c4, n4, o4);
    else if (form == 1)
      fma_probe_kernel<1><<<grid, kThreads, 0, s>>>(a4, b4, c4, n4, o4);
    else
      fma_probe_kernel<2><<<grid, kThreads, 0, s>>>(a4, b4, c4, n4, o4);
  }
  return int(cudaGetLastError());
}
