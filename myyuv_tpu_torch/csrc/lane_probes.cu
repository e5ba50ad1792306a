// T3: four lane operations on int32 rows [R, C] (C a multiple of 8):
//   op 1 (s1, strided read):  out [R, C/2] = x[:, 0::2] + x[:, 1::2];
//   op 2 (s2, strided write): out [R, C], out[:, 0::2] = x[:, :C/2] and
//                             out[:, 1::2] = x[:, C/2:];
//   op 3 (s3, reshape):       out [R, C/2] = the pair sum of x viewed as
//                             [R, C/2, 2];
//   op 4 (s4, lane roll):     out [R, C] = x + roll(x, -1, axis 1), i.e.
//                             out[:, j] = x[:, j] + x[:, (j + 1) % C].
// Sums wrap modulo 2^32, as int32 sums do in JAX and PyTorch.
//
// Replaces the TPU kernels of tools/exp_r4lane.py (pallas_call :100, build):
// k_sliceread :77, k_slicewrite :81, k_reshape :87 and k_roll :93, probes of
// which lane-stride primitives Mosaic compiles. On the card each is plain
// addressing. s1 and s3 compute the same function, and a strided read of
// the even and odd words and a [C/2, 2] view of the row are the same
// addressing here, so they share one code path. s4 computes what the
// tool's pltpu.roll(t, -1, 1) means (the tool's form raises on current JAX:
// a roll's shift must be non-negative; a shift of C - 1 is the same roll).
//
// What bounds it on the H100: memory traffic (at the tool's [512, 8192],
// 16.8 MB in and 8.4 MB (s1, s3) or 16.8 MB (s2, s4) out: >= 7.5 / 10.0 us at
// 3.35 TB/s).
// What the design does about it: each thread reads and writes 16-byte runs
// (a warp 512 contiguous bytes a load or store): s1/s3 two runs of 4 pairs
// in, one run of 4 sums out; s2 a run from each half in, two interleaved
// runs out; s4 one run in plus the word after it (from the same or the next
// 32-byte sector), one run out.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int add(int a, int b) {
  return int(unsigned(a) + unsigned(b));
}

// s1 / s3: thread i sums the 4 pairs of words 8 i .. 8 i + 7 of the flat
// input (rows hold whole pairs, so output word 4 i + k is pair 4 i + k).
__global__ void __launch_bounds__(kThreads)
pair_sum_kernel(const int4* __restrict__ x, int64_t n4,
                int4* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int4 a = x[2 * i], b = x[2 * i + 1];
  out[i] = make_int4(add(a.x, a.y), add(a.z, a.w), add(b.x, b.y),
                     add(b.z, b.w));
}

// s2: thread i takes run j = i % (C / 8) of row r = i / (C / 8) from both
// halves and writes output words 8 j .. 8 j + 7 of the row.
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const int4* __restrict__ x, int64_t cols, int64_t n,
                  int4* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t half4 = cols / 8;  // 16-byte runs in half a row
  if (i >= n) return;
  const int64_t r = i / half4, j = i % half4;
  const int4 a = x[r * 2 * half4 + j], b = x[r * 2 * half4 + half4 + j];
  out[2 * i] = make_int4(a.x, b.x, a.y, b.y);
  out[2 * i + 1] = make_int4(a.z, b.z, a.w, b.w);
}

// s4: thread i writes run j = i % (C / 4) of row r = i / (C / 4).
__global__ void __launch_bounds__(kThreads)
roll_sum_kernel(const int4* __restrict__ x, int64_t cols, int64_t n4,
                int4* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int64_t cols4 = cols / 4, r = i / cols4, j = i % cols4;
  const int4 a = x[i];
  const int next = reinterpret_cast<const int*>(x)[r * cols +
                                                   (4 * j + 4) % cols];
  out[i] = make_int4(add(a.x, a.y), add(a.y, a.z), add(a.z, a.w),
                     add(a.w, next));
}

}  // namespace

// x i32 [rows, cols] (cols a multiple of 8, 16-byte aligned); op 1..4 as
// above; output out i32 [rows, cols / 2] (ops 1, 3) or [rows, cols] (ops
// 2, 4), 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for another op).
extern "C" int myyuv_lane_probes(const void* x, int64_t rows, int64_t cols,
                                 int64_t op, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x4 = static_cast<const int4*>(x);
  auto* o4 = static_cast<int4*>(out);
  // threads: one per 16-byte run of output (ops 1, 3, 4) or per pair of
  // output runs (op 2)
  const int64_t n = op == 2 ? rows * cols / 8
                  : op == 4 ? rows * cols / 4 : rows * cols / 8;
  const unsigned grid = unsigned((n + kThreads - 1) / kThreads);
  if (op < 1 || op > 4) return int(cudaErrorInvalidValue);
  if (n > 0) {
    if (op == 1 || op == 3)
      pair_sum_kernel<<<grid, kThreads, 0, s>>>(x4, n, o4);
    else if (op == 2)
      interleave_kernel<<<grid, kThreads, 0, s>>>(x4, cols, n, o4);
    else
      roll_sum_kernel<<<grid, kThreads, 0, s>>>(x4, cols, n, o4);
  }
  return int(cudaGetLastError());
}
