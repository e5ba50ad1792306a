// T1: the lane bit-permutation of int32 rows: for rows of P = 2^nbits
// words, out[r, l_out] = x[r, l] where bit i of l_out is bit perm[i] of l.
//
// Replaces the TPU kernel tools/exp_shuffle.py::make_shuffle_kernel
// (pallas_call :91, lane_shuffle), which builds the permutation from
// stages of lane rolls and selects, because Mosaic has no per-lane dynamic
// addressing. On the card a permutation is a gather by computed index: out
// word j reads x word src(j), src(j) having bit perm[i] equal to bit i of j.
//
// What bounds it on the H100: memory traffic (each row read once and
// written once; a 4032-wide plane as [3008, 1024] words moves 24.6 MB, >=
// 7.3 us at 3.35 TB/s).
// What the design does about it: a CTA takes one row. Its threads read the
// row into shared memory with 16-byte loads (a warp reads 512 contiguous
// bytes), then each builds a 16-byte run of 4 output words from shared
// memory and stores it (a warp writes 512 contiguous bytes), so neither side
// of device memory is touched at 4-byte granularity. src(4 t + k) =
// src(4 t) | src(k), since the two take disjoint bits of j. The row sits
// in shared memory with the 4-word groups XOR-swizzled by bits 5..7 of the
// word index, which spreads a gather's reads over more banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The source word of output word j: bit perm[i] of it is bit i of j, perm[i]
// in bits 4 i .. 4 i + 3 of perm_code.
__device__ __forceinline__ int source(int j, int nbits,
                                      unsigned long long perm_code) {
  int s = 0;
  for (int i = 0; i < nbits; ++i)
    s |= ((j >> i) & 1) << int(perm_code >> (4 * i) & 15);
  return s;
}

// Shared-memory slot of row word s.
__device__ __forceinline__ int slot(int s) {
  return s ^ (((s >> 5) & 7) << 2);
}

__global__ void __launch_bounds__(kThreads)
lane_shuffle_kernel(const int4* __restrict__ x, int nbits,
                    unsigned long long perm_code, int4* __restrict__ out) {
  extern __shared__ int4 row4[];  // the row, 2^nbits words
  const int p4 = (1 << nbits) / 4;
  const int64_t r = blockIdx.x;
  for (int i = threadIdx.x; i < p4; i += kThreads)
    row4[slot(4 * i) / 4] = x[r * p4 + i];
  __syncthreads();
  const int* row = reinterpret_cast<const int*>(row4);
  int lo[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) lo[k] = source(k, nbits, perm_code);
  for (int i = threadIdx.x; i < p4; i += kThreads) {
    const int s = source(4 * i, nbits, perm_code);
    out[r * p4 + i] = make_int4(row[slot(s | lo[0])], row[slot(s | lo[1])],
                                row[slot(s | lo[2])], row[slot(s | lo[3])]);
  }
}

}  // namespace

// x i32 [rows, 2^nbits] (2 <= nbits <= 13, 16-byte aligned); perm_code holds
// perm[i] (a permutation of 0 .. nbits - 1) in bits 4 i .. 4 i + 3; output
// out i32 [rows, 2^nbits] (16-byte aligned). Launches on `stream` and
// returns cudaGetLastError() (cudaErrorInvalidValue for nbits out of
// range).
extern "C" int myyuv_lane_shuffle(const void* x, int64_t rows, int64_t nbits,
                                  int64_t perm_code, void* out, void* stream) {
  if (nbits < 2 || nbits > 13) return int(cudaErrorInvalidValue);
  if (rows > 0)
    lane_shuffle_kernel<<<unsigned(rows), kThreads, 4u << nbits,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(x), int(nbits),
        static_cast<unsigned long long>(perm_code), static_cast<int4*>(out));
  return int(cudaGetLastError());
}
