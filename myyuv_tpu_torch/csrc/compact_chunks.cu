// The compaction: 256-byte chunk lanes -> the on-disk chunk stream, the
// chunks back to back in block order.
//
// Replaces no Pallas kernel. It is the counterpart of the JAX package's XLA
// compaction (myyuv_tpu/engine/device_stream.py:360 `_compact_split`, :667
// `_compact_stream_words`), and takes the place of the PyTorch mask select
// lanes[arange(256) < sizes[:, None]] (engine/device_stream.py::
// compact_chunks_plain, still the plain version): on 8 x 1920x1088 frames a
// 100 MB mask, a count and select of its ones into 2-D int64 indices, and a
// gather through them.
//
// Contract: block b's first live[b] bytes of lane b (0 <= live[b] <= 256) go
// to out[ends[b] - live[b]:], where ends is the inclusive cumulative sum of
// live. Nothing else of out is written.
//
// What bounds it on the H100: bytes. It reads each block's count (4 B) and
// end (8 B), the 32-byte sectors that hold each lane's live bytes, and writes
// the live bytes once: at 8 x 1920x1088 q50 about 4.7 MB, 12.5 MB and
// 5.5 MB, some 7 us at 3.35 TB/s.
//
// What the design does about it: a warp takes a run of 32 consecutive
// blocks. Thread t loads block t's count and end (two coalesced loads); the
// warp then walks its blocks in rounds of 32 bytes, as many as its longest
// chunk needs (8 for a 255-byte chunk), and in round r thread t moves byte
// 32r + t of each block, so a block's bytes are read from one sector and
// written back to back. A block's count and start reach the warp by
// shuffles; the loads of kGroup blocks are issued before their stores, so
// kGroup reads a thread are in flight. No shared memory, no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 256;
constexpr int kGroup = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
compact_chunks_kernel(const uint8_t* __restrict__ lanes,
                      const int32_t* __restrict__ live,
                      const int64_t* __restrict__ ends, int64_t n,
                      uint8_t* __restrict__ out) {
  const int t = threadIdx.x & 31;
  const int64_t base =
      int64_t(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  int count = 0;
  long long start = 0;
  if (base + t < n) {
    count = live[base + t];
    start = ends[base + t] - count;
  }
  const int longest = __reduce_max_sync(kFull, count);
  for (int j = t; j - t < longest; j += 32) {
    for (int g = 0; g < 32; g += kGroup) {
      uint8_t v[kGroup];
      bool take[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        take[i] = j < __shfl_sync(kFull, count, g + i);
        v[i] = take[i] ? lanes[(base + g + i) * kLane + j] : 0;
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const long long at = __shfl_sync(kFull, start, g + i);
        if (take[i]) out[at + j] = v[i];
      }
    }
  }
}

}  // namespace

// lanes u8 [n, 256], live i32 [n] (each 0..256), ends i64 [n] (inclusive
// cumulative sum of live); output out u8 [ends[n - 1]]. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int myyuv_compact_chunks(const void* lanes, const void* live,
                                    const void* ends, int64_t n, void* out,
                                    void* stream) {
  if (n > 0)
    compact_chunks_kernel<<<unsigned((n + kThreads - 1) / kThreads),
                            kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(lanes),
        static_cast<const int32_t*>(live),
        static_cast<const int64_t*>(ends), n, static_cast<uint8_t*>(out));
  return int(cudaGetLastError());
}
