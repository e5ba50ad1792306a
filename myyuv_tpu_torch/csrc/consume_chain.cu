// T6: the synthetic refill chain of a bit-window decoder, run for `steps`
// steps on each block against its table of `cw` 32-bit words. State per
// block: a 64-bit window (W0 high word, W1 low word), the count of valid
// bits in it (33 at the start) and the next word's index (0; W0 starts as
// word 0). A step shifts s = bits 28..30 of W0 out of the window; when 32
// or fewer valid bits are left it refills the next word (0 past the table)
// behind them. The block's output is W0 | W1 | valid | widx.
//
// Replaces the TPU kernel tools/exp_sublane.py::make_kernel (pallas_call
// :84), which measured whether packing 8 blocks' state per lane column
// ([8, TILE/8]) beats one block per lane ([1, TILE]). The port runs both of
// the tool's word-table layouts, so the two can be compared on the card:
//   rows = 1: words [cw, ncols], word w of block c at [w, c];
//   rows = 8: words [8 cw, ncols], word w of block (r, c) at [8 w + r, c];
// the output is [rows, ncols], block (r, c) at [r, c].
// The tool's shift helpers (_shl, _shr_l) lean on XLA's rule that a shift
// by 32 or more, or by a negative amount, gives 0; shl and shr_l spell those
// range checks out, since such a shift is undefined in C++.
//
// What bounds it on the H100: the integer operations the chain needs (6 a
// step, 9 a refill: 7.5e7 at the tool's 189,504 blocks x 64 steps, 2.2 us
// at 33.4e12 a second, the SMs' integer issue rate), not its bytes (the
// words the blocks read, fewer than two a block on the tool's table, and
// the output: 1.7 MB, 0.5 us at 3.35 TB/s); tools/exp_sublane.py counts
// both from the table.
// What the design does about it: one thread a block, its state in
// registers; neighbouring threads take neighbouring columns, so a warp's
// first table reads (and every read of warps in step) are coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// x << s, 0 for s < 0 or s >= 32 (tools/exp_sublane.py::_shl).
__device__ __forceinline__ uint32_t shl(uint32_t x, int s) {
  return s < 0 || s >= 32 ? 0u : x << s;
}

// The logical x >> s, x for s == 0, 0 for s < 0 or s >= 32
// (tools/exp_sublane.py::_shr_l).
__device__ __forceinline__ uint32_t shr_l(uint32_t x, int s) {
  return s < 0 || s >= 32 ? 0u : x >> s;
}

__global__ void __launch_bounds__(kThreads)
consume_chain_kernel(const int32_t* __restrict__ words, int rows,
                     int64_t ncols, int cw, int steps,
                     int32_t* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= rows * ncols) return;
  const int64_t r = i / ncols, c = i % ncols;
  // word w of this block: words[(rows * w + r) * ncols + c]
  const int32_t* tab = words + r * ncols + c;
  const int64_t stride = rows * ncols;
  uint32_t w0 = uint32_t(tab[0]), w1 = 0;
  int valid = 33, widx = 0;
  for (int t = 0; t < steps; ++t) {
    const int s = int(w0 >> 28) & 7;
    w0 = shl(w0, s) | shr_l(w1, 32 - s);
    w1 = shl(w1, s);
    valid -= s;
    if (valid <= 32) {
      const uint32_t v = widx < cw ? uint32_t(tab[widx * stride]) : 0u;
      w0 |= shr_l(v, valid);
      w1 |= shl(v, 32 - valid);
      valid += 32;
      ++widx;
    }
  }
  out[i] = int32_t(w0 | w1 | uint32_t(valid) | uint32_t(widx));
}

}  // namespace

// words i32 [rows * cw, ncols] (rows 1 or 8); output out i32 [rows, ncols].
// Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for another rows).
extern "C" int myyuv_consume_chain(const void* words, int64_t rows,
                                   int64_t ncols, int64_t cw, int64_t steps,
                                   void* out, void* stream) {
  if (rows != 1 && rows != 8) return int(cudaErrorInvalidValue);
  const int64_t n = rows * ncols;
  if (n > 0)
    consume_chain_kernel<<<unsigned((n + kThreads - 1) / kThreads), kThreads,
                           0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(words), int(rows), ncols, int(cw),
        int(steps), static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}
