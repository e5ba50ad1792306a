// T5: the decoder's tree stage alone. For N chunks of the on-disk stream:
// each block's tree symbols (the first 64, in canonical order), its code
// counts per length 1..8 and native decode_block's tree codes 1..4, 32
// blocks per warp.
//
// Replaces the TPU kernel myyuv_tpu/entropy/pallas_decode8.py::_tree_kernel8
// (body _tree_body :92) as tools/exp_r3stage.py calls it alone (jtree,
// :107) to time the decompress path's tree stage. The port keeps what it
// computes, not its layout: block-major rows instead of packed-8 windows,
// symbols sign-extended to int16 instead of paired 11-bit values, and
// native's error codes (as K6 returns them) instead of a flag that also
// marks a non-canonical group order. Its time beside K6's (tree + payload)
// and K2's (tree + payload + IDCT) splits the decoders' time by stage
// (myyuv_tpu_torch/tools/exp_r3stage.py).
//
// What bounds it on the H100: by count, memory traffic, dominated by its
// output (a 4032x3008 frame: the stream plus 3.4 MB of sizes and offsets
// in, 36.4 MB of symbols, 9.1 MB of counts and 1.1 MB of codes out, >= 15
// us at 3.35 TB/s); in practice the serial chain of tree-group headers
// each block walks (up to 85, each at a position the ones before it fix).
// What the design does about it: K6's staging and tree parse
// (block_huffman.cuh::stage_passes, parse_tree), so the two cannot differ:
// the warp stages its 32 chunks into shared memory with coalesced word
// loads, each lane walks one block's groups and writes its symbols into
// the block's row in shared memory (tree_symbols), and groups of 8 lanes
// store four blocks' 128-byte rows a round, 16 bytes a lane; the counts go
// out as 128 contiguous bytes a store. Nothing goes to local memory.

#include "block_huffman.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kDecodeBlocks)
huffman_tree_kernel(const uint8_t* __restrict__ content, int64_t content_len,
                    const int32_t* __restrict__ sizes,
                    const int64_t* __restrict__ offsets, int64_t n,
                    int16_t* __restrict__ symbols,
                    int32_t* __restrict__ counts,
                    int32_t* __restrict__ err) {
  __shared__ DecodeWarp d;
  const int64_t b0 = int64_t(blockIdx.x) * kDecodeBlocks;
  unsigned long long cnt8;
  const int e = tree_warp(d, content, content_len, sizes, offsets, b0, n,
                          cnt8);
  const int me = threadIdx.x, lane = me % kDecodeLanes;
  if (b0 + me < n) err[b0 + me] = e;
#pragma unroll
  for (int r = 0; r < kDecodeBlocks / 4; ++r) {  // four 128-byte rows a round
    const int blk = 4 * r + me / kDecodeLanes;
    const bool bad = __shfl_sync(kWarpMask, e, blk) != 0;
    if (b0 + blk < n)
      reinterpret_cast<uint4*>(symbols + (b0 + blk) * 64)[lane] =
          bad ? make_uint4(0, 0, 0, 0) : coef_row(d, blk, lane);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {  // 32 blocks x 8 counts, a word a lane
    const int i = 32 * r + me, blk = i / 8, len = i % 8;
    const unsigned long long c = __shfl_sync(kWarpMask, cnt8, blk);
    if (b0 + blk < n)
      counts[(b0 + blk) * 8 + len] = int(c >> (8 * len) & 0xFF);
  }
}

}  // namespace
}  // namespace myyuv

// content u8 [content_len] (the chunks back to back), sizes i32 [n] in
// 0..255, offsets i64 [n]; outputs symbols i16 [n, 64] (16-byte aligned),
// counts i32 [n, 8] and err i32 [n] (0 or native decode_block's code
// 1..4). Launches on `stream` and returns cudaGetLastError().
extern "C" int myyuv_huffman_tree(const void* content, int64_t content_len,
                                  const void* sizes, const void* offsets,
                                  int64_t n, void* symbols, void* counts,
                                  void* err, void* stream) {
  if (n > 0) {
    const int64_t grid = (n + myyuv::kDecodeBlocks - 1) / myyuv::kDecodeBlocks;
    myyuv::huffman_tree_kernel<<<unsigned(grid), myyuv::kDecodeBlocks, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(content), content_len,
        static_cast<const int32_t*>(sizes),
        static_cast<const int64_t*>(offsets), n,
        static_cast<int16_t*>(symbols), static_cast<int32_t*>(counts),
        static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}
