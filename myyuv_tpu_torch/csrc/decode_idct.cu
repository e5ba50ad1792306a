// K2: fused canonical Huffman decode + dequantize + IDCT, one thread per 8x8
// block, reading the on-disk chunk stream as the file holds it.
//
// Replaces the TPU kernel
// myyuv_tpu/entropy/pallas_decode8.py::_fused_decode_idct_kernel8 (launched by
// _decode8_idct_fused_raw / decode_idct_words8_split_fused), whose body is
// _tree_body + _payload_body + kernels/pallas_dct8.py::_idct_words. The port
// keeps what it computes, not its layout: no packed-8 W0/Wc windows, no host
// expand_split step, no continuation tiers. The per-block code is a direct
// port of myyuv_tpu/native/entropy.cpp (decode_block :245,
// dequantize_idct_block :459), so it accepts exactly what the host decoder
// accepts and returns its error codes 1..8.
//
// What bounds it on the H100: per-thread latency. Each thread copies its
// chunk (3..255 bytes at a device-computed offset) into a local 256-byte
// lane, parses the tree into a [9][64] symbol table (~1.2 KB of local
// memory), walks the canonical code one bit at a time, then runs two 8-term
// f32 chains per pixel. Dependent instructions and local-memory traffic
// dominate; HBM traffic is small (a 4032x3008 frame reads ~4-10 MB of chunks
// and writes ~18 MB of planes).
// What the design does about it: 284k independent threads per 4K frame keep
// the schedulers fed while others wait; chunk bytes are read once from HBM;
// tables are shared memory; planes are written straight into [H, W] layout,
// so nothing follows the kernel. Shortening the per-thread machine (a table
// decode instead of the bit walk, warp-cooperative parsing) is later work.
//
// It is K6's stage (block_huffman.cuh) followed by K4's (block_dct.cuh)
// with the coefficients kept in the thread's local memory; the exactness
// rules are stated in block_dct.cuh.

#include "block_dct.cuh"
#include "block_huffman.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kThreads)
decode_idct_kernel(const uint8_t* __restrict__ content, int64_t content_len,
                   const int32_t* __restrict__ sizes,
                   const int64_t* __restrict__ offsets, int h, int w,
                   const float* __restrict__ qt, const float* __restrict__ dct,
                   uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                   uint8_t* __restrict__ v, int32_t* __restrict__ err) {
  __shared__ CodecParams prm;
  load_params(prm, dct, qt);
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= frame_blocks(h, w)) return;
  const BlockLoc loc = locate_block(b, h, w);
  uint8_t* px = (loc.plane == 0 ? y : loc.plane == 1 ? u : v) + loc.offset;

  int16_t coef[64];
  const int e = decode_chunk(content, content_len, sizes[b], offsets[b], coef);
  err[b] = e;
  if (e != 0)  // a bad block's pixels are 0
    zero_block(px, loc.stride);
  else
    dequantize_idct_block(coef, prm.c, prm.q + 64 * loc.plane, px,
                          loc.stride);
}

}  // namespace
}  // namespace myyuv

// content u8 [content_len] (the file's chunk bytes back to back), sizes i32
// [N] in 0..255, offsets i64 [N] (exclusive prefix sum of sizes); qt f32
// [3, 64]; dct f32 [64]; outputs y [h, w], u and v [h/2, w/2] u8 planes and
// err i32 [N]. Launches on `stream` and returns cudaGetLastError().
extern "C" int myyuv_decode_idct(const void* content, int64_t content_len,
                                 const void* sizes, const void* offsets,
                                 int64_t h, int64_t w,
                                 const void* qt, const void* dct, void* y,
                                 void* u, void* v, void* err, void* stream) {
  const int64_t n = myyuv::frame_blocks(h, w);
  if (n > 0) {
    const int64_t grid = (n + myyuv::kThreads - 1) / myyuv::kThreads;
    myyuv::decode_idct_kernel<<<unsigned(grid), myyuv::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(content), content_len,
        static_cast<const int32_t*>(sizes),
        static_cast<const int64_t*>(offsets), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<uint8_t*>(y), static_cast<uint8_t*>(u),
        static_cast<uint8_t*>(v), static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}
