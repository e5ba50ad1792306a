// K1: fused DCT + quantize + canonical Huffman encode, one thread per 8x8 block.
//
// Replaces the TPU kernel myyuv_tpu/entropy/pallas_encode8.py::_dct_encode_kernel8
// (launched by dct_encode_words_packed), whose body is
// kernels/pallas_dct8.py::_dctq_pairs followed by _encode_body. The port keeps
// what it computes, not its layout: no packed-8 lane columns, no bit-reversed
// A/C word regions, no continuation-word tiers, no bitonic/one-hot register
// machine. The per-block code is a direct port of the scalar routines in
// myyuv_tpu/native/entropy.cpp (dct_quantize_block :447, encode_block :134,
// huffman_lengths :85), whose bytes this kernel reproduces exactly.
//
// What bounds it on the H100: per-thread latency. Each thread runs a
// sequential, data-dependent machine (two 8-term f32 chains per coefficient,
// three insertion sorts of <= 64 entries, a two-queue merge, bit packing) on
// ~1 KB of per-block arrays that live in local memory, so the time goes to
// dependent instructions and local-memory traffic (L1-cached), not to HBM: a
// 4032x3008 frame is 284,256 blocks, ~18 MB of planes in and ~73 MB of
// 256-byte lanes out, which the card moves in ~30 us.
// What the design does about it: one thread per block gives 284k independent
// threads, enough to keep every SM's warp schedulers fed while others wait on
// local memory; the DCT matrix and tables sit in shared memory; each lane is
// written as 16 aligned 16-byte stores. Making the machine itself shorter is
// later work.
//
// It is K3's stage (block_dct.cuh) followed by K5's (block_huffman.cuh)
// with the coefficients kept in the thread's local memory; the exactness
// rules are stated in block_dct.cuh.

#include "block_dct.cuh"
#include "block_huffman.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kThreads)
dct_encode_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
                  const uint8_t* __restrict__ v, int h, int w,
                  const float* __restrict__ qt, const float* __restrict__ dct,
                  uint8_t* __restrict__ lanes, int32_t* __restrict__ sizes,
                  int32_t* __restrict__ err) {
  __shared__ CodecParams prm;
  load_params(prm, dct, qt);
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= frame_blocks(h, w)) return;
  const BlockLoc loc = locate_block(b, h, w);
  const uint8_t* px = (loc.plane == 0 ? y : loc.plane == 1 ? u : v) + loc.offset;
  int16_t coef[64];
  dct_quantize_block(px, loc.stride, prm.c, prm.q + 64 * loc.plane, coef);
  encode_to_lane(coef, b, lanes, sizes, err);
}

}  // namespace
}  // namespace myyuv

// y [h, w], u and v [h/2, w/2] u8 planes; qt f32 [3, 64] (Y, U, V tables);
// dct f32 [64]; outputs lanes u8 [N, 256] (16-byte aligned), sizes i32 [N],
// err i32 [N] with N = frame_blocks(h, w). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int myyuv_dct_encode(const void* y, const void* u, const void* v,
                                int64_t h, int64_t w, const void* qt,
                                const void* dct, void* lanes, void* sizes,
                                void* err, void* stream) {
  const int64_t n = myyuv::frame_blocks(h, w);
  if (n > 0) {
    const int64_t grid = (n + myyuv::kThreads - 1) / myyuv::kThreads;
    myyuv::dct_encode_kernel<<<unsigned(grid), myyuv::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<uint8_t*>(lanes), static_cast<int32_t*>(sizes),
        static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}
