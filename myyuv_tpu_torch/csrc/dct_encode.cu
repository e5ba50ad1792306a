// K1: fused DCT + quantize + canonical Huffman encode, one 8x8 block per
// group of kEncodeLanes = 8 lanes.
//
// Replaces the TPU kernel myyuv_tpu/entropy/pallas_encode8.py::_dct_encode_kernel8
// (launched by dct_encode_words_packed), whose body is
// kernels/pallas_dct8.py::_dctq_pairs followed by _encode_body. The port keeps
// what it computes, not its layout: no packed-8 lane columns, no bit-reversed
// A/C word regions, no continuation-word tiers, no bitonic/one-hot register
// machine. Its bytes are those of myyuv_tpu/native/entropy.cpp
// (dct_quantize_block :447, encode_block :134, huffman_lengths :85).
//
// What bounds it on the H100: latency of the per-block work, not HBM. A
// 4032x3008 frame is 284,256 blocks: ~18 MB of planes in, ~2.5 MB of chunk
// bytes (in 73 MB of 256-byte lanes) out, which the card moves in ~30 us;
// the work is two 8-term f32 chains per coefficient, then O(msg_len *
// n_sym) lookups, O(n_sym^2) rank counts, a merge of <= 63 sequential steps
// and bit packing, whose cost depends on the block's content.
// What the design does about it: a group of 8 lanes per block
// (block_huffman.cuh) spreads the transform (lane r computes row r of C . B
// and of the result in registers), the ranks, the code tables and the bit
// packing over its lanes; only the merge runs on one lane, and a warp keeps
// four merges side by side. Whatever is indexed by
// data lives in the group's shared-memory scratch, so nothing goes to local
// memory (ptxas: 0-byte stack frame); the lane leaves as 16-byte stores.
//
// The transform is K3's, block_dct.cuh::dct_quantize_group (the header
// states the exactness rules), and the stage after it is K5's, so
// K5(K3(x)) == K1(x).

#include "block_dct.cuh"
#include "block_huffman.cuh"

namespace myyuv {
namespace {

__global__ void __launch_bounds__(kEncodeThreads, kEncodeMinCtas)
dct_encode_kernel(const uint8_t* __restrict__ y, const uint8_t* __restrict__ u,
                  const uint8_t* __restrict__ v, int h, int w,
                  const float* __restrict__ qt, const float* __restrict__ dct,
                  uint8_t* __restrict__ lanes, int32_t* __restrict__ sizes,
                  int32_t* __restrict__ err) {
  __shared__ __align__(16) CodecParams prm;  // read as float4
  __shared__ uint8_t izz[64];
  __shared__ EncodeScratch scratch[kEncodeGroups];
  load_inverse_zigzag(izz);
  load_params(prm, dct, qt);  // synchronises the CTA
  const int lane = threadIdx.x % kEncodeLanes;
  EncodeScratch& s = scratch[threadIdx.x / kEncodeLanes];
  const int64_t b =
      int64_t(blockIdx.x) * kEncodeGroups + threadIdx.x / kEncodeLanes;
  const bool active = b < frame_blocks(h, w);
  const BlockLoc loc = locate_block(active ? b : 0, h, w);
  const uint8_t* px = (loc.plane == 0 ? y : loc.plane == 1 ? u : v) + loc.offset;
  int16_t coef[8];  // row `lane` of the block
  dct_quantize_group(load_pixel_row(px, loc.stride, active, lane), prm.c,
                     prm.q + 64 * loc.plane, s.pixels, lane, coef);
#pragma unroll
  for (int k = 0; k < 8; ++k) s.msg[izz[lane * 8 + k]] = coef[k];
  __syncwarp();
  encode_group_to_lane(s, lane, active, b, lanes, sizes, err);
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
    const int64_t grid = (n + myyuv::kEncodeGroups - 1) / myyuv::kEncodeGroups;
    myyuv::dct_encode_kernel<<<unsigned(grid), myyuv::kEncodeThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<uint8_t*>(lanes), static_cast<int32_t*>(sizes),
        static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}
