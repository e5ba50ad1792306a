// K1's kernel and its launcher, a template on the encoder stage it leaves
// out (block_huffman.cuh::EncodePhase): dct_encode.cu instantiates the
// production body (EncodePhase::kNone) and nothing else,
// dct_encode_phases.cu the measurement instances. A template kernel is
// compiled only where it is instantiated, so neither library holds the
// other's instances.
#pragma once

#include "block_dct.cuh"
#include "block_huffman.cuh"

namespace myyuv {

template <EncodePhase kSkip>
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
  encode_group_to_lane<kSkip>(s, lane, active, b, lanes, sizes, err);
}

// Launches the kSkip instance over the frame's blocks on `stream`; returns
// cudaGetLastError().
template <EncodePhase kSkip>
int launch_dct_encode(const void* y, const void* u, const void* v, int64_t h,
                      int64_t w, const void* qt, const void* dct, void* lanes,
                      void* sizes, void* err, void* stream) {
  const int64_t n = frame_blocks(h, w);
  if (n > 0) {
    const int64_t grid = (n + kEncodeGroups - 1) / kEncodeGroups;
    dct_encode_kernel<kSkip><<<unsigned(grid), kEncodeThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
        static_cast<const uint8_t*>(v), int(h), int(w),
        static_cast<const float*>(qt), static_cast<const float*>(dct),
        static_cast<uint8_t*>(lanes), static_cast<int32_t*>(sizes),
        static_cast<int32_t*>(err));
  }
  return int(cudaGetLastError());
}

}  // namespace myyuv
