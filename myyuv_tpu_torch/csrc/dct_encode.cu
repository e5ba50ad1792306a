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
// the work is two 8-term f32 chains per coefficient, then two sorting
// networks (the message's values, the symbols' weights) whose depth is set
// by the widest block of the warp (21 steps at 64 keys, none for a warp of
// one-symbol blocks), a merge of <= 63 sequential steps and bit packing.
// What the design does about it: a group of 8 lanes per block
// (block_huffman.cuh) spreads the transform (lane r computes row r of C . B
// and of the result in registers), the networks (keys in registers, the
// near steps within a lane, the far ones by shuffles), the code tables and
// the bit packing over its lanes; only the merge runs on one lane, and a
// warp keeps four merges side by side. Whatever is indexed by
// data lives in the group's shared-memory scratch, so nothing goes to local
// memory (ptxas: 0-byte stack frame); the lane leaves as 16-byte stores.
//
// The transform is K3's, block_dct.cuh::dct_quantize_group (the header
// states the exactness rules), and the stage after it is K5's, so
// K5(K3(x)) == K1(x). The kernel is dct_encode.cuh's template, instantiated
// here for the production body alone.

#include "dct_encode.cuh"

// y [h, w], u and v [h/2, w/2] u8 planes; qt f32 [3, 64] (Y, U, V tables);
// dct f32 [64]; outputs lanes u8 [N, 256] (16-byte aligned), sizes i32 [N],
// err i32 [N] with N = frame_blocks(h, w). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int myyuv_dct_encode(const void* y, const void* u, const void* v,
                                int64_t h, int64_t w, const void* qt,
                                const void* dct, void* lanes, void* sizes,
                                void* err, void* stream) {
  return myyuv::launch_dct_encode<myyuv::EncodePhase::kNone>(
      y, u, v, h, w, qt, dct, lanes, sizes, err, stream);
}
