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
// Exactness: every product and sum of the DCT chains is __fmul_rn/__fadd_rn,
// k ascending, the first product not added to 0 (and the build passes
// -fmad=false); quantize is roundf(__fdiv_rn(coef, q)), IEEE division and
// half-away rounding, as int16(std::round(coef / q)) in DCT.cpp:273.

#include "codec_common.cuh"

namespace myyuv {
namespace {

constexpr int kOutWords = 72;  // a chunk is < 180 bytes for 11-bit symbols

__device__ __forceinline__ void put_bits(uint32_t* w, int bitpos, uint32_t v,
                                         int nbits) {
  const int i = bitpos >> 5, sh = bitpos & 31;
  w[i] |= v << sh;
  if (sh + nbits > 32) w[i + 1] |= v >> (32 - sh);
}

// Optimal code lengths for n symbols of weights w (entropy.cpp:85): stable
// sort by weight, two-queue merge where a leaf wins a tie, depths by a sweep
// over node ids descending (ids 0..n-1 sorted leaves, n.. internal nodes).
__device__ void huffman_lengths(const uint8_t* w, int n, uint8_t* len_out) {
  if (n == 1) {
    len_out[0] = 1;
    return;
  }
  uint8_t order[64];
  for (int i = 0; i < n; ++i) {  // stable insertion sort by weight
    int j = i;
    while (j > 0 && w[order[j - 1]] > w[i]) {
      order[j] = order[j - 1];
      --j;
    }
    order[j] = uint8_t(i);
  }
  uint8_t leafw[64], intw[64], parent[128], depth[128];
  for (int i = 0; i < n; ++i) leafw[i] = w[order[i]];
  int lh = 0, ih = 0, it = 0;
  for (int m = 0; m < n - 1; ++m) {
    int picks[2], wsum = 0;
    for (int p = 0; p < 2; ++p) {
      const bool take_leaf = lh < n && (ih >= it || leafw[lh] <= intw[ih]);
      if (take_leaf) {
        wsum += leafw[lh];
        picks[p] = lh++;
      } else {
        wsum += intw[ih];
        picks[p] = n + ih++;
      }
    }
    intw[it] = uint8_t(wsum);  // total weight <= 64
    parent[picks[0]] = parent[picks[1]] = uint8_t(n + it);
    ++it;
  }
  depth[n + it - 1] = 0;
  for (int id = n + it - 2; id >= 0; --id) depth[id] = depth[parent[id]] + 1;
  for (int i = 0; i < n; ++i) len_out[order[i]] = depth[i];
}

// One block's chunk into out[0..kOutWords) (zeroed here); returns its size in
// bytes (entropy.cpp:134).
__device__ int encode_block(const int16_t* coef, uint32_t* out) {
  int16_t msg[64];
  int msg_len = 0;
  for (int i = 0; i < 64; ++i) {
    msg[i] = coef[kZigzag[i]];
    if (msg[i] != 0) msg_len = i + 1;
  }
  if (msg_len == 0) msg_len = 1;  // all-zero block -> one 0 symbol

  // distinct symbols ascending with their frequencies
  int16_t srt[64];
  for (int i = 0; i < msg_len; ++i) {
    const int16_t v = msg[i];
    int j = i;
    while (j > 0 && srt[j - 1] > v) {
      srt[j] = srt[j - 1];
      --j;
    }
    srt[j] = v;
  }
  int16_t syms[64];
  uint8_t freq[64];
  int n_sym = 0;
  for (int i = 0; i < msg_len; ++i) {
    if (n_sym == 0 || srt[i] != syms[n_sym - 1]) {
      syms[n_sym] = srt[i];
      freq[n_sym] = 1;
      ++n_sym;
    } else {
      ++freq[n_sym - 1];
    }
  }

  uint8_t lens[64];
  huffman_lengths(freq, n_sym, lens);

  // canonical order: stable by length (syms is already symbol-ascending)
  uint8_t corder[64];
  for (int i = 0; i < n_sym; ++i) {
    int j = i;
    while (j > 0 && lens[corder[j - 1]] > lens[i]) {
      corder[j] = corder[j - 1];
      --j;
    }
    corder[j] = uint8_t(i);
  }
  uint8_t code_val[64];
  {
    uint32_t code = 0;
    int prev_len = 0;
    for (int i = 0; i < n_sym; ++i) {
      const int s = corder[i];
      code <<= (lens[s] - prev_len);
      prev_len = lens[s];
      code_val[s] = uint8_t(code);
      ++code;
    }
  }
  int enc_bits = 0;
  for (int i = 0; i < n_sym; ++i) enc_bits += freq[i] * lens[i];

  // serialize: u16 enc_bits, u8 tree_size, tree groups, payload
  for (int i = 0; i < kOutWords; ++i) out[i] = 0;
  put_bits(out, 0, uint32_t(enc_bits) & 0xFFFFu, 16);
  int pos = 3;
  for (int i = 0; i < n_sym;) {
    const int len = lens[corder[i]];
    int run_end = i;
    while (run_end < n_sym && lens[corder[run_end]] == len) ++run_end;
    for (int start = i; start < run_end; start += 32) {
      const int cnt = min(32, run_end - start);
      put_bits(out, pos * 8, uint32_t(((len - 1) << 5) | (cnt - 1)), 8);
      ++pos;
      for (int k = 0; k < cnt; ++k)  // 11-bit two's complement, LSB first
        put_bits(out, pos * 8 + 11 * k,
                 uint32_t(int(syms[corder[start + k]]) & 0x7FF), 11);
      pos += (cnt * 11 + 7) / 8;
    }
    i = run_end;
  }
  put_bits(out, 16, uint32_t(pos - 3) & 0xFFu, 8);

  // payload: each code MSB-first in stream order
  int bit = pos * 8;
  for (int i = 0; i < msg_len; ++i) {
    int lo = 0, hi = n_sym - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (syms[mid] < msg[i]) lo = mid + 1; else hi = mid;
    }
    const int len = lens[lo];
    put_bits(out, bit, __brev(uint32_t(code_val[lo])) >> (32 - len), len);
    bit += len;
  }
  return pos + (enc_bits + 7) / 8;
}

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
  const float* q = prm.q + 64 * loc.plane;

  float x[64];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j)
      x[i * 8 + j] = float(px[int64_t(i) * loc.stride + j]) - 128.0f;  // exact
  float t[64];  // C . B
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(prm.c[i * 8], x[j]);
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(prm.c[i * 8 + k], x[k * 8 + j]));
      t[i * 8 + j] = acc;
    }
  int16_t coef[64];  // (C . B) . C^T, quantized
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      float acc = __fmul_rn(t[i * 8], prm.c[j * 8]);
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(t[i * 8 + k], prm.c[j * 8 + k]));
      coef[i * 8 + j] = int16_t(int(roundf(__fdiv_rn(acc, q[i * 8 + j]))));
    }

  uint32_t out[kOutWords];
  const int size = encode_block(coef, out);
  const bool bad = size > 255;  // the u8 size field cannot hold it
  sizes[b] = size;
  err[b] = bad ? 1 : 0;
  uint4* dst = reinterpret_cast<uint4*>(lanes + b * 4 * kLaneWords);
  for (int k = 0; k < kLaneWords / 4; ++k)
    dst[k] = bad ? make_uint4(0, 0, 0, 0)
                 : make_uint4(out[4 * k], out[4 * k + 1], out[4 * k + 2],
                              out[4 * k + 3]);
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
