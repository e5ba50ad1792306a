// K1's measurement instances: K1 (dct_encode.cuh's kernel) with one stage of
// its encoder left out, for tools/exp_encphase.py's time split; the time of
// K1 less that of an instance is the stage's time.
//
// Replaces the `ablate` bodies of the TPU kernel
// myyuv_tpu/entropy/pallas_encode8.py::_dct_encode_kernel8 (:609, launched by
// dct_encode_words_packed :640 with ablate != ""; the bodies are
// _encode_body's branches :158-172): "frontonly" (:237-243), "merge"
// (:348-352), "groups" (:393-397), "lut" (:480-482) and "serial" (:533-537),
// by what each stage computes (block_huffman.cuh::EncodePhase names the
// stage and its stand-in). JAX's "cansort" (:362-363) has no counterpart:
// the port takes the canonical order from popcount ranks of per-length
// masks and runs no sort to leave out.
//
// What bounds it on the H100: as K1, the latency of the per-block work; an
// instance moves K1's bytes (the planes in, the 256-byte lanes, sizes and
// err out) and runs K1's DCT. Its design is K1's: only the stage left out
// differs, so every loop bound, tensor shape and launch shape is K1's.

#include "dct_encode.cuh"

// K1's arguments (dct_encode.cu) and `variant`, 1..5: frontonly, merge,
// groups, lut, serial (EncodePhase). Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for another variant.
extern "C" int myyuv_dct_encode_phases(const void* y, const void* u,
                                       const void* v, int64_t h, int64_t w,
                                       const void* qt, const void* dct,
                                       void* lanes, void* sizes, void* err,
                                       int64_t variant, void* stream) {
  using myyuv::EncodePhase;
  using myyuv::launch_dct_encode;
  switch (variant) {
    case int64_t(EncodePhase::kFrontOnly):
      return launch_dct_encode<EncodePhase::kFrontOnly>(
          y, u, v, h, w, qt, dct, lanes, sizes, err, stream);
    case int64_t(EncodePhase::kMerge):
      return launch_dct_encode<EncodePhase::kMerge>(
          y, u, v, h, w, qt, dct, lanes, sizes, err, stream);
    case int64_t(EncodePhase::kGroups):
      return launch_dct_encode<EncodePhase::kGroups>(
          y, u, v, h, w, qt, dct, lanes, sizes, err, stream);
    case int64_t(EncodePhase::kLut):
      return launch_dct_encode<EncodePhase::kLut>(
          y, u, v, h, w, qt, dct, lanes, sizes, err, stream);
    case int64_t(EncodePhase::kSerial):
      return launch_dct_encode<EncodePhase::kSerial>(
          y, u, v, h, w, qt, dct, lanes, sizes, err, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}
