"""Format-defining numerical constants: the codec's "weights".

Port of ``myyuv_tpu/kernels/constants.py``. These values are part of the
``.myyuv`` DCT codec's numerical contract and must match the reference bit
for bit:

* ``DCT_MATRIX8`` — the reference hardcodes a float32 orthonormal DCT-II
  matrix (DCT.cpp:221-230) whose entries are NOT the correctly-rounded
  float32 cosines, so the 64 exact values are embedded, not regenerated.
* ``LUM_Q50`` / ``CHROMA_Q50`` — the JPEG Annex-K quality-50 tables
  (DCT.cpp:199-219; ITU-T T.81 Tables K.1/K.2).
* ``quality_scaled_qtable`` — the quality->table rule (DCT.cpp:286-290):
  mul = (100-q)/50 if q >= 50.5 else 50/q, entries rounded half away and
  clamped to [1, 255], all in float32.

The tables stay numpy here; ``engine.pipeline.codec_params`` turns them
into tensors on the device a call names.
"""

from __future__ import annotations

import numpy as np

DCT_MATRIX8 = np.array([
    [0.3535533845424652, 0.3535533845424652, 0.3535533845424652,
     0.3535533845424652, 0.3535533845424652, 0.3535533845424652,
     0.3535533845424652, 0.3535533845424652],
    [0.4903925955295563, 0.4157347679138184, 0.277785062789917,
     0.09754510968923569, -0.09754515439271927, -0.2777851521968842,
     -0.4157347977161407, -0.4903926253318787],
    [0.4619397222995758, 0.1913416981697083, -0.1913417428731918,
     -0.4619397819042206, -0.4619397222995758, -0.1913415491580963,
     0.1913417875766754, 0.4619397521018982],
    [0.4157347679138184, -0.09754515439271927, -0.4903926253318787,
     -0.2777849733829498, 0.2777851819992065, 0.4903925955295563,
     0.09754502773284912, -0.4157348573207855],
    [0.3535533547401428, -0.3535533547401428, -0.353553295135498,
     0.3535534739494324, 0.3535533547401428, -0.3535535931587219,
     -0.3535532355308533, 0.3535533845424652],
    [0.277785062789917, -0.4903926253318787, 0.09754519909620285,
     0.4157346487045288, -0.4157348573207855, -0.09754510223865509,
     0.4903926253318787, -0.2777853906154633],
    [0.1913416981697083, -0.4619397222995758, 0.4619397521018982,
     -0.1913419365882874, -0.1913414746522903, 0.4619396328926086,
     -0.4619398415088654, 0.1913419365882874],
    [0.09754510968923569, -0.2777849733829498, 0.4157346487045288,
     -0.4903925657272339, 0.4903926849365234, -0.4157347679138184,
     0.2777855396270752, -0.09754576534032822],
], dtype=np.float32)

LUM_Q50 = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)

CHROMA_Q50 = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.float32)

# q-50 base table per plane index (Y, U, V) — DCT.cpp:397,459
PLANE_Q50 = (LUM_Q50, CHROMA_Q50, CHROMA_Q50)


def quality_scaled_qtable(q50_table: np.ndarray, quality: int) -> np.ndarray:
    """Quality-scaled quantization table, float32 (DCT.cpp:286-290).

    Entries are positive, so np.floor(x + 0.5) is round-half-away here.
    """
    q = np.float32(quality)
    mul = (np.float32(100) - q) / np.float32(50) if q >= np.float32(50.5) \
        else np.float32(50) / q
    scaled = q50_table.astype(np.float32) * mul
    rounded = np.floor(scaled + np.float32(0.5)).astype(np.float32)
    return np.clip(rounded, np.float32(1), np.float32(255))
