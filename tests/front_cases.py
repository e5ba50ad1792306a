"""The block sets that hold the lane-group encoder's front (its two sorting
networks, ``csrc/block_huffman.cuh`` stages 2-3) at its edges. The CPU tests
(``test_torch_entropy.py``: the plain encoder against native) and the
card's (``test_torch_gpu.py``: K5, K1 and K1's ``frontonly`` instance
against their plain versions) run the same sets. This module imports
nothing of JAX, so the card's tests can import it.

Each set is int16 [8, 64] row-major coefficient rows: two warps of the
encoders (4 blocks each), so every warp's blocks are the set's own.

* ``msg_len_<L>``: messages of exactly L positions, the last one nonzero,
  for L at each width of the value network and one past it; half on a
  small alphabet, half on the int16 range;
* ``distinct_64``: 64 distinct values;
* ``all_equal``: one value at all 64 positions, the int16 ends among them;
* ``tied_frequencies``: many symbols of one frequency (32 x 2, 16 x 4,
  frequencies alternating by value, ...): the stable weight order's ties;
* ``int16_ends_padded``: int16's least and greatest values as the last
  positions before the trimmed zeros, whose keys lie next to the
  networks' sentinel;
* ``mixed_warp``: warps whose four blocks have messages of 1, 64, 9 and 33
  positions.
"""

import numpy as np

from myyuv_tpu_torch.entropy.device import ZIGZAG

MSG_LENS = (1, 7, 8, 9, 16, 17, 32, 33, 63, 64)
FRONT_CASES = (*(f"msg_len_{n}" for n in MSG_LENS), "distinct_64",
               "all_equal", "tied_frequencies", "int16_ends_padded",
               "mixed_warp")
I16 = np.iinfo(np.int16)
NONZERO = np.concatenate([np.arange(I16.min, 0), np.arange(1, I16.max + 1)])


def rows(msgs) -> np.ndarray:
    """Zigzag messages (each of <= 64 positions) -> int16 [k, 64] rows."""
    out = np.zeros((len(msgs), 64), np.int64)
    for i, m in enumerate(msgs):
        out[i, ZIGZAG[:len(m)]] = m
    return out.astype(np.int16)


def message(rng: np.random.Generator, n: int, wide: bool) -> np.ndarray:
    """n positions, the last one nonzero: values in [-6, 6], or anywhere in
    the int16 range (``wide``)."""
    lo, hi = (I16.min, I16.max + 1) if wide else (-6, 7)
    m = rng.integers(lo, hi, n)
    while m[-1] == 0:
        m[-1] = rng.integers(lo, hi)
    return m


def tied(rng: np.random.Generator, freqs) -> np.ndarray:
    """A 64-position message of distinct random symbols, symbol i (in
    ascending value order) ``freqs[i]`` times, in random positions."""
    vals = np.sort(rng.choice(NONZERO[NONZERO.size // 2 - 2000:
                                      NONZERO.size // 2 + 2000],
                              len(freqs), replace=False))
    return rng.permutation(np.repeat(vals, freqs))


def front_blocks(rng: np.random.Generator, case: str) -> np.ndarray:
    """The block set ``case`` (one of ``FRONT_CASES``)."""
    if case.startswith("msg_len_"):
        n = int(case[len("msg_len_"):])
        return rows([message(rng, n, wide=i >= 4) for i in range(8)])
    if case == "distinct_64":
        msgs = [rng.choice(NONZERO, 64, replace=False) for _ in range(6)]
        msgs.append(rng.permutation(NONZERO[NONZERO.size // 2 - 32:
                                            NONZERO.size // 2 + 32]))
        msgs.append(rng.permutation(np.concatenate(
            [[I16.min, I16.max], np.arange(1, 63)])))
        return rows(msgs)
    if case == "all_equal":
        return rows([np.full(64, v) for v in (I16.min, I16.max, -1, 1, 7,
                                              -1024, 1023, 300)])
    if case == "tied_frequencies":
        return rows([tied(rng, f) for f in (
            [2] * 32, [4] * 16, [8] * 8, [3] * 21 + [1],
            [1, 3] * 16, [33] + [1] * 31, [10] * 6 + [4],
            [1] * 4 + [5] * 12)])
    if case == "int16_ends_padded":
        msgs = [[I16.max], [I16.min]]
        for n, last, other in ((8, I16.max, I16.min), (9, I16.min, I16.max),
                               (33, I16.max, I16.max), (33, I16.min, 0),
                               (63, I16.max, I16.min), (64, I16.min, 1)):
            m = message(rng, n, wide=False)
            m[rng.integers(0, n)] = other
            m[-1] = last
            msgs.append(m)
        return rows(msgs)
    if case == "mixed_warp":
        order = (1, 64, 9, 33, 33, 9, 64, 1)
        return rows([message(rng, n, wide=i % 2 == 1)
                     for i, n in enumerate(order)])
    raise ValueError(f"unknown front case {case!r}")


def message_lengths(case: str) -> list:
    """The message length of each block of ``case``."""
    if case.startswith("msg_len_"):
        return [int(case[len("msg_len_"):])] * 8
    if case in ("distinct_64", "all_equal", "tied_frequencies"):
        return [64] * 8
    if case == "int16_ends_padded":
        return [1, 1, 8, 9, 33, 33, 63, 64]
    if case == "mixed_warp":
        return [1, 64, 9, 33, 33, 9, 64, 1]
    raise ValueError(f"unknown front case {case!r}")
