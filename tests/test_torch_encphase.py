"""K1's measurement instances on the CPU: ``encode.dct_encode_phase`` (the
port of ``pallas_encode8.dct_encode_words_packed(..., ablate=...)``),
whose wrapper runs the plain versions here (``entropy/device.py::
encode_lanes``, ``skip``), and the encoder tools ``exp_encphase`` and
``exp_encsplit``.

* ``frontonly``'s sizes (n_sym a block) against the JAX kernel's
  ``ablate="frontonly"``, run in Pallas interpret mode on the inputs
  ``tools/exp_encphase.py`` builds (:87-101; one tile of 8 lane columns),
  on the blocks where the same call's full body (``ablate=""``) gives the
  exact encoder's chunk: interpret mode is no exact DCT oracle (CPU XLA
  may contract the DCT chains). On this test's frame that is all 48
  blocks. And against the number of distinct symbols of
  ``myyuv_tpu/entropy/reference.py`` on ``kernels/scalar.py``'s
  coefficients, on every block.
* ``merge``'s stream (a fixed-length code) decodes to the exact
  coefficients, by the port's plain decoder and by ``reference.py``.
* every instance: deterministic, with K1's output shapes and dtypes, and
  its output what its stand-in makes of K1's
  (``exp_encphase.stand_in_holds``).
* the tools' checks on the CPU, ``exp_encphase``'s ``--quality`` and its
  ``front_widths`` (a warp's network widths from its widest block); unknown
  variants and devices raise.

Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myyuv_tpu import native
from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import device_stream as jax_ds
from myyuv_tpu.entropy import pallas_encode8 as pe8
from myyuv_tpu.entropy import reference
from myyuv_tpu.kernels import pallas_dct8 as p8
from myyuv_tpu.kernels import scalar
from myyuv_tpu_torch.engine import pipeline
from myyuv_tpu_torch.entropy import device as edev
from myyuv_tpu_torch.entropy import encode
from myyuv_tpu_torch.kernels import probe
from myyuv_tpu_torch.tools import common, exp_encphase, exp_encsplit

import front_cases

H, W = 32, 64
TILE = 8


def _frame(rng):
    """A smooth luma plane with noise on it and two noise chroma planes."""
    base = np.add.outer(np.arange(H) * 3, np.arange(W) * 2) % 200
    y = (base + rng.integers(0, 40, (H, W))).astype(np.uint8)
    u = rng.integers(90, 170, (H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    return y, u, v


def _exact_coeffs(planes, q):
    """kernels/scalar.py's coefficients [N, 64], Y then U then V blocks."""
    return np.concatenate([
        scalar.dct_quantize_blocks(scalar.plane_to_blocks(p),
                                   scalar.plane_qtable(i, q)).reshape(-1, 64)
        for i, p in enumerate(planes)])


def _torch(planes, q):
    """(y, u, v, qtables, dct) tensors of a q frame on the CPU."""
    dct, qt = pipeline.codec_params([q] * 3, "cpu")
    return (*(torch.from_numpy(p) for p in planes), qt, dct)


def _jax_words(planes, q, ablate):
    """dct_encode_words_packed in interpret mode on tools/exp_encphase.py's
    inputs (:87-101) with one tile of 8 lane columns, continuation words
    enough for every chunk -> (C, A, sizes, ok) over the frame's blocks."""
    ny = (H // 8) * (W // 8)
    nc = (H // 16) * (W // 16)
    n = ny + 2 * nc
    xw = jnp.concatenate([p8.pack_pixel_words(jnp.asarray(p))
                          for p in planes], axis=1)
    padc = (-(n // 8)) % TILE
    xw = jnp.concatenate([xw, jnp.zeros((128, padc), jnp.int32)], axis=1)
    qtx = p8.expand_qtables(tuple(jax_batch.plane_qtables([q] * 3)))
    pids = p8.plane_pids(ny, nc, xw.shape[1] - n // 8)
    C, A, sizes, ok = pe8.dct_encode_words_packed(
        xw, qtx, pids, cont=jax_ds.CONT_ROOMY, interpret=True, tile=TILE,
        ablate=ablate)
    return C, A, sizes[:n], np.asarray(ok)[:n]


def test_frontonly_sizes_match_jax_interpret_and_reference(rng):
    planes = _frame(rng)
    coeffs = _exact_coeffs(planes, 50)
    n = coeffs.shape[0]
    n_sym = np.array([sum(len(s) for s in
                          reference.block_tree_data(c).values())
                      for c in coeffs], np.int32)
    lanes, sizes, err = encode.dct_encode_phase(*_torch(planes, 50),
                                                "frontonly")
    np.testing.assert_array_equal(sizes.numpy(), n_sym)
    assert not lanes.any() and not err.any()

    # the blocks whose full JAX chunk is the exact encoder's
    C, A, full_sizes, full_ok = _jax_words(planes, 50, "")
    full_sizes = np.asarray(full_sizes).astype(np.int32)
    content = jax_ds._pull_packed_stream(A, C, full_sizes, full_sizes)
    want_sizes, want = native.encode_blocks(coeffs)
    ends = np.cumsum(full_sizes)
    want_ends = np.cumsum(want_sizes.astype(np.int64))
    same = np.array([
        full_ok[b] and full_sizes[b] == want_sizes[b]
        and np.array_equal(content[ends[b] - full_sizes[b]:ends[b]],
                           want[want_ends[b] - want_sizes[b]:want_ends[b]])
        for b in range(n)])
    assert same.sum() == n == 48
    _, _, front_sizes, front_ok = _jax_words(planes, 50, "frontonly")
    assert front_ok.all()
    np.testing.assert_array_equal(np.asarray(front_sizes)[same],
                                  sizes.numpy()[same])


@pytest.mark.parametrize("q", [1, 10, 50, 90, 100])
def test_frontonly_sizes_equal_reference_symbol_counts(rng, q):
    planes = _frame(rng)
    n_sym = [sum(len(s) for s in reference.block_tree_data(c).values())
             for c in _exact_coeffs(planes, q)]
    _, sizes, _ = encode.dct_encode_phase(*_torch(planes, q), "frontonly")
    assert sizes.tolist() == n_sym


@pytest.mark.parametrize("q", [1, 10, 50, 90, 100])
def test_merge_stream_decodes_to_exact_coefficients(rng, q):
    planes = _frame(rng)
    coeffs = _exact_coeffs(planes, q)
    lanes, sizes, err = encode.dct_encode_phase(*_torch(planes, q), "merge")
    assert not err.any()
    back, derr = edev.decode_lanes(lanes, sizes)
    assert not derr.any()
    np.testing.assert_array_equal(back.numpy(), coeffs)
    for b in range(0, coeffs.shape[0], 7):
        chunk = lanes[b, :int(sizes[b])].numpy().tobytes()
        np.testing.assert_array_equal(
            np.asarray(reference.decode_block(chunk)).reshape(64),
            coeffs[b])


@pytest.mark.parametrize("variant", encode.PHASE_VARIANTS)
@pytest.mark.parametrize("q", [10, 50, 90])
def test_variant_is_deterministic_with_k1_shapes_and_stand_in(rng, variant,
                                                              q):
    frame = _frame(rng)
    args = _torch(frame, q)
    full = encode.dct_encode_blocks(*args)
    got = encode.dct_encode_phase(*args, variant)
    again = encode.dct_encode_phase(*args, variant)
    for g, a, f in zip(got, again, full):
        assert torch.equal(g, a)
        assert g.shape == f.shape and g.dtype == f.dtype
    coeffs = torch.from_numpy(_exact_coeffs(frame, q))
    assert exp_encphase.stand_in_holds(variant, got, full, coeffs)
    assert torch.equal(got[0], encode.dct_encode_phase_plain(
        *args, variant)[0])


def test_stand_ins_hold_on_the_encoder_families():
    """The stand-ins on the families that stress the lane-group encoder
    (one symbol, 64 symbols, two tree groups, ties, int16 symbols stored
    as 11 bits), coded from their coefficients."""
    rows = np.concatenate(list(probe.encoder_families(
        np.random.default_rng(7)).values()))
    coeffs = torch.from_numpy(rows)
    full = edev.encode_lanes(coeffs)
    for variant in encode.PHASE_VARIANTS:
        got = edev.encode_lanes(coeffs, skip=variant)
        assert exp_encphase.stand_in_holds(variant, got, full,
                                           coeffs), variant


def test_message_stats_match_reference(rng):
    coeffs = _exact_coeffs(_frame(rng), 90)
    mlen, n_sym = exp_encphase.message_stats(torch.from_numpy(coeffs))
    assert mlen.tolist() == [len(reference._message(c)) for c in coeffs]
    assert n_sym.tolist() == [len(np.unique(reference._message(c)))
                              for c in coeffs]


def test_tools_run_on_the_cpu():
    out = exp_encphase.run("cpu", (H, W))
    assert out["max_abs_err"] == 0 and "no canonical sort" in out["cansort"]
    for frame in ("cli", "noise"):
        assert set(out[frame]) == set(encode.PHASE_VARIANTS)
        assert all(r["exact"] and r["stand_in"]
                   for r in out[frame].values())
    out = exp_encsplit.run("cpu", (H, W))
    assert out["exact"] and out["flat_one_symbol"]
    assert out["max_abs_err"] == 0


def test_front_widths_take_each_warps_widest_block():
    """Two warps each of messages of 1 and 9 positions, then of the mixed
    warp (1, 64, 9, 33) and of 64 equal values; a ninth block alone in its
    warp, whose other groups code a one-symbol message."""
    rows = np.concatenate([
        front_cases.front_blocks(np.random.default_rng(20), case)
        for case in ("msg_len_1", "msg_len_9", "mixed_warp", "all_equal")])
    coeffs = torch.from_numpy(rows)
    widths = exp_encphase.front_widths(coeffs)
    assert widths["value"] == {"1": 0.25, "2": 0.0, "4": 0.0, "8": 0.0,
                               "16": 0.25, "32": 0.0, "64": 0.5}
    _, n_sym = exp_encphase.message_stats(coeffs)
    most = n_sym.view(-1, 4).amax(dim=1).tolist()
    want = [next(k for k in exp_encphase.WIDTHS if k >= m) for m in most]
    assert widths["weight"] == {str(k): want.count(k) / len(want)
                                for k in exp_encphase.WIDTHS}
    part = exp_encphase.front_widths(coeffs[:9])
    assert part["value"] == {"1": 2 / 3, "2": 0.0, "4": 0.0, "8": 0.0,
                             "16": 1 / 3, "32": 0.0, "64": 0.0}


def test_encphase_takes_its_quality():
    dev, values = common.tool_args(exp_encphase.__doc__,
                                   ["--device", "cpu", "--quality", "90"],
                                   {"quality": 50})
    assert dev.type == "cpu" and values == {"quality": 90}
    out = exp_encphase.run("cpu", (H, W), quality=90)
    assert out["quality"] == 90 and out["max_abs_err"] == 0
    for frame in ("cli", "noise"):
        assert all(r["exact"] and r["stand_in"] for r in out[frame].values())
        for shares in out["front_widths"][frame].values():
            assert abs(sum(shares.values()) - 1) < 1e-9


@pytest.mark.parametrize("variant", ["", "full", "cansort", "dct", "Merge"])
def test_unknown_variant_raises(rng, variant):
    args = _torch(_frame(rng), 50)
    with pytest.raises(ValueError, match="variant"):
        encode.dct_encode_phase(*args, variant)
    with pytest.raises(ValueError, match="variant"):
        encode.dct_encode_phase_plain(*args, variant)
    with pytest.raises(ValueError, match="variant"):
        exp_encphase.stand_in_holds(variant, None, None, None)


def test_other_devices_raise(rng):
    meta = [t.to("meta") for t in _torch(_frame(rng), 50)]
    with pytest.raises(ValueError, match="dct_encode_phases"):
        encode.dct_encode_phase(*meta, "merge")
