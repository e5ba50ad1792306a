"""The probes of ``myyuv_tpu_torch/tools/`` (T1-T7) on the CPU: each
kernel's plain PyTorch version against the JAX tool's own kernel, run in
Pallas interpret mode on the same inputs made from a seed with numpy, and
the decoder's tree stage against ``_tree_kernel8`` on the windows of the
JAX word codec.

The JAX tools are loaded from their files (``tools/<name>.py``) with
importlib; their import-time ``jaxcache.enable()`` sets the compilation
cache this suite's conftest set already, and ``sys.path`` is restored
after. Where a tool builds its kernel inside ``main`` (T7's ``chain``), or
sizes its ``pallas_call`` with module constants (T3), the test builds the
``pallas_call`` around the same body at a small size.

Tolerance: exact, bit for bit. CPU XLA contracts a multiply and an add into
one FMA when a Pallas body runs eagerly in interpret mode, so T4's bare
form and T7's bare chain are compared only as the tools call them, under
``jax.jit`` on captured inputs, which XLA folds without contracting; the
plain chain is also held to the host's double-rounded numpy sequence, and
the rounded forms are compared everywhere.
"""

import hashlib
import importlib.util
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from myyuv_tpu.engine import batch as jax_batch
from myyuv_tpu.engine import device_stream as jax_ds
from myyuv_tpu.engine import word_frame as jax_wf
from myyuv_tpu.entropy import pallas_decode8 as pd8
from myyuv_tpu.kernels import pallas_dct8 as p8
from myyuv_tpu_torch.engine import device_stream, pipeline
from myyuv_tpu_torch.entropy import decode
from myyuv_tpu_torch.entropy import device as edev
from myyuv_tpu_torch.kernels import probe
from myyuv_tpu_torch.kernels.constants import DCT_MATRIX8
from myyuv_tpu_torch.tools import (check_bitexact, common, exp_bcast,
                                   exp_fma, exp_r3stage, exp_r4lane,
                                   exp_shuffle, exp_sublane)

REPO = Path(__file__).resolve().parent.parent
I32 = jnp.int32


@lru_cache(maxsize=None)
def jax_tool(name: str):
    """``tools/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def bits(t) -> np.ndarray:
    return np.asarray(t).view(np.uint32)


# ---- T1 ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 512), (24, 1024), (16, 4032)])
def test_t1_pack_plane_matches_jax(rng, shape):
    """pack_plane_fast against the JAX package's pack_pixel_words and the
    JAX tool's own Pallas relayout (the tool's verify_cpu sizes), then back
    through unpack_plane_fast."""
    t1 = jax_tool("exp_shuffle")
    h, w = shape
    plane = rng.integers(0, 256, (h, w), np.uint8)
    want = np.asarray(p8.pack_pixel_words(jnp.asarray(plane)))
    np.testing.assert_array_equal(
        np.asarray(t1.pack_plane_fast(jnp.asarray(plane), interpret=True)),
        want)
    got = exp_shuffle.pack_plane_fast(torch.from_numpy(plane))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        exp_shuffle.unpack_plane_fast(got, h, w).numpy(), plane)


@pytest.mark.parametrize("nbits", [4, 6, 10])
def test_t1_lane_shuffle_matches_jax_kernel(rng, nbits):
    """The plain bit-permutation against the JAX tool's roll-and-select
    kernel in interpret mode and its numpy oracle, for the pack and
    unpack permutations and a random one; the perm helpers equal the
    tool's."""
    t1 = jax_tool("exp_shuffle")
    x = rng.integers(-2**31, 2**31, (8, 1 << nbits), dtype=np.int64
                     ).astype(np.int32)
    perms = [exp_shuffle.pack_perm(nbits), exp_shuffle.unpack_perm(nbits),
             tuple(int(v) for v in rng.permutation(nbits))]
    assert perms[:2] == [t1.pack_perm(nbits), t1.unpack_perm(nbits)]
    for perm in perms:
        assert exp_shuffle.bitperm_swaps(perm) == t1.bitperm_swaps(perm)
        want = np.asarray(t1.lane_shuffle(jnp.asarray(x), perm,
                                          interpret=True))
        np.testing.assert_array_equal(want, t1.apply_perm_np(x, perm))
        got = exp_shuffle.lane_shuffle(torch.from_numpy(x), perm)
        np.testing.assert_array_equal(got.numpy(), want)
        src = exp_shuffle.source_lanes(perm, "cpu")
        np.testing.assert_array_equal(x[:, src.numpy()], want)


# ---- T2 ----------------------------------------------------------------

def test_t2_bcast_matches_jax_kernel():
    """The JAX tool's inputs through its ``kern`` in interpret mode."""
    t2 = jax_tool("exp_bcast")
    x, q = exp_bcast.inputs("cpu")
    want = pl.pallas_call(
        t2.kern, out_shape=jax.ShapeDtypeStruct((64, t2.TP), jnp.float32),
        grid=(1,),
        in_specs=[pl.BlockSpec((64, t2.TP), lambda i: (0, i)),
                  pl.BlockSpec((64, 1), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((64, t2.TP), lambda i: (0, i)),
        interpret=True)(jnp.asarray(x.numpy()), jnp.asarray(q.numpy()))
    np.testing.assert_array_equal(bits(exp_bcast.bcast_mul(x, q).numpy()),
                                  bits(want))
    assert exp_bcast.run("cpu")["exact"]


# ---- T3 ----------------------------------------------------------------

def test_t3_lane_ops_match_jax_kernels(rng):
    """s1, s2 and s3 against the tool's kernel bodies in interpret mode on
    [16, 256]; s4 against jnp.roll(x, -1, 1) and against the tool's roll
    body with the non-negative shift C - 1 (the tool's own shift of -1
    raises on current JAX; where it runs, it must agree too)."""
    t3 = jax_tool("exp_r4lane")
    r, c = 16, 256
    x = rng.integers(-2**31, 2**31, (r, c), dtype=np.int64).astype(np.int32)

    def call(kernel, out_cols):
        return np.asarray(pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((r, out_cols), I32),
            grid=(r // 8,), in_specs=[pl.BlockSpec((8, c), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((8, out_cols), lambda i: (i, 0)),
            interpret=True)(jnp.asarray(x)))

    def k_roll_nonneg(x_ref, o_ref):
        t = x_ref[...]
        o_ref[...] = t + pltpu.roll(t, c - 1, 1)

    want = {"s1": call(t3.k_sliceread, c // 2),
            "s2": call(t3.k_slicewrite, c),
            "s3": call(t3.k_reshape, c // 2),
            "s4": call(k_roll_nonneg, c)}
    np.testing.assert_array_equal(want["s4"], x + np.roll(x, -1, 1))
    np.testing.assert_array_equal(
        want["s4"], np.asarray(jnp.asarray(x) + jnp.roll(jnp.asarray(x),
                                                         -1, 1)))
    try:
        as_written = call(t3.k_roll, c)
    except ValueError:
        as_written = None
    if as_written is not None:
        np.testing.assert_array_equal(as_written, want["s4"])
    xt = torch.from_numpy(x)
    for op, w in want.items():
        np.testing.assert_array_equal(exp_r4lane.lane_probe(xt, op).numpy(),
                                      w, err_msg=op)
        np.testing.assert_array_equal(exp_r4lane.library_call(xt, op)
                                      .numpy(), w, err_msg=op)


# ---- T4 ----------------------------------------------------------------

def test_t4_forms_match_jax_kernels_and_host():
    """On the JAX tool's inputs: the plain rounded form equals the host's
    double-rounded numpy a * b + c and the tool's ``_defeated`` (eager and
    jitted); the plain bare form equals the tool's ``_bare`` under jax.jit;
    the plain fused form differs from rounded in 16,742 elements."""
    t4 = jax_tool("exp_fma")
    a, b, c = exp_fma.inputs()
    shape = (a.size // 128, 128)
    args = [jnp.asarray(v.reshape(shape)) for v in (a, b, c)]

    def call(kern):
        return pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(
            shape, jnp.float32), interpret=True)(*args)

    host = ((a * b) + c).reshape(shape)
    t = [torch.from_numpy(v.reshape(shape)) for v in (a, b, c)]
    rounded = exp_fma.fma_form(*t, "rounded").numpy()
    np.testing.assert_array_equal(bits(rounded), bits(host))
    np.testing.assert_array_equal(bits(call(t4._defeated)), bits(host))
    np.testing.assert_array_equal(
        bits(jax.jit(lambda: call(t4._defeated))()), bits(host))
    np.testing.assert_array_equal(
        bits(exp_fma.fma_form(*t, "bare").numpy()),
        bits(jax.jit(lambda: call(t4._bare))()))
    fused = exp_fma.fma_form(*t, "fused").numpy()
    assert int((bits(fused) != bits(rounded)).sum()) == 16742
    out = exp_fma.run("cpu")
    assert out["bare_vs_rounded"] == 0 and out["fused_vs_rounded"] == 16742
    assert out["bare_equals_host"] and all(out["plain_exact"].values())


def test_t4_fused_plain_rounds_once():
    """The plain fused form equals a * b + c rounded once to float32 (the
    nearest float to the exact rational value, ties to even) on all of the
    JAX tool's 65,536 inputs."""
    from fractions import Fraction
    a, b, c = exp_fma.inputs()
    got = exp_fma.fused_plain(*(torch.from_numpy(v) for v in (a, b, c)))
    up, down = np.float32(np.inf), np.float32(-np.inf)
    for i, g in enumerate(got.numpy().tolist()):
        exact = (Fraction(float(a[i])) * Fraction(float(b[i]))
                 + Fraction(float(c[i])))
        f = np.float32(float(exact))
        best = min((np.nextafter(f, down), f, np.nextafter(f, up)),
                   key=lambda v: (abs(Fraction(float(v)) - exact),
                                  int(np.float32(v).view(np.uint32)) & 1))
        assert np.float32(g) == best, i


# ---- T5 ----------------------------------------------------------------

def _jax_tree(A, C):
    """``_tree_kernel8`` on windows (W0, Wc) as tools/exp_r3stage.py:102-119
    calls it, one tile the width of the windows."""
    ntp, wcr = A.shape[1], C.shape[0]
    outs = pl.pallas_call(
        pd8._tree_kernel8,
        out_shape=(jax.ShapeDtypeStruct((256, ntp), I32),
                   jax.ShapeDtypeStruct((72, ntp), I32),
                   jax.ShapeDtypeStruct((8, ntp), I32)),
        grid=(1,),
        in_specs=[pl.BlockSpec((64, ntp), lambda i: (0, i)),
                  pl.BlockSpec((wcr, ntp), lambda i: (0, i))],
        out_specs=(pl.BlockSpec((256, ntp), lambda i: (0, i)),
                   pl.BlockSpec((72, ntp), lambda i: (0, i)),
                   pl.BlockSpec((8, ntp), lambda i: (0, i))),
        scratch_shapes=[pltpu.VMEM((512, ntp), I32)],
        interpret=True)(A, C)
    return [np.asarray(o) for o in outs]


def test_t5_tree_stage_matches_jax_tree_kernel(rng):
    """The 32x64 frame of test_torch_entropy.py's K1 test at q50 and q90:
    the JAX word codec's windows (compress_words, interpret mode, tile 8,
    windows of 64 words, which hold every chunk) through _tree_kernel8,
    against the port's tree stage on the same chunks (the stream pulled
    from those windows; at q50 it is also the port's plain encoder's
    stream). Block b is lane (b % 8, b // 8) of the windows; JAX's symbols
    are raw 11-bit values in stream order (here, canonical order), the
    port's sign-extended int16, so they compare & 0x7FF; JAX's bad flag is
    0 on these canonical streams, and the port's code 0."""
    h, w = 32, 64
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2) % 200
    y = (base + rng.integers(0, 40, (h, w))).astype(np.uint8)
    u = rng.integers(90, 170, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
    xw = jax_wf.pack_frame(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                           tile=8)
    for q in (50, 90):
        qts = jax_batch.plane_qtables([q] * 3)
        A, C, sizes, _, ok = jax_wf.compress_words(
            xw, *qts, h=h, w=w, cont=jax_ds.CONT_ROOMY, interpret=True,
            tile=8)
        assert bool(ok)
        sizes_np = np.asarray(sizes).astype(np.int32)
        n = sizes_np.size
        content = jax_ds._pull_packed_stream(A, C, sizes, sizes_np)
        sym2, counts, bad = _jax_tree(A, C)
        b = np.arange(n)
        r, c = b % 8, b // 8
        assert not bad[r, c].any()
        jcounts = np.stack([counts[8 * ln + r, c] for ln in range(1, 9)], 1)
        jsyms = np.stack([(sym2[8 * (k // 2) + r, c] >> (16 * (k % 2)))
                          & 0xFFFF for k in range(64)], 1)
        st = torch.from_numpy(np.ascontiguousarray(content))
        sz = torch.from_numpy(sizes_np)
        offsets = torch.cumsum(sz, 0, dtype=torch.int64) - sz
        syms, cnts, err = decode.parse_trees(st, sz, offsets)
        assert not err.any()
        np.testing.assert_array_equal(cnts.numpy(), jcounts)
        np.testing.assert_array_equal(syms.numpy().astype(np.int32) & 0x7FF,
                                      jsyms)
        if q == 50:
            dct, qt = pipeline.codec_params([q] * 3, "cpu")
            psizes, pcontent = device_stream.compress_frame(
                *(torch.from_numpy(p) for p in (y, u, v)), qt, dct)
            assert torch.equal(psizes, sz) and torch.equal(pcontent, st)


def test_t5_tree_stage_on_decoder_families(rng):
    """On every decoder family: the tree stage's code is K6's plain code
    where that is a tree code (1..4) and 0 otherwise; a good block's counts
    and symbols are what the decoder's tables hold (symbols in canonical
    order), a bad block's are 0."""
    for name, arrays in probe.decoder_families(rng).items():
        content, sizes, offsets = (torch.from_numpy(a) for a in arrays)
        syms, counts, err = decode.parse_trees(content, sizes, offsets)
        _, k6_err = decode.decode_blocks(content, sizes, offsets)
        assert exp_r3stage.tree_codes_agree(err, k6_err), name
        assert not syms[err != 0].any() and not counts[err != 0].any()
        L = torch.nn.functional.pad(
            edev.gather_lanes(content, sizes, offsets).to(torch.int32),
            (0, 8))
        tcounts, symtab, terr, _, _ = edev._tree_tables(
            L, sizes.to(torch.int32))
        assert torch.equal(terr, err), name
        for i in torch.nonzero(err == 0).flatten().tolist():
            assert counts[i].tolist() == tcounts[i, 1:].tolist()
            table = [v for ln in range(1, 9)
                     for v in symtab[i, 64 * ln:64 * ln + int(
                         tcounts[i, ln])].tolist()][:64]
            want = table + [0] * (64 - len(table))
            assert syms[i].tolist() == want, (name, i)


def test_decode_lanes_unchanged_by_the_tree_factoring():
    """decode_lanes' coefficients and codes on every decoder family, with
    gaps and back to back, hash to what they were before its tree stage
    became _tree_tables (sha256 of the int16 coefficients and int32 codes,
    little-endian, family by family)."""
    h = hashlib.sha256()
    fams = probe.decoder_families(np.random.default_rng(7))
    layouts = list(fams.items()) + [
        (name, probe.back_to_back(*a)) for name, a in fams.items()]
    for _, arrays in layouts:
        content, sizes, offsets = (torch.from_numpy(a) for a in arrays)
        coeffs, err = edev.decode_lanes(
            edev.gather_lanes(content, sizes, offsets), sizes)
        h.update(coeffs.numpy().tobytes())
        h.update(err.numpy().tobytes())
    assert h.hexdigest() == ("f6ea1bbf319508821048dbacdd9c6491"
                             "c1519e6b5930edaac12b2c0c0154eae2")


def test_t5_stage_tool_on_the_cpu():
    out = exp_r3stage.run("cpu", (64, 128))
    for frame in ("cli", "noise"):
        assert out[frame] == {"exact": True, "codes_agree": True}


# ---- T6 ----------------------------------------------------------------

@pytest.mark.parametrize("rows,tile", [(1, 1024), (8, 128)])
def test_t6_chain_matches_jax_kernel(rows, tile):
    """1,024 blocks through the tool's make_kernel in interpret mode, in
    its two layouts, on the tool's own word draws (seed 0); the two
    layouts of one table agree."""
    t6 = jax_tool("exp_sublane")
    nblocks = 1024
    cw_rows, ncols = exp_sublane.CW * rows, nblocks // rows
    words = np.random.default_rng(0).integers(0, 1 << 30, (cw_rows, ncols),
                                              dtype=np.int32)
    want = pl.pallas_call(
        t6.make_kernel(rows, tile, cw_rows),
        out_shape=jax.ShapeDtypeStruct((rows, ncols), I32),
        grid=(ncols // tile,),
        in_specs=[pl.BlockSpec((cw_rows, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((rows, tile), lambda i: (0, i)),
        interpret=True)(jnp.asarray(words))
    got = exp_sublane.consume_chain(torch.from_numpy(words), rows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (t6.STEPS, t6.CW) == (exp_sublane.STEPS, exp_sublane.CW)
    out = exp_sublane.run("cpu", nblocks)
    assert out["exact"] and out["layouts_equal"]


# ---- T7 ----------------------------------------------------------------

def test_t7_chain_matches_host_double_rounded():
    """The JAX tool's chain (check_tpu_bitexact.py:86-99: DCT row 1 over
    [64, 1024], seed 7's fourth draw) in the plain version equals the
    host's double-rounded numpy sequence bit for bit, as the tool holds the
    TPU kernel to it; the rest of the tool's checks pass on the CPU."""
    xs = check_bitexact.inputs("cpu")["xs"]
    crow = np.asarray(DCT_MATRIX8, np.float32)[1]
    want = crow[0] * xs[0:8]
    for k in range(1, 8):
        want = want + crow[k] * xs[8 * k:8 * k + 8]
    got = check_bitexact.dct_chain(torch.from_numpy(xs),
                                   torch.from_numpy(crow))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    out = check_bitexact.run("cpu")
    assert out["failed"] == [] and out["max_abs_err"] == 0


def test_t7_chain_matches_jax_kernel():
    """The JAX tool's chain (built inside its main, so copied here from
    check_tpu_bitexact.py:88-93) as a pallas_call on [64, 1024], called as
    the tool calls it (:95-97, jax.jit of a call on the captured input), on
    the tool's draw, equals the plain version bit for bit. XLA folds that
    constant call at compile time and does not contract it; with the input
    as an argument the CPU backend contracts (4,029 of the 8,192 values
    differ), as eager interpret mode does, so that form is no oracle."""
    from myyuv_tpu.kernels.constants import DCT_MATRIX8 as JAX_DCT8
    xs = check_bitexact.inputs("cpu")["xs"]
    crow = np.asarray(JAX_DCT8, np.float32)[1]
    np.testing.assert_array_equal(
        crow, np.asarray(DCT_MATRIX8, np.float32)[1])

    def chain(x_ref, o_ref):
        xk = [x_ref[8 * k:8 * k + 8, :] for k in range(8)]
        acc = jnp.float32(float(crow[0])) * xk[0]
        for k in range(1, 8):
            acc = acc + (jnp.float32(float(crow[k])) * xk[k])
        o_ref[...] = acc

    want = jax.jit(lambda: pl.pallas_call(
        chain, out_shape=jax.ShapeDtypeStruct((8, 1024), jnp.float32),
        interpret=True)(jnp.asarray(xs)))()
    got = check_bitexact.dct_chain(torch.from_numpy(xs),
                                   torch.from_numpy(crow))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


# ---- the tools' timing --------------------------------------------------

def test_cold_calls_rotate_over_copies_past_the_l2(monkeypatch):
    """``common.cold`` calls fn on n copies of its inputs in turn, the
    other n - 1 copies together more than twice the L2, and keeps each
    output until its copy's next turn."""
    monkeypatch.setattr(common, "L2_BYTES", 40_000)
    x = torch.arange(1000, dtype=torch.int32)
    seen, outs = [], []

    def fn(t):
        seen.append(t.data_ptr())
        assert torch.equal(t, x)
        outs.append(t + 1)
        return outs[-1]

    call = common.cold(fn, [x])
    n = 22  # 2 * 40,000 // 4,000 + 2
    for _ in range(2 * n):
        call()
    assert len(set(seen)) == n and x.data_ptr() not in seen
    assert seen[n:] == seen[:n]
    assert (n - 1) * x.numel() * 4 > 2 * common.L2_BYTES
    kept = call.__closure__[[c for c in call.__code__.co_freevars]
                            .index("kept")].cell_contents
    assert [o.data_ptr() for o in kept] == [o.data_ptr()
                                            for o in outs[-(n - 1):]]


def test_times_refuses_a_reading_under_the_bound(monkeypatch):
    """A kernel timed faster than the least time its bytes need is a
    wrong reading, and ``common.times`` says so."""
    x = torch.zeros(1 << 20, dtype=torch.int32)
    monkeypatch.setattr(common.probe, "cuda_ms", lambda fn: 1e-4)
    with pytest.raises(RuntimeError, match="under its bound"):
        common.times(torch.neg, torch.neg, args=[x], nbytes=8 * x.numel())
    t = common.times(torch.neg, torch.neg, torch.neg, args=[x], nbytes=1e5)
    assert t["ms"] == t["plain_ms"] == t["library_ms"] == 1e-4
    assert t["bound_by"] == "bytes"
