"""Stage times of the frame path on the card: the counterpart of
``tools/exp_r3stage.py``, with the decoder's tree stage (T5) as a kernel of
its own.

Run from the repository root on a machine with a CUDA card::

    python3 -m myyuv_tpu_torch.tools.exp_r3stage [--device cuda|cpu]

On two 4032x3008 q50 frames -- ``cli``, a ``probe.smooth_picture``
converted to IYUV by X1 (the kind of frame ``chip_smoke.py``'s CLI phase
compresses), and ``noise``, uniform random planes (the entropy kernels'
slowest content) -- it prints, in ms:

* ``compress_frame`` and ``decompress_frame``, the frame API (both wait for
  the card: host-inclusive, ``probe.host_inclusive_ms``);
* compress by stage: K1 (DCT + quantize + Huffman encode), K3 (DCT +
  quantize) alone, K5 (Huffman encode) alone, and the compaction of K1's
  256-byte lanes into the stream (``device_stream.compact_chunks``, a mask
  select that waits for the card: host-inclusive);
* decompress by stage: T5 (``decode.parse_trees``, the tree stage alone),
  K6 (tree + payload), K4 (dequantize + IDCT) and K2 (tree + payload +
  IDCT);

the kernels by ``probe.cuda_ms`` (calls queued behind a busy card, the
host's work left out), and from them, labelled derived, the decoder's
split: payload = K6 - T5 and IDCT = K2 - K6. T5 writes its tables (164
bytes a block) to device memory, where K6 keeps them in shared memory, so
K6 - T5 understates the payload; ``T5_tables_write``, a fill of the same
tensors, is the cost of that write, and ``derived_tree_parse`` = T5 minus
it a lower bound on the tree stage's own time (in T5 the parse and the
write overlap). All of these find the stream in the L2, as the frame
API's stages do; ``T5_row`` times T5 again with each call reading its
stream from device memory (``tree_times``), beside its plain version and
its bound by bytes. The JAX tool's pack and unpack
stages have no counterpart: the port reads and writes planes, with no word
layout. T5 is held against its plain version and its error codes against
K6's before the timing. On the CPU it checks T5 (the plain version) and
times nothing. One JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..engine import device_stream
from ..engine.pipeline import codec_params
from ..entropy import decode, encode
from ..kernels import convert, probe, transform
from . import common

SHAPE = (3008, 4032)


def frames(dev, shape=SHAPE) -> dict:
    """The tool's two frames (seed 0) as (y, u, v) planes on ``dev``."""
    h, w = shape
    rng = np.random.default_rng(0)
    px = torch.from_numpy(probe.smooth_picture(rng, h, w)).to(dev)
    noise = [torch.from_numpy(rng.integers(0, 256, s, np.uint8)).to(dev)
             for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    return {"cli": list(convert.bgrx_to_iyuv(px)), "noise": noise}


def tree_codes_agree(tree_err: torch.Tensor, k6_err: torch.Tensor) -> bool:
    """T5's codes are K6's where K6 found a bad tree (1..4) and 0 where K6
    found a good tree (0) or a bad payload (5..8)."""
    want = torch.where(k6_err <= 4, k6_err, 0)
    return bool(torch.equal(tree_err, want))


def tree_bytes(stream: torch.Tensor, sizes: torch.Tensor) -> int:
    """The bytes T5 must move: the stream, sizes and offsets in; symbols,
    counts and err out."""
    n = sizes.numel()
    return stream.numel() + 12 * n + (128 + 32 + 4) * n


def tree_times(stream: torch.Tensor, sizes: torch.Tensor,
               offsets: torch.Tensor) -> dict:
    """T5 on one stream beside its plain version (host-inclusive: it
    synchronises) and its bound (``common.times``: each call reads its
    stream from device memory)."""
    return common.times(decode.parse_trees, decode.parse_trees_plain,
                        args=[stream, sizes, offsets],
                        nbytes=tree_bytes(stream, sizes), plain_syncs=True)


def stage_split(planes, qt: torch.Tensor, dct: torch.Tensor) -> dict:
    """The stage times of one frame on the card, in ms (see the module
    docstring), with the derived decoder split."""
    h, w = planes[0].shape
    lanes, sizes, _ = encode.dct_encode_blocks(*planes, qt, dct)
    stream = device_stream.compact_chunks(lanes, sizes)
    offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
    coeffs = transform.dct_quantize_blocks(*planes, qt, dct)
    cuda_ms, host_ms = probe.cuda_ms, probe.host_inclusive_ms
    t = {
        "stream_bytes": int(stream.numel()),
        "compress_frame_host_incl": host_ms(
            lambda: device_stream.compress_frame(*planes, qt, dct)),
        "decompress_frame_host_incl": host_ms(
            lambda: device_stream.decompress_frame(stream, sizes, qt, dct,
                                                   h, w)),
        "K1": cuda_ms(lambda: encode.dct_encode_blocks(*planes, qt, dct)),
        "K3": cuda_ms(lambda: transform.dct_quantize_blocks(*planes, qt,
                                                            dct)),
        "K5": cuda_ms(lambda: encode.encode_blocks(coeffs)),
        "compaction_host_incl": host_ms(
            lambda: device_stream.compact_chunks(lanes, sizes)),
        "T5": cuda_ms(lambda: decode.parse_trees(stream, sizes, offsets)),
        "K6": cuda_ms(lambda: decode.decode_blocks(stream, sizes, offsets)),
        "K4": cuda_ms(lambda: transform.dequantize_idct_blocks(
            coeffs, qt, dct, h, w)),
        "K2": cuda_ms(lambda: decode.decode_idct_blocks(
            stream, sizes, offsets, qt, dct, h, w)),
    }
    t["T5_row"] = tree_times(stream, sizes, offsets)
    # T5 writes 164 bytes of tables a block that K6 keeps in shared memory:
    # their write alone (a fill of the same tensors) is the yardstick
    syms, counts, err = decode.parse_trees(stream, sizes, offsets)
    t["T5_tables_write"] = cuda_ms(lambda: (syms.zero_(), counts.zero_(),
                                            err.zero_()))
    t["derived_payload"] = t["K6"] - t["T5"]
    t["derived_tree_parse"] = t["T5"] - t["T5_tables_write"]
    t["derived_idct"] = t["K2"] - t["K6"]
    return t


def run(device="cuda", shape=SHAPE) -> dict:
    """T5 on both frames' q50 streams on ``device``: against its plain
    version, and its codes against K6's."""
    dev = torch.device(device)
    dct, qt = codec_params([50] * 3, dev)
    out = {"tool": "exp_r3stage", "shape": list(shape), "quality": 50}
    errs = []
    for name, planes in frames(dev, shape).items():
        sizes, stream = device_stream.compress_frame(*planes, qt, dct)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        tree = decode.parse_trees(stream, sizes, offsets)
        pairs = list(zip(tree, decode.parse_trees_plain(stream, sizes,
                                                        offsets)))
        k6 = decode.decode_blocks(stream, sizes, offsets)
        out[name] = {"exact": all(torch.equal(a, b) for a, b in pairs),
                     "codes_agree": tree_codes_agree(tree[2], k6[1])}
        errs.append(common.max_abs_err(pairs))
    out["max_abs_err"] = max(errs)
    return out


def times(device="cuda") -> dict:
    """``stage_split`` of both frames on the card."""
    dev = torch.device(device)
    dct, qt = codec_params([50] * 3, dev)
    return {name: stage_split(planes, qt, dct)
            for name, planes in frames(dev).items()}


def main(argv=None) -> int:
    out = common.run_tool(run, times, __doc__, argv)
    return 0 if all(out[k]["exact"] and out[k]["codes_agree"]
                    for k in ("cli", "noise")) else 1


if __name__ == "__main__":
    sys.exit(main())
