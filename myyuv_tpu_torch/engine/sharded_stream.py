"""The frame codec sharded over a device mesh: block-row slabs on each device,
the file's streams assembled on the host.

Port of ``myyuv_tpu/engine/sharded_stream.py`` (``compress_frame_sharded``
:191, ``decompress_frame_sharded`` :266, ``compress_batch_sharded`` :348).
Plane block rows shard contiguously over the mesh's flattened (data, block)
devices (``Mesh.flat``): device d owns row slab d of every plane and codes
it with the same kernels as the single-device frame API of
``engine/device_stream.py``, K1 to compress and K2 to decompress, on d's
current stream. Blocks are independent in the format (per-block Huffman
tables, DCT.cpp:16-33), so each chunk is the single-device chunk, and
joining the shards' chunks in (plane, shard) order gives the single-device
stream byte for byte.

Slab geometry: luma rows pad to a multiple of 16 n (n shards) and each
chroma plane to half of that, so every slab is a frame K1 and K2 take
as they are (luma rows a multiple of 16, chroma exactly half). Pad blocks
sit at each plane's tail: compress drops their chunks at assembly, and
decompress feeds them a valid filler chunk (an all-zero block's) whose
pixels are cropped away. A shard may hold no live block of a plane.

Compress queues every shard's K1 before it waits: the lanes of the shards
of one device are compacted together, one wait a device.

``precision="fast"`` (default "exact"; any other value raises ValueError)
codes each shard as ``device_stream`` does: F1 then K5 in place of K1, K6
then F2 in place of K2.

The JAX package's repack/expand steps, continuation ladder, dense A/C
interchange and executable cache have no counterpart: K1 writes each
chunk's on-disk bytes, so assembly is slicing and concatenating.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..entropy import device as edev
from ..kernels import constants, transform
from ..kernels.device import plane_block_counts
from ..parallel import distributed
from ..parallel.mesh import Mesh
from ..runtime.errors import BitstreamError
from . import device_stream
from .pipeline import codec_params_from_jax

Stream = device_stream.Stream


def _geometry(h: int, w: int, n: int):
    """(luma slab rows, per-plane (blocks a slab, live blocks of each
    shard, blocks of the plane)) of an h x w frame over n shards: h padded
    to a multiple of 16 n, over n (chroma slabs hold half as many rows)."""
    sl = -(-h // (16 * n)) * 16
    out = []
    for rows, slab, bw in ((h, sl, w // 8), (h // 2, sl // 2, w // 16),
                           (h // 2, sl // 2, w // 16)):
        live = [max(0, min(slab, rows - d * slab)) // 8 * bw
                for d in range(n)]
        out.append((slab // 8 * bw, live, rows // 8 * bw))
    return sl, out


def _slab(plane: np.ndarray, d: int, rows: int) -> np.ndarray:
    """Rows [d * rows, (d + 1) * rows) of ``plane``, zero rows past its
    end: a view where the slab lies inside the plane."""
    part = plane[d * rows:(d + 1) * rows]
    if part.shape[0] == rows:
        return part
    out = np.zeros((rows, plane.shape[1]), np.uint8)
    out[:part.shape[0]] = part
    return out


def _params(qtables_np, devices) -> Dict[torch.device, Tuple]:
    """(dct, qtables) on each distinct device."""
    return {dev: codec_params_from_jax(constants.DCT_MATRIX8,
                                       list(qtables_np), dev)
            for dev in dict.fromkeys(devices)}


def _check_err(err: np.ndarray, shard: int, what: str) -> None:
    bad = np.flatnonzero(err)
    if bad.size:
        raise BitstreamError(f"{what} failed at block {int(bad[0])} of "
                             f"shard {shard} (code {int(err[bad[0]])})")


def compress_frame_sharded(mesh: Mesh, planes_np: Sequence[np.ndarray],
                           qtables_np: Sequence[np.ndarray],
                           precision: str = "exact") -> List[Stream]:
    """(y, u, v) uint8 planes (H, W multiples of 16) -> [(sizes u8,
    content u8)] per plane, coded over the mesh: byte-identical to
    ``device_stream.compress_frame_to_streams`` at the same
    ``precision``. ``qtables_np`` holds the
    three [8, 8] float32 tables (Y, U, V). Raises ValueError on other
    shapes, BitstreamError on a chunk the size field cannot hold."""
    y, u, v = [np.ascontiguousarray(p) for p in planes_np]
    h, w = y.shape
    transform.frame_blocks(h, w)
    for name, p in (("u", u), ("v", v)):
        if p.shape != (h // 2, w // 2):
            raise ValueError(f"{name}: want {(h // 2, w // 2)}, got "
                             f"{p.shape}")
    devs = mesh.flat
    n = len(devs)
    sl, geo = _geometry(h, w, n)
    params = _params(qtables_np, devs)
    queued: Dict[torch.device, list] = {}
    for d, dev in enumerate(devs):
        slab = [torch.from_numpy(_slab(p, d, r)).to(dev)
                for p, r in ((y, sl), (u, sl // 2), (v, sl // 2))]
        dct, qt = params[dev]
        queued.setdefault(dev, []).append(
            (d, device_stream.frame_lanes(*slab, qt, dct,
                                          precision=precision)))
    shards: List[Tuple[np.ndarray, np.ndarray]] = [None] * n
    for items in queued.values():
        lanes, sizes, err = (torch.cat([out[i] for _, out in items])
                             for i in range(3))
        content = device_stream.compact_chunks(lanes, sizes).cpu().numpy()
        sizes, err = sizes.cpu().numpy(), err.cpu().numpy()
        n_loc = sizes.size // len(items)
        pos = 0
        for k, (d, _) in enumerate(items):
            s = sizes[k * n_loc:(k + 1) * n_loc]
            _check_err(err[k * n_loc:(k + 1) * n_loc], d, "Huffman encode")
            t = int(s.sum(dtype=np.int64))
            shards[d] = (s, content[pos:pos + t])
            pos += t
    out_sizes: List[list] = [[], [], []]
    out_content: List[list] = [[], [], []]
    for d, (s, c) in enumerate(shards):
        offs = np.concatenate([[0], np.cumsum(s, dtype=np.int64)])
        lo = 0
        for p, (n_loc, live, _) in enumerate(geo):
            k = live[d]
            out_sizes[p].append(s[lo:lo + k].astype(np.uint8))
            out_content[p].append(c[offs[lo]:offs[lo + k]])
            lo += n_loc
    return [(np.concatenate(out_sizes[p]), np.concatenate(out_content[p]))
            for p in range(3)]


@functools.lru_cache(maxsize=1)
def zero_block_chunk() -> np.ndarray:
    """The chunk bytes of an all-zero coefficient block (the single-symbol
    stream, Huffman.cpp:176-203): the filler of pad blocks."""
    lanes, sizes, _ = edev.encode_lanes(torch.zeros((1, 64),
                                                    dtype=torch.int16))
    return lanes[0, :int(sizes[0])].numpy()


def decompress_frame_sharded(mesh: Mesh, streams: Sequence[Stream],
                             qtables_np: Sequence[np.ndarray], h: int,
                             w: int, precision: str = "exact"
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-plane (sizes u8, content u8) -> (y, u, v) uint8 planes of an
    h x w frame, decoded over the mesh (the inverse partitioning of
    ``compress_frame_sharded``): pixel-identical to
    ``device_stream.decompress_streams_to_frame`` at the same
    ``precision``. Raises ValueError on a
    geometry K2 does not take or a plane whose chunk count is not the
    frame's, BitstreamError on a malformed chunk or a content shorter than
    its sizes."""
    transform.frame_blocks(h, w)
    devs = mesh.flat
    n = len(devs)
    sl, geo = _geometry(h, w, n)
    params = _params(qtables_np, devs)
    filler = zero_block_chunk()
    offs = []
    for p, ((s, _), (_, _, cnt)) in enumerate(zip(streams, geo)):
        if s.size != cnt:
            raise ValueError(f"plane {p}: expected {cnt} chunks, stream "
                             f"has {s.size}")
        offs.append(np.concatenate([[0], np.cumsum(s, dtype=np.int64)]))
    queued = []
    for d, dev in enumerate(devs):
        segments = []
        for (s, c), off, (n_loc, live, _) in zip(streams, offs, geo):
            lo = min(d * n_loc, s.size)
            segments.append((s[lo:lo + live[d]],
                             c[off[lo]:off[lo + live[d]]]))
            if n_loc > live[d]:
                npad = n_loc - live[d]
                segments.append((np.full(npad, filler.size, np.uint8),
                                 np.tile(filler, npad)))
        content, sizes = device_stream.streams_to_device(segments, dev)
        offsets = torch.cumsum(sizes, 0, dtype=torch.int64) - sizes
        dct, qt = params[dev]
        queued.append(device_stream.frame_planes(
            content, sizes, offsets, qt, dct, sl, w, precision=precision))
    out = tuple(np.empty((rows, cols), np.uint8) for rows, cols in
                ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    for d, (*planes, err) in enumerate(queued):
        _check_err(err.cpu().numpy(), d, "Huffman decode")
        for o, p, rows in zip(out, planes, (sl, sl // 2, sl // 2)):
            live = o[d * rows:(d + 1) * rows]     # pad rows are dropped
            if live.shape[0]:
                torch.from_numpy(live).copy_(p[:live.shape[0]])
    return out


def compress_batch_sharded(mesh: Mesh, planes_np: Sequence[np.ndarray],
                           qtables_np: Sequence[np.ndarray],
                           precision: str = "exact") -> List[List[Stream]]:
    """[B, H, W] (+ 2x [B, H/2, W/2]) uint8 planes -> per-frame
    [(sizes u8, content u8) x3], on every process.

    Frames split over the processes (``distributed.local_shard``); each
    process codes its frames one by one over ``mesh``, its process-local
    devices, with ``compress_frame_sharded`` at ``precision``;
    ``distributed.gather_streams`` then gives every process every frame's
    streams. One process: its frames' streams.
    """
    y, u, v = [np.ascontiguousarray(p) for p in planes_np]
    b, h, w = y.shape
    lo, hi = distributed.local_shard(b)
    frames = [compress_frame_sharded(mesh, (y[f], u[f], v[f]), qtables_np,
                                     precision)
              for f in range(lo, hi)]
    if distributed.process_info()[1] == 1:
        return frames
    flat = [stream for streams in frames for stream in streams]
    all_sizes, all_content = distributed.gather_streams(
        np.concatenate([s for s, _ in flat] or [np.zeros(0, np.uint8)]),
        np.concatenate([c for _, c in flat] or [np.zeros(0, np.uint8)]))
    counts = plane_block_counts(h, w)
    out, spos, cpos = [], 0, 0
    for _ in range(b):
        streams = []
        for cnt in counts:
            s = all_sizes[spos:spos + cnt]
            t = int(s.sum(dtype=np.int64))
            streams.append((s, all_content[cpos:cpos + t]))
            spos, cpos = spos + cnt, cpos + t
        out.append(streams)
    return out
