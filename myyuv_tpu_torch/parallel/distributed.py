"""Multi-process orchestration: initialization, sharded batches, the ragged
gather of compressed streams and the sums of the RD statistics.

Port of ``myyuv_tpu/parallel/distributed.py`` (:31-136) on
``torch.distributed`` with the gloo backend. The gathered data is host
bytes (numpy) and the sums run on CPU tensors, as the JAX package's
``process_allgather`` gathers host arrays: gloo needs no card, and two
processes may share one card (NCCL refuses two ranks on one GPU).

* ``initialize`` joins the process group; it does nothing for one
  process (tests, a single-process run).
* ``gather_streams`` is the multi-process ragged gather: every process
  codes its local frames, the chunk-size tables and contents are
  all-gathered, and each process's segment lands at the exclusive prefix
  sum of the preceding processes' byte totals (``global_offsets``, the
  cross-process generalisation of DCTYUVPlane::getContentPos,
  DCT.cpp:21-33), so every process can assemble the same ``.myyuv``
  payload.

Every all-gather pads to the longest process's length, with at least one
element and a dtype that is the same on every process (int64 for sizes):
gloo needs equal shapes and dtypes on all ranks, and a tail process may
hold nothing when the batch does not divide over the processes (the rule
the JAX package's 4-process test found).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join a gloo process group of ``num_processes`` at
    ``coordinator_address`` ("host:port", served by process 0); nothing for
    at most one process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> Tuple[int, int]:
    """(this process's index, the number of processes)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_shard(n_items: int) -> Tuple[int, int]:
    """[start, stop) of this process's share of a global batch."""
    pid, pcount = process_info()
    per = (n_items + pcount - 1) // pcount
    return min(pid * per, n_items), min((pid + 1) * per, n_items)


def _allgather(x: np.ndarray) -> np.ndarray:
    """A 1-D array of the same length and dtype on every process ->
    [processes, length]."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(process_info()[1])]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _allgather_ragged(local: np.ndarray, lengths: np.ndarray,
                      dtype) -> List[np.ndarray]:
    """Each process's 1-D ``local`` (``lengths[p]`` elements on process p),
    gathered through a zero-padded ``dtype`` buffer of the longest length
    and at least one element."""
    pad = np.zeros(max(int(lengths.max()), 1), dtype)
    pad[:local.size] = local
    rows = _allgather(pad)
    return [rows[p, :int(n)] for p, n in enumerate(lengths)]


def allgather_sizes(local_sizes: np.ndarray) -> List[np.ndarray]:
    """Every process's chunk-size table, in process order. One process:
    ``[local_sizes]``."""
    local_sizes = np.ascontiguousarray(local_sizes)
    if process_info()[1] == 1:
        return [local_sizes]
    n = _allgather(np.array([local_sizes.size], np.int64))[:, 0]
    dt = local_sizes.dtype if local_sizes.size else np.uint8
    return [s.astype(dt)
            for s in _allgather_ragged(local_sizes, n, np.int64)]


def global_offsets(all_sizes: Sequence[np.ndarray]) -> np.ndarray:
    """Byte offset of each process's content in the merged stream."""
    totals = np.array([int(s.astype(np.int64).sum()) for s in all_sizes],
                      np.int64)
    return np.concatenate([[0], np.cumsum(totals)[:-1]])


def shard_batch(batch, mesh: Mesh) -> List[torch.Tensor]:
    """Split this process's batch ([B, ...] numpy array or tensor) over the
    mesh's data axis: one tensor per data row, on that row's first device,
    frames in order. Raises ValueError unless B divides over the rows."""
    t = torch.as_tensor(batch)
    rows = mesh.shape[0]
    if t.shape[0] % rows:
        raise ValueError(f"batch of {t.shape[0]} does not divide over "
                         f"{rows} data rows")
    return [part.to(row[0])
            for part, row in zip(torch.tensor_split(t, rows), mesh.devices)]


def allreduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of a CPU tensor over the processes (itself for one)."""
    if process_info()[1] == 1:
        return t
    out = t.clone()
    dist.all_reduce(out)
    return out


def gather_streams(local_sizes: np.ndarray, local_content: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge the processes' compressed streams into the global (sizes,
    content), process after process, on every process. One process:
    the local stream itself."""
    local_sizes = np.ascontiguousarray(local_sizes)
    local_content = np.ascontiguousarray(local_content, np.uint8)
    if process_info()[1] == 1:
        return local_sizes, local_content
    lens = _allgather(np.array([local_sizes.size, local_content.size],
                               np.int64))
    dt = local_sizes.dtype if local_sizes.size else np.uint8
    sizes = np.concatenate(
        _allgather_ragged(local_sizes, lens[:, 0], np.int64)).astype(dt)
    content = np.concatenate(
        _allgather_ragged(local_content, lens[:, 1], np.uint8))
    return sizes, content
