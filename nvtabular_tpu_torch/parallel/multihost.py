"""Multi-process coordination for the fit engine, on ``torch.distributed``.

Counterpart of ``nvtabular_tpu/parallel/multihost.py:39-76``. Every process
(one rank a GPU) streams its round-robin shard of partitions
(``Dataset.to_batches(shard=(process_index(), process_count()))``); the
per-op states are then exchanged with one ``all_gather_object`` and merged
identically on every rank by ``fit_merge``. With no process group
initialized there is one process.
"""

from __future__ import annotations

from typing import Any, List

import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def allgather_pyobj(obj: Any, group=None) -> List[Any]:
    """One picklable object from every rank of ``group`` (the default group
    when None), in rank order. One process: ``[obj]``. An NCCL group needs
    the rank's CUDA device set first (``initialize_distributed`` sets it)."""
    if not _initialized():
        return [obj]
    n = dist.get_world_size(group)
    if n == 1:
        return [obj]
    out: List[Any] = [None] * n
    dist.all_gather_object(out, obj, group=group)
    return out
