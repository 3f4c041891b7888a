"""In-memory Dataset of TableBatch partitions.

Counterpart of the in-memory part of ``nvtabular_tpu/io/dataset.py``
(``_MemoryPartition`` :113-128, ``Dataset`` :301-489, the in-memory branch
of ``shuffle_by_keys`` :565-607). Parquet and CSV reading and the shuffle's
spill to parquet are not ported yet (ROADMAP.md queue 1 item 1: parquet I/O).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import torch

from ..schema import Schema
from ..table import TableBatch, concat_rows

UNSUPPORTED_SPILL = (
    "shuffle_by_keys past memory_limit spills to parquet, which is not ported yet "
    "(ROADMAP.md queue 1 item 1: parquet I/O)"
)


def _as_batch(part) -> TableBatch:
    if isinstance(part, TableBatch):
        return part
    if isinstance(part, dict):
        return TableBatch.from_pydict(part)
    raise NotImplementedError(
        f"Dataset partitions must be TableBatches or dicts of arrays, got {type(part)}; "
        "file-backed datasets are not ported yet (ROADMAP.md queue 1: parquet I/O)"
    )


class Dataset:
    """A list of in-memory partitions, streamed as TableBatches."""

    def __init__(self, source, schema: Optional[Schema] = None):
        if isinstance(source, Dataset):
            self._partitions = list(source._partitions)
            schema = schema or source._schema
        elif isinstance(source, (list, tuple)):
            self._partitions = [_as_batch(p) for p in source]
        else:
            self._partitions = [_as_batch(source)]
        self._schema = schema

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = self._partitions[0].infer_schema() if self._partitions else Schema()
        return self._schema

    @property
    def npartitions(self) -> int:
        return len(self._partitions)

    @property
    def num_rows(self) -> int:
        return sum(p.num_rows for p in self._partitions)

    def estimated_nbytes(self) -> int:
        """Bytes the partitions' tensors hold (values, offsets, validity)."""
        return sum(
            t.numel() * t.element_size()
            for p in self._partitions
            for c in p.columns.values()
            for t in (c.values, c.offsets, c.validity)
            if t is not None
        )

    def to_batches(
        self, columns: Optional[List[str]] = None, prefetch: int = 2, shard: Optional[Tuple[int, int]] = None
    ) -> Iterator[TableBatch]:
        """Stream partitions; each batch carries its global ``row_offset``.
        ``shard=(rank, world)`` deals the partitions round robin and streams
        rank's share (io/dataset.py:446-470); row offsets stay global, so a
        row's fold and position are those of the unsharded stream. The
        partitions are in memory already, so ``prefetch`` has nothing to
        overlap."""
        offset = 0
        for i, part in enumerate(self._partitions):
            if shard is None or i % shard[1] == shard[0]:
                batch = part.select([c for c in columns if c in part]) if columns else part.copy()
                batch.row_offset = offset
                yield batch
            offset += part.num_rows

    def shuffle_by_keys(self, keys: List[str], npartitions: Optional[int] = None,
                        memory_limit: Optional[int] = None, spill_dir: Optional[str] = None,
                        *, device=None) -> "Dataset":
        """Repartition so that all rows with equal key values land in one
        partition, in their input order (io/dataset.py:565-607): a row goes
        to ``h % npartitions`` for ``h = h * 31 + hash_array(key, seed=17)``
        over the keys, in uint32, where float keys hash their float64 bits as
        the reference's host shuffle does. The hash and the stable sort of
        the destinations run on ``device`` (the card unless the caller asks
        for the CPU: kernel K7 there), the gathers on the partitions' own
        device. Empty partitions are dropped. A dataset estimated above
        ``memory_limit`` (default: a quarter of the host's memory, or
        ``NVT_SHUFFLE_MEMORY_LIMIT`` bytes) would spill to parquet, which
        raises."""
        from ..workflow.workflow import resolve_device

        if memory_limit is None:
            memory_limit = _default_shuffle_memory_limit()
        if self.estimated_nbytes() > memory_limit:
            raise NotImplementedError(UNSUPPORTED_SPILL)
        nparts = npartitions or self.npartitions
        device = resolve_device(device)
        buckets: List[List[TableBatch]] = [[] for _ in range(nparts)]
        for batch in self.to_batches():
            for b, sub in _bucket_batch(batch, keys, nparts, device):
                buckets[b].append(sub)
        return Dataset([concat_rows(bs) for bs in buckets if bs], schema=self._schema)


def _bucket_batch(batch: TableBatch, keys: List[str], nparts: int, device):
    """(bucket, rows of the batch routed there, in order) pairs."""
    from ..dispatch import hash_array

    h = None
    for k in keys:
        hk = hash_array(batch[k].values.to(device), seed=17, float_bits=64)
        h = hk if h is None else (h * 31 + hk) & 0xFFFFFFFF
    dest = h % nparts
    order = torch.sort(dest, stable=True).indices.to(batch.device)
    bounds = torch.cumsum(torch.bincount(dest, minlength=nparts), 0).tolist()
    lo = 0
    for b, hi in enumerate(bounds):
        if hi > lo:
            yield b, batch.take(order[lo:hi])
        lo = hi


def _default_shuffle_memory_limit() -> int:
    env = os.environ.get("NVT_SHUFFLE_MEMORY_LIMIT")
    if env:
        return int(env)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4
