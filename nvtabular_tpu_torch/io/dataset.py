"""In-memory Dataset of TableBatch partitions.

Counterpart of the in-memory part of ``nvtabular_tpu/io/dataset.py``
(``_MemoryPartition`` :113-128, ``Dataset`` :301-489). Parquet and CSV
reading are not ported yet (ROADMAP.md queue 1: parquet I/O).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from ..schema import Schema
from ..table import TableBatch


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

    def to_batches(
        self, columns: Optional[List[str]] = None, shard: Optional[Tuple[int, int]] = None
    ) -> Iterator[TableBatch]:
        """Stream partitions; each batch carries its global ``row_offset``.
        ``shard=(rank, world)`` deals the partitions round robin and streams
        rank's share (io/dataset.py:446-470); row offsets stay global, so a
        row's fold and position are those of the unsharded stream."""
        offset = 0
        for i, part in enumerate(self._partitions):
            if shard is None or i % shard[1] == shard[0]:
                batch = part.select([c for c in columns if c in part]) if columns else part.copy()
                batch.row_offset = offset
                yield batch
            offset += part.num_rows
