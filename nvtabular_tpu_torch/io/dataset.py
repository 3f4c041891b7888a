"""Dataset: a list of partitions, in memory or parquet row-group ranges.

Counterpart of ``nvtabular_tpu/io/dataset.py``. A partition is a
``TableBatch`` held in memory (``_MemoryPartition`` :113-128), a range of
row groups of one parquet file (``_ParquetPartition`` :131-157), or a view
over row ranges of other partitions (``_SegmentsPartition``, from
``repartition``). Files are planned into partitions of at most
``part_size`` bytes of row-group ``total_byte_size`` (``_plan_parquet``
:391-410), the reference's plan for the same files, and read by the port's
own reader (``native_parquet.py``) into CPU tensors.

``shuffle_by_keys`` hashes and sorts each batch's keys on the card (K7) and
gathers in memory; past its memory limit it spills each bucket to a parquet
file as batches stream through, one partition per bucket file (:632-660).
CSV, ``merge`` and remote paths raise NotImplementedError naming ROADMAP.md
queue 1 item 16.
"""

from __future__ import annotations

import glob as globmod
import math
import os
import queue
import tempfile
import threading
from typing import Iterator, List, Optional, Tuple, Union

import torch

from ..schema import ColumnSchema, Schema
from ..table import Column, TableBatch, concat_rows
from . import native_parquet as npq
from .shuffle import check_shuffle_arg

DEFAULT_PART_SIZE = 128 * 1024 * 1024  # bytes of row-group data per partition


def _expand_paths(source) -> List[str]:
    """Files of a path, a directory (its .parquet/.pq/.csv files, sorted),
    a glob, or a list of them."""
    if isinstance(source, (list, tuple)):
        return [p for s in source for p in _expand_paths(s)]
    source = str(source)
    if "://" in source and not source.startswith("file://"):
        raise npq.unsupported(f"remote paths ({source})")
    if source.startswith("file://"):
        source = source[len("file://"):]
    if os.path.isdir(source):
        return sorted(os.path.join(source, f) for f in os.listdir(source) if f.endswith((".parquet", ".pq", ".csv")))
    if any(ch in source for ch in "*?["):
        return sorted(globmod.glob(source))
    return [source]


def _as_batch(part) -> TableBatch:
    if isinstance(part, TableBatch):
        return part
    if isinstance(part, dict):
        return TableBatch.from_pydict(part)
    raise TypeError(f"Dataset partitions must be TableBatches or dicts of arrays, got {type(part)}")


def _tensor_nbytes(batch: TableBatch) -> int:
    """Bytes the batch's tensors hold (values, offsets, validity)."""
    return sum(
        t.numel() * t.element_size()
        for c in batch.columns.values()
        for t in (c.values, c.offsets, c.validity)
        if t is not None
    )


class _Partition:
    """One unit of I/O work."""

    def load(self, columns: Optional[List[str]] = None) -> TableBatch:
        raise NotImplementedError

    @property
    def num_rows(self) -> int:
        raise NotImplementedError

    @property
    def nbytes(self) -> int:
        """Estimated bytes when loaded (drives the spill decision)."""
        raise NotImplementedError


class _MemoryPartition(_Partition):
    def __init__(self, batch: TableBatch):
        self.batch = batch

    def load(self, columns=None) -> TableBatch:
        b = self.batch
        return b.select([c for c in columns if c in b]) if columns else b.copy()

    @property
    def num_rows(self) -> int:
        return self.batch.num_rows

    @property
    def nbytes(self) -> int:
        return _tensor_nbytes(self.batch)


class _ParquetPartition(_Partition):
    def __init__(self, path: str, row_groups: List[int], rows: int, nbytes: int):
        self.path = path
        self.row_groups = row_groups
        self.rows = rows
        self._nbytes = nbytes

    def load(self, columns=None) -> TableBatch:
        arrays = npq.read_row_groups(self.path, self.row_groups, columns)
        return TableBatch({name: Column(torch.from_numpy(a)) for name, a in arrays.items()})

    @property
    def num_rows(self) -> int:
        return self.rows

    @property
    def nbytes(self) -> int:
        return self._nbytes


class _SegmentsPartition(_Partition):
    """A lazy view over row ranges of other partitions: loads only its own
    segments, so ``repartition`` never materializes the dataset."""

    def __init__(self, segments: List[Tuple[_Partition, int, int]]):
        self.segments = segments  # (source partition, start row, length)

    def load(self, columns=None) -> TableBatch:
        pieces = [
            src.load(columns).take(torch.arange(start, start + length)) for src, start, length in self.segments
        ]
        return concat_rows(pieces)

    @property
    def num_rows(self) -> int:
        return sum(length for _, _, length in self.segments)

    @property
    def nbytes(self) -> int:
        return sum(int(src.nbytes * length / max(src.num_rows, 1)) for src, _, length in self.segments)


class Dataset:
    """A partitioned columnar dataset: in-memory batches (a TableBatch, a
    dict of arrays, or a list of them) or parquet files (a path, a
    directory, a glob, or a list of them)."""

    def __init__(self, source, engine: Optional[str] = None, part_size: Optional[Union[int, str]] = None,
                 part_mem_fraction: Optional[float] = None, cpu: Optional[bool] = None, names=None, sep: str = ",",
                 schema: Optional[Schema] = None, **kwargs):
        """The reference's signature (io/dataset.py:304-315). ``cpu`` is
        accepted and ignored, as there; ``part_mem_fraction`` sizes
        partitions by the card's memory."""
        if part_size is None:
            part_size = (int(part_mem_fraction * _device_mem_size()) if part_mem_fraction is not None
                         else DEFAULT_PART_SIZE)
        elif isinstance(part_size, str):
            part_size = parse_bytes(part_size)
        self.part_size = max(int(part_size), 1024)
        self._schema = schema
        self._spill_tmpdir = None  # keeps shuffle spill files alive with the plan
        self.engine = engine
        if isinstance(source, Dataset):
            self._partitions = list(source._partitions)
            self._schema = schema or source._schema
            self.engine = engine or source.engine
            self._spill_tmpdir = source._spill_tmpdir
        elif isinstance(source, (TableBatch, dict)):
            self._partitions = [_MemoryPartition(_as_batch(source))]
            self.engine = "memory"
        elif isinstance(source, (list, tuple)) and not (source and isinstance(source[0], (str, os.PathLike))):
            self._partitions = [_MemoryPartition(_as_batch(p)) for p in source]
            self.engine = "memory"
        elif isinstance(source, (str, os.PathLike, list, tuple)):
            paths = _expand_paths(source)
            if not paths:
                raise FileNotFoundError(f"No files found for {source!r}")
            self.engine = engine or ("csv" if paths[0].endswith(".csv") else "parquet")
            if self.engine != "parquet":
                raise npq.unsupported(f"the {self.engine} engine")
            self._partitions = self._plan_parquet(paths)
        else:
            raise TypeError(f"Dataset cannot read {type(source)}")

    def _plan_parquet(self, paths: List[str]) -> List[_Partition]:
        """Consecutive row groups of each file, up to ``part_size`` bytes of
        ``total_byte_size`` a partition (io/dataset.py:391-410)."""
        parts: List[_Partition] = []
        for path in paths:
            current: List[int] = []
            cur_bytes = cur_rows = 0
            for rg, meta in enumerate(npq.read_footer(path).row_groups):
                if current and cur_bytes + meta["total_byte_size"] > self.part_size:
                    parts.append(_ParquetPartition(path, current, cur_rows, cur_bytes))
                    current, cur_bytes, cur_rows = [], 0, 0
                current.append(rg)
                cur_bytes += meta["total_byte_size"]
                cur_rows += meta["num_rows"]
            if current:
                parts.append(_ParquetPartition(path, current, cur_rows, cur_bytes))
        return parts

    @classmethod
    def _from_partitions(cls, parts: List[_Partition], like: "Dataset", engine: Optional[str] = None) -> "Dataset":
        out = cls([], part_size=like.part_size, schema=like._schema)
        out._partitions = parts
        out.engine = engine or like.engine
        out._spill_tmpdir = like._spill_tmpdir
        return out

    # --- metadata ------------------------------------------------------------------
    @property
    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = self.infer_schema()
        return self._schema

    @schema.setter
    def schema(self, value: Schema):
        self._schema = value

    def infer_schema(self) -> Schema:
        """From the first file's footer, or the first partition's batch."""
        if not self._partitions:
            return Schema()
        part = self._partitions[0]
        if isinstance(part, _ParquetPartition):
            return Schema([
                ColumnSchema(c.name, dtype=c.dtype, is_list=False, is_ragged=False)
                for c in npq.read_footer(part.path).columns
            ])
        return part.load().infer_schema()

    @property
    def npartitions(self) -> int:
        return len(self._partitions)

    @property
    def num_rows(self) -> int:
        return sum(p.num_rows for p in self._partitions)

    def __len__(self):
        return self.num_rows

    def estimated_nbytes(self) -> int:
        """Estimated bytes of every partition loaded."""
        return sum(p.nbytes for p in self._partitions)

    # --- iteration --------------------------------------------------------------------
    def to_batches(self, columns: Optional[List[str]] = None, prefetch: int = 2,
                   shard: Optional[Tuple[int, int]] = None) -> Iterator[TableBatch]:
        """Stream partitions; each batch carries its global ``row_offset``.
        ``shard=(rank, world)`` deals the partitions round robin and streams
        rank's share (io/dataset.py:446-470); row offsets stay global, so a
        row's fold and position are those of the unsharded stream.
        ``prefetch > 0`` loads file partitions ahead on a thread."""
        offsets, prefix = [], 0
        parts = []
        for i, p in enumerate(self._partitions):
            if shard is None or i % shard[1] == shard[0]:
                parts.append(p)
                offsets.append(prefix)
            prefix += p.num_rows
        loaded = (
            _prefetch_iter(parts, columns, prefetch)
            if prefetch > 0 and len(parts) > 1 and any(isinstance(p, _ParquetPartition) for p in parts)
            else (p.load(columns) for p in parts)
        )
        for offset, batch in zip(offsets, loaded):
            batch.row_offset = offset
            yield batch

    def to_iter(self, columns=None) -> Iterator[TableBatch]:
        return self.to_batches(columns=columns)

    def to_table(self, columns=None) -> TableBatch:
        """The whole dataset as one batch."""
        batches = list(self.to_batches(columns=columns, prefetch=0))
        return concat_rows(batches) if batches else TableBatch()

    def head(self, n: int = 5) -> TableBatch:
        """The first ``n`` rows of the first partition (the reference returns
        them as a pandas DataFrame; the port has no pandas)."""
        return self.sample_batch(n)

    def sample_batch(self, n: int = 1024) -> TableBatch:
        for batch in self.to_batches(prefetch=0):
            return batch.take(torch.arange(min(n, batch.num_rows)))
        return TableBatch()

    # --- repartition / shuffle -----------------------------------------------------------
    def repartition(self, npartitions: int) -> "Dataset":
        """``npartitions`` lazy row-range views of about equal rows
        (io/dataset.py:530-563): loading one touches only the partitions it
        overlaps."""
        rows_per = max(1, math.ceil(self.num_rows / max(npartitions, 1)))
        out_parts: List[_Partition] = []
        segments: List[Tuple[_Partition, int, int]] = []
        need = rows_per
        for src in self._partitions:
            pos = 0
            while pos < src.num_rows:
                take = min(src.num_rows - pos, need)
                segments.append((src, pos, take))
                pos += take
                need -= take
                if need == 0:
                    out_parts.append(_SegmentsPartition(segments))
                    segments, need = [], rows_per
        if segments:
            out_parts.append(_SegmentsPartition(segments))
        return Dataset._from_partitions(out_parts, self)

    def shuffle_by_keys(self, keys: List[str], npartitions: Optional[int] = None,
                        memory_limit: Optional[int] = None, spill_dir: Optional[str] = None,
                        *, device=None) -> "Dataset":
        """Repartition so that all rows with equal key values land in one
        partition, in their input order (io/dataset.py:582-681): a row goes
        to ``h % npartitions`` for ``h = h * 31 + hash_array(key, seed=17)``
        over the keys, in uint32, where float keys hash their float64 bits as
        the reference's host shuffle does. The hash and the stable sort of
        the destinations run on ``device`` (the card unless the caller asks
        for the CPU: kernel K7 there), the gathers on the partitions' own
        device. Empty buckets are dropped. A dataset estimated above
        ``memory_limit`` (default: a quarter of the host's memory, or
        ``NVT_SHUFFLE_MEMORY_LIMIT`` bytes) spills each bucket to a parquet
        file under ``spill_dir`` (a temporary directory by default, kept as
        long as the returned plan), one partition per bucket file."""
        from ..workflow.workflow import resolve_device

        if memory_limit is None:
            memory_limit = _default_shuffle_memory_limit()
        nparts = npartitions or self.npartitions
        device = resolve_device(device)
        if self.estimated_nbytes() > memory_limit:
            return self._shuffle_spill(keys, nparts, spill_dir, device)
        buckets: List[List[TableBatch]] = [[] for _ in range(nparts)]
        for batch in self.to_batches(prefetch=1):
            for b, sub in _bucket_batch(batch, keys, nparts, device):
                buckets[b].append(sub)
        parts = [_MemoryPartition(concat_rows(bs)) for bs in buckets if bs]
        return Dataset._from_partitions(parts, self, engine="memory")

    def _shuffle_spill(self, keys: List[str], nparts: int, spill_dir: Optional[str], device) -> "Dataset":
        from .writer import _host_values, _plan

        tmp = None
        if spill_dir is None:
            tmp = tempfile.TemporaryDirectory(prefix="nvt_shuffle_")
            spill_dir = tmp.name
        os.makedirs(spill_dir, exist_ok=True)
        files = {}
        try:
            for batch in self.to_batches(prefetch=1):
                for b, sub in _bucket_batch(batch, keys, nparts, device):
                    sub = sub.to("cpu")
                    f = files.get(b)
                    if f is None:
                        schema = [(nm, _host_values(sub, nm).dtype) for nm in sub.column_names]
                        f = files[b] = npq.NativeParquetFile(
                            os.path.join(spill_dir, f"bucket_{b:05d}.parquet"), schema, plan=_plan(None))
                    f.write_row_group([[_host_values(sub, nm)] for nm, _ in f.schema], None, sub.num_rows)
        finally:
            for f in files.values():
                f.close()
        # one partition per bucket file: never re-split, or equal keys would scatter
        parts = []
        for b in sorted(files):
            footer = npq.read_footer(files[b].path)
            parts.append(_ParquetPartition(
                footer.path, list(range(len(footer.row_groups))), footer.num_rows,
                sum(rg["total_byte_size"] for rg in footer.row_groups)))
        out = Dataset._from_partitions(parts, self, engine="parquet")
        out._spill_tmpdir = tmp
        return out

    # --- persistence -----------------------------------------------------------------------
    def to_parquet(self, output_path: str, shuffle=None, out_files_per_proc: Optional[int] = None,
                   output_files: Optional[int] = None, row_group_size: Optional[int] = None,
                   compression: Optional[str] = None, **kwargs):
        """Write the batches to parquet files (io/dataset.py:684-703):
        ``output_files``, else ``out_files_per_proc``, else one a partition
        up to 16."""
        from .writer import write_dataset

        write_dataset(
            self, output_path, shuffle=check_shuffle_arg(shuffle),
            out_files=output_files or out_files_per_proc or min(self.npartitions, 16) or 1,
            row_group_size=row_group_size, compression=compression,
        )

    @classmethod
    def merge(cls, left: "Dataset", right: "Dataset", memory_limit: Optional[int] = None, **kwargs):
        raise npq.unsupported("Dataset.merge")

    def __repr__(self):
        return f"<Dataset engine={self.engine} partitions={self.npartitions} columns={len(self.schema)}>"


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


def _prefetch_iter(parts: List[_Partition], columns, depth: int) -> Iterator[TableBatch]:
    """Partitions loaded on a background thread, ``depth`` ahead."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()

    def producer():
        try:
            for p in parts:
                q.put(p.load(columns))
        except BaseException as e:  # handed to the consumer
            q.put(e)
            return
        q.put(done)

    t = threading.Thread(target=producer, daemon=True, name="nvt-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is done:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
    t.join()


def _device_mem_size() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("part_mem_fraction sizes partitions by the card's memory, and no CUDA device is available")
    return torch.cuda.get_device_properties(0).total_memory


def _default_shuffle_memory_limit() -> int:
    env = os.environ.get("NVT_SHUFFLE_MEMORY_LIMIT")
    if env:
        return int(env)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4


def parse_bytes(s: str) -> int:
    """A size string ("512MB", "2 GB", "4096") in bytes (io/dataset.py:839-845)."""
    s = s.strip().upper()
    for suffix, mult in (("KB", 1024), ("MB", 1024**2), ("GB", 1024**3), ("TB", 1024**4), ("B", 1)):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(s)

