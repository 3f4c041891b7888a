"""Shuffled multi-file parquet writer.

Counterpart of ``nvtabular_tpu/io/writer.py`` (:99-820) on its native path:
one worker thread per output file, fed by a bounded queue, writes its file
with the C++ encoder (``native_parquet.NativeParquetFile``), the shuffle
window's gather fused into the encode. The seeds are the reference's (file
``i`` of a writer seeded ``seed`` draws from ``default_rng(seed * 1000 +
i)``, the window seeds from ``default_rng(seed)``), so for the same batches
the files and ``_metadata.json`` equal the JAX package's byte for byte.

Every window is written natively, the first small one too (the reference
sends a first window under ``NVT_NATIVE_PARQUET_MIN_ROWS`` rows to arrow:
there its bytes differ from the port's, its rows do not). Columns are
flat int32/int64/float32/float64 without a real null (an all-True validity
mask is dropped); lists, real nulls, other dtypes and codecs other than
zstd raise NotImplementedError naming ROADMAP.md queue 1 item 16. The
reference's fused stream (``transform=``, ``fused_spec=``) is item 11.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import List, Optional

import numpy as np

from ..table import TableBatch
from . import native_parquet as npq
from .shuffle import Shuffle

_SENTINEL = object()


def resolve_compression(compression: Optional[str]) -> Optional[str]:
    """The writer's codec setting: None reads ``NVT_PARQUET_COMPRESSION``,
    by default "auto" where the library was built with zstd and "none"
    where it was not; "none" or "" means uncompressed (None). An explicit
    "auto" or "zstd" without zstd raises at the first page."""
    if compression is None:
        compression = os.environ.get("NVT_PARQUET_COMPRESSION", "auto" if npq.has_zstd() else "none")
    return None if compression in ("none", "") else compression


def _plan(compression):
    """Per-column (encoding, codec, level) plan: "auto" (ints DELTA
    uncompressed, floats BYTE_STREAM_SPLIT + zstd), "zstd" or None (ints
    DELTA, floats BYTE_STREAM_SPLIT, every column zstd or uncompressed)."""
    if compression == "auto":
        return npq.default_column_plan
    if compression not in (None, "zstd"):
        raise npq.unsupported(f"the {compression} codec")

    def plan(name, dtype):
        enc = npq.ENC_DELTA if np.dtype(dtype).kind in "iu" else npq.ENC_BYTE_STREAM_SPLIT
        if compression is None:
            return enc, npq.CODEC_UNCOMPRESSED, 0
        return enc, npq.CODEC_ZSTD, npq.zstd_level()

    return plan


def _host_values(batch: TableBatch, name: str) -> np.ndarray:
    """A column's values as numpy, for the encoder."""
    col = batch[name]
    if col.is_list:
        raise npq.unsupported(f"list columns ({name})")
    if col.validity is not None and not bool(col.validity.all()):
        raise npq.unsupported(f"nulls in parquet columns ({name})")
    return col.values.numpy()


class _FileWorker:
    """Single-writer thread for one output parquet file."""

    def __init__(self, path: str, compression, buffer_pieces: int, queue_depth: int, seed: int = 0,
                 file_k: int = 0, nfiles: int = 1):
        self.path = path
        self.compression = compression
        self.buffer_pieces = max(1, buffer_pieces)
        self.file_k = file_k
        self.nfiles = nfiles
        self.q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self.native: Optional[npq.NativeParquetFile] = None
        self.error: Optional[BaseException] = None
        self.rng = np.random.default_rng(seed)
        self.thread = threading.Thread(target=self._loop, daemon=True, name=f"nvt-write-{os.path.basename(path)}")
        self.started = False

    def submit(self, item):
        if self.error is not None:
            raise self.error
        if not self.started:
            self.thread.start()
            self.started = True
        self.q.put(item)

    def _loop(self):
        buf: List = []  # (batch, idx, seed): gathers are deferred to the flush
        try:
            while True:
                item = self.q.get()
                if item is _SENTINEL:
                    if buf:
                        self._flush(buf)
                    return
                batch, idx, shuffled, seed = item
                if shuffled:
                    buf.append((batch, idx, seed))
                    if len(buf) >= self.buffer_pieces:
                        self._flush(buf)
                        buf = []
                    continue
                n = batch.num_rows if idx is None else len(idx)
                file = self._file(batch)
                # in the file's schema order, whatever the batch's order
                file.write_row_group([[_host_values(batch, nm)] for nm, _ in file.schema],
                                     None if idx is None else np.asarray(idx, dtype=np.int64), n)
        except BaseException as e:  # surfaced by submit()/close()
            self.error = e
            while True:  # drain so producers never block on a dead worker
                try:
                    if self.q.get_nowait() is _SENTINEL:
                        return
                except queue.Empty:
                    return

    def _file(self, batch: TableBatch) -> npq.NativeParquetFile:
        """The open file, opened on the first window's schema."""
        if self.native is None:
            schema = [(nm, _host_values(batch, nm).dtype) for nm in batch.column_names]
            self.native = npq.NativeParquetFile(self.path, schema, plan=_plan(self.compression))
        return self.native

    def _flush(self, buf: List):
        """Land the buffered pieces in one shuffled row group. Seeded pieces
        (PER_WORKER / PER_PARTITION: ``(batch, None, seed)``) keep this
        file's hash split of each piece, shuffled, with the index built in
        C++; explicit pieces (FULL: ``(batch, idx, None)``) are permuted
        together by this file's generator."""
        batches = [b for b, _, _ in buf]
        file = self._file(batches[0])
        columns = [[_host_values(b, nm) for b in batches] for nm, _ in file.schema]
        if buf[0][2] is not None:
            gidx = npq.build_window_index(
                [b.num_rows for b in batches], [s for _, _, s in buf], self.nfiles, self.file_k,
                int(self.rng.integers(0, 2**63)),
            )
        else:
            pieces = [i if i is not None else np.arange(b.num_rows) for b, i, _ in buf]
            perm = self.rng.permutation(int(sum(len(i) for i in pieces)))
            gidx = npq.pack_gather_index(pieces, perm)
        if len(gidx):
            file.write_row_group(columns, gidx, len(gidx))

    def close(self) -> bool:
        if self.started:
            self.q.put(_SENTINEL)
            self.thread.join()
        if self.error is not None:
            raise self.error
        if self.native is not None:
            self.native.close()
            return True
        return False


class ParquetWriter:
    """Append-mode writer over a fixed set of output files
    ``part_<i>.parquet``, one worker thread per file (the encode releases
    the GIL, so N files encode N-way parallel and overlap the producer).
    ``compression``: see ``resolve_compression``. ``row_group_size`` is
    accepted and unused, as on the reference's native path: a window is a
    row group."""

    def __init__(self, output_path: str, num_files: int = 1, row_group_size: Optional[int] = None,
                 compression: Optional[str] = None, buffer_partitions: int = 4, queue_depth: int = 4,
                 seed: int = 42):
        os.makedirs(output_path, exist_ok=True)
        self.output_path = output_path
        self.num_files = max(1, num_files)
        self.compression = resolve_compression(compression)
        _plan(self.compression)  # an unsupported codec raises here, not in a worker
        self._paths = [os.path.join(output_path, f"part_{i}.parquet") for i in range(self.num_files)]
        self._workers = [
            _FileWorker(p, self.compression, buffer_partitions, queue_depth, seed=seed * 1000 + i, file_k=i,
                        nfiles=self.num_files)
            for i, p in enumerate(self._paths)
        ]
        self._next = 0
        self._seed_rng = np.random.default_rng(seed)

    def append(self, batch: TableBatch, file_idx: Optional[int] = None):
        """The batch, unshuffled, to file ``file_idx`` (round robin by default)."""
        if batch.num_rows == 0:
            return
        idx = self._next if file_idx is None else file_idx % self.num_files
        if file_idx is None:
            self._next = (self._next + 1) % self.num_files
        self._workers[idx].submit((batch, None, False, None))

    def append_shuffled(self, batch: TableBatch):
        """Streamed shuffle: the whole batch and a fresh seed to every file
        worker; each keeps its disjoint hash-split share and shuffles it
        within its window."""
        if batch.num_rows == 0:
            return
        seed = int(self._seed_rng.integers(0, 2**63))
        for w in self._workers:
            w.submit((batch, None, True, seed))

    def append_split(self, batch: TableBatch, perm=None, shuffled: Optional[bool] = None):
        """One batch split across all output files: with ``perm`` (a
        permutation of its rows) file ``i`` receives a uniform random subset
        in random order, which its worker permutes again with its window."""
        n = batch.num_rows
        if n == 0:
            return
        if shuffled is None:
            shuffled = perm is not None
        per = max(1, n // self.num_files)
        start = 0
        for i in range(self.num_files):
            length = per if i < self.num_files - 1 else n - start
            if length <= 0:
                break
            if perm is not None:
                piece = (batch, perm[start: start + length], shuffled, None)
            else:
                piece = (batch.take(np.arange(start, start + length)), None, shuffled, None)
            self._workers[i].submit(piece)
            start += length

    def close(self) -> List[str]:
        paths, errors = [], []
        for p, w in zip(self._paths, self._workers):
            try:
                if w.close():
                    paths.append(p)
            except BaseException as e:
                errors.append(e)
        if errors:
            raise errors[0]
        return paths


def write_dataset(dataset, output_path: str, shuffle: Optional[Shuffle] = None, out_files: int = 1,
                  row_group_size: Optional[int] = None, buffer_partitions: int = 4, seed: int = 42,
                  compression: Optional[str] = None) -> List[str]:
    """Write ``dataset``'s batches to ``out_files`` parquet files, shuffled
    as ``shuffle`` says (JAX writer.py:742-812): FULL permutes the whole
    table; PER_WORKER and PER_PARTITION hash-split each batch over every
    file as it arrives, PER_WORKER shuffling within windows of
    ``buffer_partitions`` batches; None appends batches round robin. The
    batches go to the host first."""
    writer = ParquetWriter(
        output_path, out_files, row_group_size, compression,
        buffer_partitions=buffer_partitions if shuffle in (Shuffle.PER_WORKER, Shuffle.FULL) else 1, seed=seed,
    )
    rng = np.random.default_rng(seed)
    try:
        if shuffle == Shuffle.FULL:
            table = dataset.to_table().to("cpu")
            writer.append_split(table, perm=rng.permutation(table.num_rows))
        elif shuffle in (Shuffle.PER_WORKER, Shuffle.PER_PARTITION):
            for batch in dataset.to_batches(prefetch=1):
                writer.append_shuffled(batch.to("cpu"))
        else:
            for batch in dataset.to_batches(prefetch=1):
                writer.append(batch.to("cpu"))
    finally:
        paths = writer.close()
    _write_metadata(output_path, paths)
    return paths


def _write_metadata(output_path: str, paths: List[str]):
    with open(os.path.join(output_path, "_metadata.json"), "w") as f:
        json.dump({"files": [os.path.basename(p) for p in paths]}, f)
