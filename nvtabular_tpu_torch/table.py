"""Columnar batch over torch tensors — the unit of data flowing through the DAG.

Counterpart of ``nvtabular_tpu/table.py``. A ``TableBatch`` is an ordered
dict of named ``Column``s with equal row counts. A column holds

* ``values``: a 1-D torch tensor (flat values of a list column);
* ``offsets``: int64 row offsets for a list column, else None;
* ``validity``: an optional bool mask, True where the row is valid.

Float NaN also counts as null in ``is_null``, as in the JAX package. Every
tensor of a batch lives on one device; ``to(device)`` moves them and
``to_host()`` returns numpy arrays. String/object columns are not covered by
this slice of the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from . import dtypes as md
from .schema import ColumnSchema, Schema

_TORCH_TO_NUMPY = {
    torch.bool: np.dtype(np.bool_),
    torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64),
    torch.uint8: np.dtype(np.uint8),
    torch.float16: np.dtype(np.float16),
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}
_NUMPY_TO_TORCH = {v: k for k, v in _TORCH_TO_NUMPY.items()}

UNSUPPORTED_STRINGS = (
    "string/object columns are not ported yet "
    "(ROADMAP.md queue 1: strings and hybrid execution)"
)
UNSUPPORTED_LISTS = (
    "list columns are not ported for this op yet (ROADMAP.md queue 1 item 5: lists)"
)


def torch_to_numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return _TORCH_TO_NUMPY[dtype]


def to_torch_dtype(dtype) -> torch.dtype:
    """Any dtype-like (torch, numpy, md.DType, str) → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if md.normalize(dtype).name == "bfloat16":  # numpy has no bfloat16
        return torch.bfloat16
    npd = md.to_numpy(dtype)
    if npd not in _NUMPY_TO_TORCH:
        raise NotImplementedError(f"dtype {npd} has no torch counterpart in this port")
    return _NUMPY_TO_TORCH[npd]


def as_tensor(values) -> torch.Tensor:
    """Tensor view of array-like values (numpy arrays are shared, not copied)."""
    if isinstance(values, Column):
        return values.values
    if isinstance(values, torch.Tensor):
        return values
    arr = np.asarray(values)
    if arr.dtype.kind in ("O", "U", "S", "M"):
        raise NotImplementedError(UNSUPPORTED_STRINGS)
    return torch.from_numpy(np.ascontiguousarray(arr))


class Column:
    """One column: flat values, optional list offsets, optional validity mask."""

    __slots__ = ("values", "offsets", "validity")

    def __init__(self, values, offsets=None, validity=None):
        self.values = as_tensor(values)
        self.offsets = as_tensor(offsets) if offsets is not None else None
        self.validity = as_tensor(validity) if validity is not None else None
        if self.validity is not None and self.validity.dtype != torch.bool:
            self.validity = self.validity.to(torch.bool)

    @property
    def is_list(self) -> bool:
        return self.offsets is not None

    @property
    def dtype(self) -> md.DType:
        if self.values.dtype == torch.bfloat16:
            return md.bfloat16
        return md.normalize(torch_to_numpy_dtype(self.values.dtype))

    @property
    def device(self) -> torch.device:
        return self.values.device

    def __len__(self) -> int:
        if self.offsets is not None:
            return int(self.offsets.shape[0]) - 1
        return int(self.values.shape[0])

    def is_null(self) -> torch.Tensor:
        """Bool tensor, True where the row is null (mask or NaN)."""
        out = None
        if self.validity is not None:
            out = ~self.validity
        if not self.is_list and self.values.is_floating_point():
            nan = torch.isnan(self.values)
            out = nan if out is None else (out | nan)
        if out is None:
            out = torch.zeros(len(self), dtype=torch.bool, device=self.device)
        return out

    def astype(self, dtype) -> "Column":
        return Column(self.values.to(to_torch_dtype(dtype)), self.offsets, self.validity)

    @property
    def row_lengths(self) -> torch.Tensor:
        """int64 length of each row of a list column."""
        return self.offsets[1:] - self.offsets[:-1]

    def take(self, indices) -> "Column":
        """Rows gathered by index (table.py:140 of the JAX package). A list
        column gathers each row's values and rebuilds its offsets from 0."""
        idx = as_tensor(indices).to(device=self.device, dtype=torch.int64)
        valid = self.validity[idx] if self.validity is not None else None
        if not self.is_list:
            return Column(self.values[idx], None, valid)
        lengths = self.row_lengths[idx]
        offsets = torch.zeros(idx.shape[0] + 1, dtype=torch.int64, device=self.device)
        torch.cumsum(lengths, 0, out=offsets[1:])
        total = int(offsets[-1])
        flat = torch.repeat_interleave(self.offsets[:-1][idx] - offsets[:-1], lengths, output_size=total)
        flat += torch.arange(total, dtype=torch.int64, device=self.device)
        return Column(self.values[flat], offsets, valid)

    def to(self, device) -> "Column":
        def move(t):
            return None if t is None else t.to(device)

        return Column(move(self.values), move(self.offsets), move(self.validity))

    def __array__(self, dtype=None, copy=None):
        """numpy interop on the host: a Column reads as its (flat) values, so
        numpy ufuncs apply directly (the UDF / LambdaOp contract). A column
        on another device raises rather than copy behind the caller's back."""
        if self.device.type != "cpu":
            raise TypeError(f"numpy reads host columns only; this one is on {self.device}")
        arr = self.values.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        kind = "list" if self.is_list else "scalar"
        return f"Column({kind}, {self.dtype.name}, n={len(self)}, device={self.device})"


def as_column(data) -> Column:
    if isinstance(data, Column):
        return data
    if isinstance(data, list) and data and isinstance(data[0], (list, np.ndarray)):
        lengths = np.array([len(x) for x in data], dtype=np.int64)
        offsets = np.zeros(len(data) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        return Column(np.concatenate([np.asarray(x) for x in data]), offsets)
    return Column(data)


class TableBatch:
    """Ordered dict of named Columns with equal row counts."""

    def __init__(self, columns: Optional[Dict[str, Any]] = None):
        self._columns: Dict[str, Column] = {}
        # global row index of this batch's first row within its dataset scan
        self.row_offset: int = 0
        if columns:
            for name, col in columns.items():
                self[name] = col

    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    @property
    def columns(self) -> Dict[str, Column]:
        return self._columns

    @property
    def num_rows(self) -> int:
        for col in self._columns.values():
            return len(col)
        return 0

    @property
    def device(self) -> torch.device:
        for col in self._columns.values():
            return col.device
        return torch.device("cpu")

    def __len__(self):
        return self.num_rows

    def __contains__(self, name):
        return name in self._columns

    def __iter__(self):
        return iter(self._columns)

    def __getitem__(self, name: str) -> Column:
        return self._columns[name]

    def __setitem__(self, name: str, col):
        col = as_column(col)
        if self._columns and len(col) != self.num_rows:
            raise ValueError(f"column {name!r} has {len(col)} rows, table has {self.num_rows}")
        self._columns[name] = col

    def copy(self) -> "TableBatch":
        out = TableBatch()
        out._columns = dict(self._columns)
        out.row_offset = self.row_offset
        return out

    def select(self, names: Iterable[str]) -> "TableBatch":
        out = TableBatch()
        out.row_offset = self.row_offset
        for n in names:
            out._columns[n] = self._columns[n]
        return out

    def drop(self, names: Iterable[str]) -> "TableBatch":
        drop = set(names)
        return self.select([n for n in self._columns if n not in drop])

    def to(self, device) -> "TableBatch":
        out = TableBatch()
        out.row_offset = self.row_offset
        for n, c in self._columns.items():
            out._columns[n] = c.to(device)
        return out

    def take(self, indices) -> "TableBatch":
        """Rows gathered by index from every column (table.py:356)."""
        out = TableBatch()
        out.row_offset = self.row_offset
        for n, c in self._columns.items():
            out._columns[n] = c.take(indices)
        return out

    def filter(self, mask) -> "TableBatch":
        """The rows where the bool ``mask`` is True, in order (table.py:370)."""
        mask = as_tensor(mask).to(self.device)
        if mask.dtype != torch.bool:
            raise TypeError(f"filter takes a bool mask, got {mask.dtype}")
        return self.take(torch.nonzero(mask).reshape(-1))

    def to_host(self) -> Dict[str, np.ndarray]:
        """numpy view of the batch: ``name`` → values, plus ``name__offsets``
        and ``name__validity`` where a column has them."""
        out = {}
        for name, col in self._columns.items():
            out[name] = col.values.cpu().numpy()
            if col.offsets is not None:
                out[f"{name}__offsets"] = col.offsets.cpu().numpy()
            if col.validity is not None:
                out[f"{name}__validity"] = col.validity.cpu().numpy()
        return out

    def infer_schema(self) -> Schema:
        return Schema(
            [
                ColumnSchema(name, dtype=col.dtype, is_list=col.is_list, is_ragged=col.is_list)
                for name, col in self._columns.items()
            ]
        )

    @classmethod
    def from_pydict(cls, data: Dict[str, Any]) -> "TableBatch":
        out = cls()
        for name, values in data.items():
            out[name] = as_column(values)
        return out

    def __repr__(self):
        cols = ", ".join(
            f"{n}:{c.dtype.name}{'[list]' if c.is_list else ''}" for n, c in self._columns.items()
        )
        return f"TableBatch(rows={self.num_rows}, device={self.device}, [{cols}])"


def concat_rows(batches: Sequence[TableBatch]) -> TableBatch:
    """Batches stacked row-wise, on the first batch's device (table.py:596):
    empty batches are skipped, list offsets continue from the rows before,
    and a validity mask is all True where a batch has none."""
    batches = [b for b in batches if b.num_rows > 0] or list(batches[:1])
    if len(batches) == 1:
        return batches[0]
    device = batches[0].device
    out = TableBatch()
    for name in batches[0].column_names:
        cols = [b[name].to(device) for b in batches]
        validity = None
        if any(c.validity is not None for c in cols):
            validity = torch.cat(
                [c.validity if c.validity is not None else torch.ones(len(c), dtype=torch.bool, device=device)
                 for c in cols]
            )
        offsets = None
        if cols[0].is_list:
            parts, total = [cols[0].offsets], cols[0].offsets[-1]
            for c in cols[1:]:
                parts.append(c.offsets[1:] - c.offsets[0] + total)
                total = parts[-1][-1]
            offsets = torch.cat(parts)
            values = torch.cat([c.values[int(c.offsets[0]) : int(c.offsets[-1])] for c in cols])
            offsets = offsets - offsets[0]
        else:
            values = torch.cat([c.values for c in cols])
        out._columns[name] = Column(values, offsets, validity)
    return out


def concat_columns(batches: Sequence[TableBatch]) -> TableBatch:
    """Horizontally concatenate batches (later batches win on name clash)."""
    out = TableBatch()
    if batches:
        out.row_offset = batches[0].row_offset
    for b in batches:
        out._columns.update(b.columns)
    return out
