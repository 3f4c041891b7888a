"""Groupby (counterpart of nvtabular_tpu/ops/groupby.py): partition-local
group-by aggregation for sessions.

The dataset must be partitioned by the group keys first
(``Dataset.shuffle_by_keys``): a key's rows may not span partitions. Within
a batch the rows sort by the keys (ascending) and then by ``sort_cols``
(ascending, or descending with ``ascending=False``; NaN last either way,
ties in input order). Aggregations: ``count/sum/mean/std/var/min/max``
(``AGG_DTYPES`` narrows count to int32 and mean/std/var to float32) and
``list/first/last``, which emit ragged list columns or per-group scalars in
that order. A host op, as in the reference (``jit_safe = False``): numpy on
the batch's host copy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import dtypes as md
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from .operator import Operator

_CONV_AGGS = ("count", "sum", "mean", "std", "var", "min", "max")
_LIST_AGGS = ("list", "first", "last")

AGG_DTYPES = {
    "count": np.int32,
    "mean": np.float32,
    "std": np.float32,
    "var": np.float32,
}


class Groupby(Operator):
    runs_on_host = True

    def __init__(self, groupby_cols=None, sort_cols=None, aggs="list", name_sep="_", ascending=True):
        super().__init__()
        self.groupby_cols = [groupby_cols] if isinstance(groupby_cols, str) else list(groupby_cols or [])
        self.sort_cols = [sort_cols] if isinstance(sort_cols, str) else list(sort_cols or [])
        self.ascending = ascending
        self.name_sep = name_sep
        if isinstance(aggs, str):
            aggs = {"__all__": [aggs]}
        elif isinstance(aggs, list):
            aggs = {"__all__": aggs}
        self.aggs: Dict[str, List[str]] = {col: ([a] if isinstance(a, str) else list(a)) for col, a in aggs.items()}
        for col_aggs in self.aggs.values():
            for a in col_aggs:
                if a not in _CONV_AGGS and a not in _LIST_AGGS:
                    raise ValueError(f"Unsupported agg {a!r}")

    @property
    def dependencies(self):
        extra = self.groupby_cols + self.sort_cols
        return [ColumnSelector(extra)] if extra else None

    def host_inputs(self, col_selector: ColumnSelector, batch: TableBatch) -> List[str]:
        return batch.column_names

    def _col_aggs(self, name: str) -> List[str]:
        return self.aggs[name] if name in self.aggs else self.aggs.get("__all__", [])

    def column_mapping(self, col_selector: ColumnSelector):
        mapping = {key: [key] for key in self.groupby_cols}
        for name in col_selector.names:
            if name in self.groupby_cols:
                continue
            for agg in self._col_aggs(name):
                mapping[f"{name}{self.name_sep}{agg}"] = [name]
        return mapping

    def compute_selector(self, input_schema, selector, parents_selector=None, dependencies_selector=None):
        sel = super().compute_selector(input_schema, selector, parents_selector, dependencies_selector)
        return ColumnSelector([n for n in sel.names if n not in self.groupby_cols])

    def _order(self, batch: TableBatch) -> np.ndarray:
        n = batch.num_rows
        keys = [np.asarray(batch[k].values) for k in self.groupby_cols]
        sorts = [np.asarray(batch[c].values) for c in self.sort_cols]
        if not keys and not sorts:
            return np.arange(n)
        if self.ascending or not sorts:
            return np.lexsort(list(reversed(sorts)) + list(reversed(keys)))
        return stable_order(keys + sorts, [True] * len(keys) + [False] * len(sorts))

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        n = batch.num_rows
        order = self._order(batch)
        sorted_cols = {name: batch[name].take(order) for name in batch.column_names}
        keys = [np.asarray(sorted_cols[k].values) for k in self.groupby_cols]
        change = np.zeros(n, dtype=bool)
        if n:
            change[0] = True
        for k in keys:
            change[1:] |= k[1:] != k[:-1]
        starts = np.nonzero(change)[0]
        ends = np.append(starts[1:], n)
        out = TableBatch()
        for key_col, k in zip(self.groupby_cols, keys):
            out[key_col] = Column(k[starts])
        for name in col_selector.names:
            if name in self.groupby_cols:
                continue
            vals = np.asarray(sorted_cols[name].values)
            for agg in self._col_aggs(name):
                out_name = f"{name}{self.name_sep}{agg}"
                if agg == "list":
                    out[out_name] = Column(vals.copy(), np.append(starts, n).astype(np.int64))
                elif agg == "first":
                    out[out_name] = Column(vals[starts])
                elif agg == "last":
                    out[out_name] = Column(vals[ends - 1])
                else:
                    out[out_name] = Column(_segment_agg(vals, starts, ends, agg))
        return out

    def _compute_dtype(self, col_schema, input_schema):
        for agg, dtype in AGG_DTYPES.items():
            if col_schema.name.endswith(f"{self.name_sep}{agg}"):
                return col_schema.with_dtype(md.normalize(dtype))
        return col_schema

    def _compute_shape(self, col_schema, input_schema):
        if col_schema.name.endswith(f"{self.name_sep}list"):
            return col_schema.with_shape(md.Shape.list())
        return col_schema.with_shape(md.Shape.scalar())


def stable_order(columns: List[np.ndarray], ascending: List[bool]) -> np.ndarray:
    """The rows' order by ``columns``, the first most significant, each
    ascending or descending, NaN last either way and ties in input order —
    a stable argsort by each column in turn from the least significant
    (what pandas' ``sort_values(kind="stable")`` gives the reference's
    descending Groupby, groupby.py:185-198)."""
    order = np.arange(len(columns[0]) if columns else 0)
    for col, asc in reversed(list(zip(columns, ascending))):
        key = np.asarray(col)[order]
        if not asc:
            if key.dtype.kind == "f":
                key = -key  # NaN stays NaN, which argsort puts last
            elif key.dtype.kind == "u":
                key = np.iinfo(key.dtype).max - key
            else:
                key = ~key  # -x - 1: decreasing, with no overflow at the minimum
        order = order[np.argsort(key, kind="stable")]
    return order


def _segment_agg(vals: np.ndarray, starts, ends, agg: str) -> np.ndarray:
    """The reference's conventional aggregations (groupby.py:156-182): sums
    from float64 prefix sums, NaN skipped; min/max over the non-NaN values."""
    fvals = vals.astype(np.float64)
    nan = np.isnan(fvals) if fvals.dtype.kind == "f" else np.zeros(len(fvals), bool)
    safe = np.where(nan, 0.0, fvals)
    csum = np.concatenate([[0.0], np.cumsum(safe)])
    ccnt = np.concatenate([[0], np.cumsum(~nan)])
    s = csum[ends] - csum[starts]
    c = ccnt[ends] - ccnt[starts]
    if agg == "count":
        return c.astype(np.int32)
    if agg == "sum":
        return s
    if agg == "mean":
        with np.errstate(invalid="ignore", divide="ignore"):
            return (s / np.maximum(c, 1)).astype(np.float32)
    if agg in ("std", "var"):
        csq = np.concatenate([[0.0], np.cumsum(safe * safe)])
        sq = csq[ends] - csq[starts]
        with np.errstate(invalid="ignore", divide="ignore"):
            v = (sq - s * s / np.maximum(c, 1)) / np.maximum(c - 1, 1)
            v = np.where(c > 1, np.maximum(v, 0.0), np.nan)
        return (np.sqrt(v) if agg == "std" else v).astype(np.float32)
    if agg == "min":
        return np.minimum.reduceat(np.where(nan, np.inf, fvals), starts) if len(starts) else fvals[:0]
    if agg == "max":
        return np.maximum.reduceat(np.where(nan, -np.inf, fvals), starts) if len(starts) else fvals[:0]
    raise ValueError(agg)
