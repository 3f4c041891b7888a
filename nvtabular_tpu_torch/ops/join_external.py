"""JoinExternal (counterpart of nvtabular_tpu/ops/join_external.py): a left
or inner join of each batch against an external table held on the host.

The external table may be a ``TableBatch``, a dict of arrays, a port
``Dataset`` or a pandas DataFrame; a path or a list of paths needs the
parquet reader (ROADMAP.md queue 1 item 1). A batch's keys find their row
by a sorted search that returns the first occurrence of a key, as the
reference's ``pyarrow.compute.index_in`` does (join_external.py:72-87).
Several key columns join on their "\\x1f"-joined strings, as there. A host
op, as in the reference (``jit_safe = False``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..schema import Schema
from ..selector import ColumnSelector
from ..table import Column, TableBatch, concat_rows
from .operator import Operator

UNSUPPORTED_PATHS = (
    "JoinExternal from a path or a list of paths is not ported yet (ROADMAP.md queue 1 item 1: parquet I/O)"
)


def combine_keys(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Several key columns as one key: the reference's "\\x1f"-joined strings
    (groupby_stats.py:34-42); one column stays as it is."""
    if len(arrays) == 1:
        return arrays[0]
    combined = arrays[0].astype(str)
    for a in arrays[1:]:
        combined = np.char.add(np.char.add(combined, "\x1f"), a.astype(str))
    return combined.astype(object)


def first_index_in(values: np.ndarray, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(index of each value's first occurrence in ``keys``, found mask); the
    index is 0 where not found. A stable sort keeps equal keys in their
    order, so the leftmost match is the first occurrence."""
    if len(keys) == 0:
        return np.zeros(len(values), dtype=np.int64), np.zeros(len(values), dtype=bool)
    order = np.argsort(keys, kind="stable")
    ranked = keys[order]
    pos = np.minimum(np.searchsorted(ranked, values, side="left"), len(keys) - 1)
    found = ranked[pos] == values
    return np.where(found, order[pos], 0), found


class JoinExternal(Operator):
    runs_on_host = True

    def __init__(
        self,
        df_ext,
        on,
        how: str = "left",
        on_ext=None,
        columns_ext: Optional[List[str]] = None,
        drop_duplicates_ext: bool = False,
        kind_ext: Optional[str] = None,
        cache: str = "host",
        **kwargs,
    ):
        super().__init__()
        if how not in ("left", "inner"):
            raise ValueError("how must be 'left' or 'inner'")
        if isinstance(df_ext, (str, list, tuple)):
            raise NotImplementedError(UNSUPPORTED_PATHS)
        self.on = [on] if isinstance(on, str) else list(on)
        self.on_ext = [on_ext] if isinstance(on_ext, str) else list(on_ext or self.on)
        self.how = how
        self.columns_ext = columns_ext
        self.drop_duplicates_ext = drop_duplicates_ext
        self.cache = cache
        self._ext_source = df_ext
        self._ext: Optional[TableBatch] = None
        self._ext_keys: Optional[np.ndarray] = None

    def _load_ext(self) -> TableBatch:
        if self._ext is None:
            from ..io.dataset import Dataset

            src = self._ext_source
            if isinstance(src, Dataset):
                ext = concat_rows(list(src.to_batches()))
            elif isinstance(src, TableBatch):
                ext = src
            elif isinstance(src, dict):
                ext = TableBatch.from_pydict(src)
            elif type(src).__module__.startswith("pandas"):
                ext = TableBatch.from_pydict({c: src[c].to_numpy() for c in src.columns})
            else:
                raise TypeError(f"JoinExternal cannot read an external table from {type(src)}")
            if self.columns_ext:
                keep = list(dict.fromkeys(self.on_ext + self.columns_ext))
                ext = ext.select([c for c in keep if c in ext])
            ext = ext.to("cpu")
            if self.drop_duplicates_ext:
                keys = combine_keys([np.asarray(ext[k].values) for k in self.on_ext])
                _, first = np.unique(keys, return_index=True)
                ext = ext.take(np.sort(first))
            self._ext = ext
        return self._ext

    def host_inputs(self, col_selector: ColumnSelector, batch: TableBatch) -> List[str]:
        return batch.column_names

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        ext = self._load_ext()
        if self._ext_keys is None:
            self._ext_keys = combine_keys([np.asarray(ext[k].values) for k in self.on_ext])
        idx, found = first_index_in(combine_keys([np.asarray(batch[k].values) for k in self.on]), self._ext_keys)
        if self.how == "inner":
            sel = np.nonzero(found)[0]
            batch = batch.take(sel)
            idx, found = idx[sel], found[sel]
        out = batch.copy()
        for name in [c for c in ext.column_names if c not in self.on_ext]:
            col = ext[name]
            valid = np.asarray(col.validity)[idx] if col.validity is not None else None
            if self.how == "left":
                valid = found if valid is None else found & valid
                valid = None if valid.all() else valid
            out[name] = Column(np.asarray(col.values)[idx], None, valid)
        return out

    def compute_output_schema(self, input_schema, col_selector, prev_output_schema=None):
        out = Schema(list(input_schema))
        for cs in self._load_ext().infer_schema():
            if cs.name not in self.on_ext:
                out = out + Schema([cs])
        return out
