"""ListSlice — row-wise slicing of list columns, padded or ragged.

Counterpart of ``nvtabular_tpu/ops/list_slice.py``. ``ListSlice(start, end,
pad)`` keeps each row's python slice ``[start:end]`` (negative bounds count
from the row's end; ``ListSlice(k)`` is ``[0:k]``, ``ListSlice(-k)`` the last
k).

* With ``pad=True`` and a fixed width (``_max_elements > 0``) it is the
  reference's device branch (:47-48, :55-68): every row padded to that width
  by one launch of kernel K11 (``kernels.ragged.ragged_slice_padded``), the
  offsets ``arange(R + 1) * width``. The port's executors leave the column
  on its device, so this runs on the card.
* Otherwise it is the reference's host branch, ``_slice_list`` (:95-132),
  which the executors reach through their counted host handoff, as they run
  a LambdaOp.

The offsets are int64 on both branches (the reference's device branch makes
int32 ones).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import dtypes as md
from ..kernels.ragged import ragged_slice_padded
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from .operator import Operator


class ListSlice(Operator):
    def __init__(self, start: int, end: Optional[int] = None, pad: bool = False, pad_value: float = 0.0):
        super().__init__()
        if end is None:
            start, end = (0, start) if start >= 0 else (start, 0)
        self.start = start
        self.end = end
        self.pad = pad
        self.pad_value = pad_value
        if self.start >= 0 and self.end > 0 and self.end <= self.start:
            raise ValueError("end must be > start")

    @property
    def _max_elements(self) -> int:
        if self.start >= 0:
            return self.end - self.start if self.end > 0 else -1
        return -self.start if self.end == 0 else self.end - self.start

    @property
    def runs_on_host(self) -> bool:
        """Only the padded fixed-width slice has a kernel."""
        return not (self.pad and self._max_elements > 0)

    def host_inputs(self, col_selector: ColumnSelector, batch: TableBatch) -> List[str]:
        return [n for n in col_selector.names if n in batch]

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            if not col.is_list:
                raise ValueError(f"ListSlice input {name!r} is not a list column")
            if self.runs_on_host:
                out[name] = _slice_list(col, self.start, self.end, self.pad, self.pad_value)
            else:
                out[name] = self._slice_padded(col)
        return out

    def _slice_padded(self, col: Column) -> Column:
        width = self._max_elements
        padded, _ = ragged_slice_padded(col.values, col.offsets, self.start, self.end, width, self.pad_value)
        rows = padded.shape[0]
        offsets = torch.arange(rows + 1, dtype=torch.int64, device=padded.device) * width
        return Column(padded.reshape(-1), offsets, col.validity)

    def _compute_shape(self, col_schema, input_schema):
        mx = self._max_elements
        if mx > 0:
            if self.pad:
                return col_schema.with_shape(md.Shape.list(mx, mx))
            return col_schema.with_shape(md.Shape.list(0, mx))
        return col_schema

    def _compute_properties(self, col_schema, input_schema):
        mx = self._max_elements
        if mx > 0:
            return col_schema.with_properties({"value_count": {"min": mx if self.pad else 0, "max": mx}})
        return col_schema


def _slice_list(col: Column, start: int, end: int, pad: bool, pad_value) -> Column:
    """A copy of the reference's host slice (list_slice.py:95-132), on numpy."""
    offs = np.asarray(col.offsets).astype(np.int64)
    vals = np.asarray(col.values)
    lengths = offs[1:] - offs[:-1]
    n = len(lengths)

    # per-row [lo, hi) positions relative to each row start
    if start >= 0:
        lo = np.minimum(start, lengths)
        hi = np.minimum(end, lengths) if end > 0 else lengths
    else:
        lo = np.maximum(lengths + start, 0)
        hi = lengths if end == 0 else np.maximum(np.minimum(lengths + end, lengths), 0)
    hi = np.maximum(hi, lo)
    out_lens = hi - lo

    if pad:
        pad_len = int(end - start) if start >= 0 and end > 0 else int(-start if end == 0 else end - start)
        pos = np.arange(pad_len)[None, :]
        src = offs[:-1, None] + lo[:, None] + pos
        valid = pos < out_lens[:, None]
        src = np.clip(src, 0, max(len(vals) - 1, 0))
        mat = vals[src] if len(vals) else np.zeros((n, pad_len), dtype=vals.dtype)
        mat = np.where(valid, mat, np.asarray(pad_value).astype(mat.dtype))
        new_offs = np.arange(0, (n + 1) * pad_len, pad_len, dtype=np.int64)
        return Column(mat.reshape(-1), new_offs, col.validity)

    new_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_lens, out=new_offs[1:])
    total = int(new_offs[-1])
    starts_abs = offs[:-1] + lo
    flat_idx = np.repeat(starts_abs, out_lens) + (np.arange(total) - np.repeat(new_offs[:-1], out_lens))
    new_vals = vals[flat_idx] if total else vals[:0]
    return Column(new_vals, new_offs, col.validity)
