"""FillMissing and FillMedian (counterpart of nvtabular_tpu/ops/fill.py:22-157).

Both fill nulls (validity False or NaN) with a constant cast to the
column's dtype, and drop the validity mask (fill.py:35). FillMissing's
constant is ``fill_val``; FillMedian's is each column's median, fitted from
the reference's reservoir sample (``ops/moments.py:ReservoirSample``), so
the medians equal the reference's exactly. With ``add_binary_cols`` each
column ``c`` also gives ``c_filled``, a bool column that is True where ``c``
was null. On the device executor a fill whose branch ends there — or that
heads a Clip / LogOp / Normalize chain — runs as one launch of the
cont_chain kernel instead (dag/device_fuse.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import dtypes as md
from ..selector import ColumnSelector
from ..table import UNSUPPORTED_LISTS, Column, TableBatch
from .moments import ReservoirSample
from .operator import Operator
from .stat_operator import StatOperator


def fill_column(col: Column, fill_val) -> Column:
    if col.is_list:
        raise NotImplementedError(UNSUPPORTED_LISTS)
    fill = torch.as_tensor(np.asarray(fill_val)).to(device=col.device, dtype=col.values.dtype)
    return Column(torch.where(col.is_null(), fill, col.values))


class _FillOp:
    """What both fills share: the transform, the ``_filled`` columns and their
    bool dtype (fill.py:46-86, 121-146)."""

    add_binary_cols: bool

    def _fill_value(self, name: str):
        raise NotImplementedError

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            out[name] = fill_column(col, self._fill_value(name))
            if self.add_binary_cols:
                out[f"{name}_filled"] = Column(col.is_null())
        return out

    def column_mapping(self, col_selector):
        mapping = {}
        for name in col_selector.names:
            mapping[name] = [name]
            if self.add_binary_cols:
                mapping[f"{name}_filled"] = [name]
        return mapping

    def _compute_dtype(self, col_schema, input_schema):
        if col_schema.name.endswith("_filled"):
            return col_schema.with_dtype(md.boolean)
        return super()._compute_dtype(col_schema, input_schema)


class FillMissing(_FillOp, Operator):
    def __init__(self, fill_val=0, add_binary_cols: bool = False):
        super().__init__()
        self.fill_val = fill_val
        self.add_binary_cols = add_binary_cols

    def _fill_value(self, name: str):
        return self.fill_val


class FillMedian(_FillOp, StatOperator):
    """Nulls filled with the column's median (fill.py:87-157). The fit keeps
    one reservoir sample a column on the host; ``fit_merge`` merges the
    ranks' samples as the reference does. (The reference's
    ``deserialize_state`` reads ``means`` and ``stds``, fill.py:155-160;
    save/load is ROADMAP.md queue 1 item 2.)"""

    def __init__(self, add_binary_cols: bool = False):
        super().__init__()
        self.add_binary_cols = add_binary_cols
        self.medians: Dict[str, float] = {}

    def fit_init(self, col_selector, input_schema):
        return {name: ReservoirSample() for name in col_selector.names}

    def fit_batch(self, col_selector, batch, state):
        for name in col_selector.names:
            col = batch[name]
            if col.is_list:
                raise NotImplementedError(UNSUPPORTED_LISTS)
            state[name].update(col.values[~col.is_null()].to(torch.float64).cpu().numpy())
        return state

    def fit_merge(self, states):
        out = states[0]
        for s in states[1:]:
            for name in out:
                out[name] = out[name].merge(s[name])
        return out

    def fit_finalize(self, state):
        for name, sample in state.items():
            self.medians[name] = sample.quantile(0.5)

    def clear(self):
        super().clear()
        self.medians = {}

    def _fill_value(self, name: str):
        return self.medians.get(name, 0.0)
