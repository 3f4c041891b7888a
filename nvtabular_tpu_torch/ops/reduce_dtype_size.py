"""ReduceDtypeSize (counterpart of nvtabular_tpu/ops/reduce_dtype_size.py):
the fit keeps each column's min and max (``MomentsState``); integer columns
narrow to the first of int8, int16, int32, int64 that holds the range, and
float columns take ``float_dtype``. The transform is a cast on the batch's
device."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import dtypes as md
from ..selector import ColumnSelector
from ..table import TableBatch
from .moments import MomentsState
from .stat_operator import StatOperator

_INT_LADDER = [np.int8, np.int16, np.int32, np.int64]


class ReduceDtypeSize(StatOperator):
    def __init__(self, float_dtype=np.float32):
        super().__init__()
        self.float_dtype = np.dtype(float_dtype)
        self.ranges: Dict[str, tuple] = {}
        self._dtypes: Dict[str, np.dtype] = {}

    def fit_init(self, col_selector, input_schema):
        self._input_dtypes = {cs.name: cs.dtype for cs in input_schema if cs.name in col_selector.names}
        return MomentsState(col_selector.names)

    def fit_batch(self, col_selector, batch, state):
        return state.update_batch(batch)

    def fit_merge(self, states):
        out = states[0]
        for s in states[1:]:
            out = out.merge(s)
        return out

    def fit_finalize(self, state: MomentsState):
        for name, mom in state.columns.items():
            if mom.count == 0:
                continue
            self.ranges[name] = (mom.min, mom.max)
            src = self._input_dtypes.get(name, md.unknown)
            if src.is_integer:
                for candidate in _INT_LADDER:
                    info = np.iinfo(candidate)
                    if mom.min >= info.min and mom.max <= info.max:
                        self._dtypes[name] = np.dtype(candidate)
                        break
            elif src.is_float:
                self._dtypes[name] = self.float_dtype

    def clear(self):
        super().clear()
        self.ranges, self._dtypes = {}, {}

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            tgt = self._dtypes.get(name)
            out[name] = col.astype(tgt) if tgt is not None else col
        return out

    def _compute_dtype(self, col_schema, input_schema):
        tgt = self._dtypes.get(col_schema.name)
        return col_schema.with_dtype(md.normalize(tgt)) if tgt is not None else col_schema
