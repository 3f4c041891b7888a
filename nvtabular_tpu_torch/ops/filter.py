"""Filter (counterpart of nvtabular_tpu/ops/filter.py): keeps the rows for
which a user callable returns True. The callable receives the selected
columns as a host ``TableBatch`` (a Column reads as a numpy array, see
``table.Column.__array__``) and returns a bool mask — numpy, a tensor or a
Column — or the filtered TableBatch itself. A host op, as in the reference
(``jit_safe = False``)."""

from __future__ import annotations

from typing import List

import numpy as np

from ..selector import ColumnSelector
from ..table import Column, TableBatch
from .operator import Operator


class Filter(Operator):
    runs_on_host = True

    def __init__(self, f):
        if not callable(f):
            raise ValueError("Filter requires a callable")
        super().__init__()
        self.f = f

    def host_inputs(self, col_selector: ColumnSelector, batch: TableBatch) -> List[str]:
        return [n for n in col_selector.names if n in batch]

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        selected = batch.select(self.host_inputs(col_selector, batch))
        result = self.f(selected)
        if isinstance(result, TableBatch):
            return result
        if isinstance(result, Column):
            result = result.values
        mask = np.asarray(result)
        if mask.dtype != np.bool_:
            raise ValueError("Filter callable must return a boolean mask or TableBatch")
        return selected.filter(mask)

    def compute_output_schema(self, input_schema, col_selector, prev_output_schema=None):
        return input_schema.apply(col_selector)
