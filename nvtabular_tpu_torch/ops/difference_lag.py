"""DifferenceLag — lag and lead differences within pre-sorted partitions.

Counterpart of ``nvtabular_tpu/ops/difference_lag.py:17-115``: for every
shift s and selected column x, ``x_difference_lag_s`` is float32
``x[i] - x[i - s]`` where row ``i - s`` lies in the batch and carries the
same values of every partition column, NaN elsewhere; all of them in one
launch of kernel K12a a batch (``kernels.difference_lag``). The partition
columns arrive as ``dependencies`` and are not outputs. Differences stay
within a batch, so the first (lag) or last (lead) |s| rows of each batch
are NaN, as on the reference's host path; the keys compare their raw values
and ignore validity.
"""

from __future__ import annotations

from typing import List, Union

import torch

from .. import dtypes as md
from ..kernels.difference_lag import difference_lag
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from .operator import Operator


class DifferenceLag(Operator):
    def __init__(self, partition_cols: Union[str, List[str]], shift: Union[int, List[int]] = 1):
        super().__init__()
        self.partition_cols = [partition_cols] if isinstance(partition_cols, str) else list(partition_cols)
        self.shifts = [shift] if isinstance(shift, int) else list(shift)

    @property
    def dependencies(self):
        return [ColumnSelector(self.partition_cols)]

    def _names(self, col_selector: ColumnSelector) -> List[str]:
        return [n for n in col_selector.names if n not in self.partition_cols]

    def column_mapping(self, col_selector: ColumnSelector):
        return {
            f"{name}_difference_lag_{shift}": [name] for shift in self.shifts for name in self._names(col_selector)
        }

    def compute_selector(self, input_schema, selector, parents_selector=None, dependencies_selector=None):
        sel = super().compute_selector(input_schema, selector, parents_selector, dependencies_selector)
        return ColumnSelector([n for n in sel.names if n not in self.partition_cols])

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        names = self._names(col_selector)
        out = TableBatch()
        if not names:
            return out
        keys = [batch[p].values for p in self.partition_cols]
        values = [batch[n].values.to(torch.float32) for n in names]
        diffs = difference_lag(keys, values, self.shifts)
        for si, shift in enumerate(self.shifts):
            for ci, name in enumerate(names):
                out[f"{name}_difference_lag_{shift}"] = Column(diffs[si, ci])
        return out

    @property
    def output_dtype(self):
        return md.float32
