"""LogOp (counterpart of nvtabular_tpu/ops/logop.py:14-28): log1p in float32."""

from __future__ import annotations

import torch

from .. import dtypes as md
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from .operator import Operator


class LogOp(Operator):
    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            vals = torch.log1p(col.values.to(torch.float32))
            out[name] = Column(vals, col.offsets, col.validity)
        return out

    @property
    def output_dtype(self):
        return md.float32
