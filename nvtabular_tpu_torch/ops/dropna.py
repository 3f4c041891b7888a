"""Dropna (counterpart of nvtabular_tpu/ops/dropna.py): drops the rows that
hold a null (validity False or NaN) in any selected column. The output's
row count depends on the data, so it is a host op, as in the reference
(``jit_safe = False``): the executors hand it the batch's columns on the
host and put its result back on the batch's device."""

from __future__ import annotations

from typing import List

import torch

from ..selector import ColumnSelector
from ..table import TableBatch
from .operator import Operator


class Dropna(Operator):
    runs_on_host = True

    def host_inputs(self, col_selector: ColumnSelector, batch: TableBatch) -> List[str]:
        return batch.column_names

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        keep = torch.ones(batch.num_rows, dtype=torch.bool, device=batch.device)
        for name in col_selector.names:
            keep &= ~batch[name].is_null()
        return batch.filter(keep)

    def compute_output_schema(self, input_schema, col_selector, prev_output_schema=None):
        return input_schema
