"""FillMissing (counterpart of nvtabular_tpu/ops/fill.py:22-55).

Constant fill of nulls (validity False or NaN). The output drops the
validity mask (fill.py:35). The ``add_binary_cols`` indicator columns are
not ported yet (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import torch

from ..selector import ColumnSelector
from ..table import UNSUPPORTED_LISTS, Column, TableBatch
from .operator import Operator


def fill_column(col: Column, fill_val) -> Column:
    if col.is_list:
        raise NotImplementedError(UNSUPPORTED_LISTS)
    fill = torch.as_tensor(fill_val).to(device=col.device, dtype=col.values.dtype)
    return Column(torch.where(col.is_null(), fill, col.values))


UNSUPPORTED_BINARY_COLS = (
    "FillMissing(add_binary_cols=True) is not ported yet (ROADMAP.md queue 1 item 13: the rest of the op library)"
)


class FillMissing(Operator):
    def __init__(self, fill_val=0, add_binary_cols: bool = False):
        super().__init__()
        if add_binary_cols:
            raise NotImplementedError(UNSUPPORTED_BINARY_COLS)
        self.fill_val = fill_val

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            out[name] = fill_column(batch[name], self.fill_val)
        return out
