"""Clip (counterpart of nvtabular_tpu/ops/clip.py:10-29)."""

from __future__ import annotations

import torch

from ..selector import ColumnSelector
from ..table import Column, TableBatch
from .operator import Operator


def clip_values(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` semantics: NaN stays NaN."""
    if not x.is_floating_point():
        return torch.clamp(x, min=lo, max=hi)
    if lo is not None:
        lo_t = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
        x = torch.where(x < lo_t, lo_t, x)
    if hi is not None:
        hi_t = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
        x = torch.where(x > hi_t, hi_t, x)
    return x


class Clip(Operator):
    """Clamp continuous values to [min_value, max_value]."""

    def __init__(self, min_value=None, max_value=None):
        if min_value is None and max_value is None:
            raise ValueError("Clip needs min_value and/or max_value")
        super().__init__()
        self.min_value = min_value
        self.max_value = max_value

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            vals = clip_values(col.values, self.min_value, self.max_value)
            out[name] = Column(vals, col.offsets, col.validity)
        return out
