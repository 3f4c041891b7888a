"""Normalize (counterpart of nvtabular_tpu/ops/normalize.py:24-97).

z-score standardization from single-pass streaming moments. The transform
is plain torch on any device with the reference's float32 expressions
(normalize.py:61-74): ``(x - mean) / std``, or ``x - mean`` when std == 0.
On the device executor, a FillMissing → Clip → LogOp → Normalize chain runs
as one launch of the cont_chain kernel instead (dag/device_fuse.py).
``out_dtype`` is not ported yet (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import dtypes as md
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from ..tags import Tags
from .moments import MomentsState
from .stat_operator import StatOperator


def _f32(x: float, device) -> torch.Tensor:
    """A float64 statistic rounded to float32, as np.asarray(x, float32)."""
    return torch.as_tensor(np.float64(x), device=device).to(torch.float32)


class Normalize(StatOperator):
    """(x - mean) / std."""

    def __init__(self, out_dtype=None):
        super().__init__()
        if out_dtype is not None:
            raise NotImplementedError(
                "Normalize(out_dtype=...) is not ported yet (ROADMAP.md queue 1 item 13: the rest of the op library)"
            )
        self.means: Dict[str, float] = {}
        self.stds: Dict[str, float] = {}

    def fit_init(self, col_selector: ColumnSelector, input_schema):
        return MomentsState(col_selector.names)

    def fit_batch(self, col_selector, batch, state: MomentsState):
        return state.update_batch(batch)

    def fit_merge(self, states):
        out = states[0]
        for s in states[1:]:
            out = out.merge(s)
        return out

    def fit_finalize(self, state: MomentsState):
        for name, mom in state.columns.items():
            self.means[name] = mom.mean
            self.stds[name] = mom.std

    def clear(self):
        super().clear()
        self.means, self.stds = {}, {}

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            vals = col.values.to(torch.float32)
            vals = vals - _f32(self.means.get(name, 0.0), vals.device)
            std = self.stds.get(name, 0.0)
            if std > 0:
                vals = vals / _f32(std, vals.device)
            out[name] = Column(vals, col.offsets, col.validity)
        return out

    @property
    def output_dtype(self):
        return md.float32

    @property
    def output_tags(self):
        return [Tags.CONTINUOUS]
