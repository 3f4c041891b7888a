"""Bucketize — digitize against per-column boundaries into int32 buckets.

Counterpart of ``nvtabular_tpu/ops/bucketize.py``: boundaries as one list or
a dict per column, cast to the column's dtype, ``searchsorted(...,
side="right")`` (the reference's device branch), in one launch of kernel
K12b (``kernels.bucketize.bucketize``) per column. The validity mask passes
through.
"""

from __future__ import annotations

import torch

from .. import dtypes as md
from ..kernels.bucketize import bucketize
from ..selector import ColumnSelector
from ..table import UNSUPPORTED_LISTS, Column, TableBatch
from ..tags import Tags
from .operator import Operator


class Bucketize(Operator):
    has_device_state = True

    def __init__(self, boundaries):
        super().__init__()
        if isinstance(boundaries, (list, tuple)):
            self.boundaries = [float(b) for b in boundaries]
        elif isinstance(boundaries, dict):
            self.boundaries = {k: [float(x) for x in v] for k, v in boundaries.items()}
        else:
            raise TypeError("boundaries must be a list or dict of lists")

    def _bounds_for(self, name):
        if isinstance(self.boundaries, dict):
            if name not in self.boundaries:
                raise ValueError(f"No boundaries given for column {name!r}")
            return self.boundaries[name]
        return self.boundaries

    def device_state(self, device):
        return {"bounds": {}}  # (column, dtype) → the bounds on the device, cast

    def transform(self, col_selector: ColumnSelector, batch: TableBatch, state=None) -> TableBatch:
        if state is None:
            state = self.device_state(batch.device)
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            if col.is_list:
                raise NotImplementedError(UNSUPPORTED_LISTS)
            key = (name, col.values.dtype)
            bounds = state["bounds"].get(key)
            if bounds is None:
                bounds = torch.tensor(self._bounds_for(name), dtype=torch.float64).to(col.values.dtype)
                bounds = state["bounds"][key] = bounds.to(col.device)
            out[name] = Column(bucketize(col.values, bounds), None, col.validity)
        return out

    @property
    def output_dtype(self):
        return md.int32

    @property
    def output_tags(self):
        return [Tags.CATEGORICAL]
