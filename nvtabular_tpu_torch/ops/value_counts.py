"""ValueCount (counterpart of nvtabular_tpu/ops/value_counts.py): the fit
keeps the least and the greatest row length of each list column, which the
output schema carries as its ``value_count`` property and list shape; the
transform passes the columns through."""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import dtypes as md
from ..selector import ColumnSelector
from ..table import TableBatch
from .stat_operator import StatOperator


class ValueCount(StatOperator):
    def __init__(self):
        super().__init__()
        self.stats: Dict[str, Dict[str, int]] = {}

    def fit_init(self, col_selector, input_schema):
        return {name: [np.inf, -np.inf] for name in col_selector.names}

    def fit_batch(self, col_selector, batch, state):
        for name in col_selector.names:
            col = batch[name]
            if not col.is_list or len(col) == 0:
                continue
            lengths = col.row_lengths
            state[name][0] = min(state[name][0], int(lengths.min()))
            state[name][1] = max(state[name][1], int(lengths.max()))
        return state

    def fit_merge(self, states):
        out = states[0]
        for s in states[1:]:
            for name in out:
                out[name][0] = min(out[name][0], s[name][0])
                out[name][1] = max(out[name][1], s[name][1])
        return out

    def fit_finalize(self, state):
        for name, (mn, mx) in state.items():
            if mn is not np.inf and mx is not -np.inf and mx >= 0:
                self.stats[name] = {"min": int(mn), "max": int(mx)}

    def clear(self):
        super().clear()
        self.stats = {}

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        return batch.select([n for n in col_selector.names if n in batch])

    def _compute_properties(self, col_schema, input_schema):
        vc = self.stats.get(col_schema.name)
        return col_schema.with_properties({"value_count": vc}) if vc else col_schema

    def _compute_shape(self, col_schema, input_schema):
        vc = self.stats.get(col_schema.name)
        return col_schema.with_shape(md.Shape.list(vc["min"], vc["max"])) if vc else col_schema
