"""DataStats (counterpart of nvtabular_tpu/ops/data_stats.py): each column's
dtype, cardinality, share of nulls, min, max, mean and std, and for a list
column its mean length. The cardinality counts the distinct hashes of the
values (``dispatch.hash_array`` with the host path's float64 bits, as the
reference hashes on the host). The transform passes the columns through."""

from __future__ import annotations

from typing import Dict

from ..dispatch import hash_array
from ..selector import ColumnSelector
from ..table import TableBatch
from .moments import ColumnMoments
from .stat_operator import StatOperator


class _ColState:
    def __init__(self):
        self.moments = ColumnMoments()
        self.hashes: set = set()  # distinct uint32 hashes ≈ cardinality
        self.list_len_sum = 0.0
        self.list_count = 0.0


class DataStats(StatOperator):
    def __init__(self):
        super().__init__()
        self.output: Dict[str, Dict] = {}

    def fit_init(self, col_selector, input_schema):
        self._schema = input_schema
        return {name: _ColState() for name in col_selector.names}

    def fit_batch(self, col_selector, batch, state):
        for name in col_selector.names:
            col = batch[name]
            st = state[name]
            if col.is_list:
                st.list_len_sum += float(col.row_lengths.sum())
                st.list_count += len(col)
            st.moments = st.moments.merge(ColumnMoments.of(col))
            st.hashes.update(hash_array(col.values, float_bits=64).unique().tolist())
        return state

    def fit_merge(self, states):
        out = states[0]
        for s in states[1:]:
            for name in out:
                out[name].moments = out[name].moments.merge(s[name].moments)
                out[name].hashes |= s[name].hashes
                out[name].list_len_sum += s[name].list_len_sum
                out[name].list_count += s[name].list_count
        return out

    def fit_finalize(self, state):
        for name, st in state.items():
            cs = self._schema.get(name)
            mom = st.moments
            entry = {
                "dtype": cs.dtype.name if cs else "unknown",
                "cardinality": len(st.hashes),
                "per_nan": 100.0 * mom.null_count / mom.total_rows if mom.total_rows else 0.0,
                "min": mom.min if mom.count else 0.0,
                "max": mom.max if mom.count else 0.0,
                "mean": mom.mean,
                "std": mom.std,
            }
            if st.list_count:
                entry["multi_min"] = entry["multi_max"] = None
                entry["multi_avg"] = st.list_len_sum / st.list_count
            self.output[name] = entry

    def clear(self):
        super().clear()
        self.output = {}

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        return batch.select([n for n in col_selector.names if n in batch])
