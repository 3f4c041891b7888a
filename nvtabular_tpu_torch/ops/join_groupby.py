"""JoinGroupby — per-key aggregates of continuous columns, joined onto rows.

Counterpart of ``nvtabular_tpu/ops/join_groupby.py`` (:30-289). Output
names match the reference: ``{group}_count``, ``{group}_{cont}_{stat}``;
dtypes follow ``AGG_DTYPES`` (float32 otherwise).

* Fit aggregates on the batch's device (``groupby_stats.GroupbyStatsAccum``).
* Transform maps each group's keys to stat rows (the lookup kernels; misses
  and null keys read the pad slot: count 0, stats NaN), then one launch of
  kernel K10a (``kernels.groupby.stat_gather``) writes every output column.
  A group of several key columns is indexed through the verified hash pair
  (K10b, ``groupby_stats.GroupIndex``).

Not ported yet (raises NotImplementedError): the parquet artifacts
(``out_path``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import dtypes as md
from ..kernels.groupby import GatherState, stat_gather
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from .groupby_stats import UNSUPPORTED_ARTIFACTS, GroupbyStatsAccum, KeyedStats, key_groups
from .stat_operator import StatOperator

AGG_DTYPES = {
    "count": np.int32,
    "std": np.float32,
    "var": np.float32,
    "mean": np.float32,
}

_SUPPORTED = ("count", "sum", "mean", "std", "var", "min", "max")


class JoinGroupby(StatOperator):
    has_device_state = True

    def __init__(
        self,
        cont_cols=None,
        stats=("count",),
        split_out=None,
        split_every=None,
        cat_cache="host",
        out_path=None,
        on_host=True,
        name_sep="_",
        **kwargs,
    ):
        """The reference's signature (join_groupby.py:33-44): ``split_out``,
        ``split_every``, ``on_host`` and other keywords are accepted and
        ignored, as there."""
        super().__init__()
        if out_path is not None:
            raise NotImplementedError(UNSUPPORTED_ARTIFACTS)
        self.cat_cache = cat_cache  # stored and unused, as in the reference
        self.name_sep = name_sep
        self.stats = list(stats)
        for s in self.stats:
            if s not in _SUPPORTED:
                raise ValueError(f"Unsupported stat {s!r}; supported: {_SUPPORTED}")
        if isinstance(cont_cols, str):
            cont_cols = [cont_cols]
        self._cont_selector = ColumnSelector(cont_cols) if isinstance(cont_cols, (list, tuple)) else cont_cols
        self.keyed: Dict[str, KeyedStats] = {}

    @property
    def cont_names(self) -> List[str]:
        if self._cont_selector is None:
            return []
        if isinstance(self._cont_selector, ColumnSelector):
            return self._cont_selector.names
        return list(getattr(self._cont_selector, "output_columns", []))  # a Node dependency

    @property
    def dependencies(self):
        return [self._cont_selector] if self._cont_selector is not None else None

    def _group_name(self, group: List[str]) -> str:
        return self.name_sep.join(group)

    def compute_selector(self, input_schema, selector, parents_selector=None, dependencies_selector=None):
        sel = super().compute_selector(input_schema, selector, parents_selector, dependencies_selector)
        drop = set(self.cont_names)
        return ColumnSelector([n for n in sel._names if n not in drop], subgroups=sel.subgroups)

    def _outputs(self, group: List[str]):
        """(output name, stat key, cont column or None for the int32 count),
        in the reference's order."""
        name = self._group_name(group)
        for stat in self.stats:
            if stat == "count":
                yield f"{name}_count", "__rows", None
            else:
                for cont in self.cont_names:
                    yield f"{name}_{cont}_{stat}", f"{cont}.{stat}", cont

    def column_mapping(self, col_selector: ColumnSelector):
        return {
            out_name: ([] if cont is None else [cont]) + list(group)
            for group in key_groups(col_selector)
            for out_name, _, cont in self._outputs(group)
        }

    # --- fit ------------------------------------------------------------------------
    def fit_init(self, col_selector, input_schema):
        non_count = [s for s in self.stats if s != "count"]
        agg_specs = {cont: non_count for cont in self.cont_names} if non_count else {}
        return {self._group_name(g): GroupbyStatsAccum(g, agg_specs) for g in key_groups(col_selector)}

    def fit_batch(self, col_selector, batch: TableBatch, state):
        conts = {}
        for c in self.cont_names:
            col = batch[c]
            vals = col.values.to(torch.float64)
            conts[c] = vals if col.validity is None else torch.where(col.validity, vals, float("nan"))
        for group in key_groups(col_selector):
            state[self._group_name(group)].update([batch[k].values for k in group], conts)
        return state

    def fit_merge(self, states):
        out = states[0]
        for s in states[1:]:
            for name in out:
                out[name].merge(s[name])
        return out

    def fit_reduce_multihost(self, state):
        """Large group tables ride the all_to_all row exchange
        (``groupby_stats.reduce_accums_multihost``; join_groupby.py:149-156)."""
        from .groupby_stats import reduce_accums_multihost

        merged, self.last_fit_reduce = reduce_accums_multihost(state)
        return merged

    def fit_finalize(self, state):
        for name, accum in state.items():
            self.keyed[name] = accum.finalize()

    def clear(self):
        super().clear()
        self.keyed = {}

    # --- device state and transform ----------------------------------------------------
    def device_state(self, device):
        """Each group's key → row table and K10a's ``GatherState`` over every
        output column, counts first, in the fitted groups' order."""
        names = list(self.keyed)
        counts, stats = [], []  # (output name, group row, padded array)
        for g, name in enumerate(names):
            keyed = self.keyed[name]
            for out_name, stat_key, cont in self._outputs([name]):
                if cont is None:
                    counts.append((out_name, g, keyed.padded_stat("__rows", 0, dtype=np.int32)))
                else:
                    stats.append((out_name, g, keyed.padded_stat(stat_key, np.nan)))

        def table(entries, dtype):
            arrays = [a for _, _, a in entries]
            starts = np.cumsum([0] + [len(a) for a in arrays[:-1]])[: len(arrays)]
            return torch.from_numpy(np.concatenate(arrays or [np.zeros(0, dtype)])), starts

        itable, istarts = table(counts, np.int32)
        ftable, fstarts = table(stats, np.float32)
        gather = GatherState(
            itable=itable,
            ftable=ftable,
            groups=torch.tensor([g for _, g, _ in counts + stats], dtype=torch.int32),
            offs=torch.from_numpy(np.concatenate([istarts, fstarts]).astype(np.int64)),
            ki=len(counts),
        )
        return {
            "names": names,
            "index": {name: self.keyed[name].group_index(device) for name in names},
            "gather": gather.to(device),
            "columns": [out_name for out_name, _, _ in counts + stats],
        }

    def transform(self, col_selector: ColumnSelector, batch: TableBatch, state=None) -> TableBatch:
        if state is None:
            state = self.device_state(batch.device)
        groups = key_groups(col_selector)
        if [self._group_name(g) for g in groups] != state["names"]:
            raise ValueError(f"JoinGroupby was fitted on groups {state['names']}, not {groups}")
        gidx = torch.stack([state["index"][self._group_name(g)](*[batch[k] for k in g]) for g in groups])
        iout, fout = stat_gather(gidx, state["gather"])
        cols = list(iout) + list(fout)
        out = TableBatch()
        for name, values in zip(state["columns"], cols):
            out[name] = Column(values)
        return out

    def _compute_dtype(self, col_schema, input_schema):
        for agg, dtype in AGG_DTYPES.items():
            if col_schema.name.endswith(f"{self.name_sep}{agg}"):
                return col_schema.with_dtype(md.normalize(dtype))
        return col_schema.with_dtype(md.float32)
