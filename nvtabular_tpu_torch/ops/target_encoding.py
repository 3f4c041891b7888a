"""TargetEncoding — k-fold out-of-fold smoothed target means per key group.

Counterpart of ``nvtabular_tpu/ops/target_encoding.py`` (:32-50, 53-362):

    TE = (sum_oof + p_smooth * mean) / (count_oof + p_smooth)

* Fit aggregates (fold, key) → target sum and count on the batch's device;
  each row's fold is a seeded hash of its global row index (kernel K7,
  ``kernels.hash.fold_ids``), so fit and transform assign the same folds.
  The per-group totals (``overall_stats``) are the fold stats summed.
* Transform maps each group's keys to stat rows (the lookup kernels, misses
  and null keys to the pad slot), then one launch of kernel K10a
  (``kernels.groupby.te_encode``) writes every TE column, hashing the folds
  itself. ``drop_folds=False`` adds the ``__fold__`` column (K7).
* A group of several key columns (``[["a", "b"]] >> TargetEncoding(...)``)
  is indexed through the verified hash pair (K10b,
  ``groupby_stats.GroupIndex``); its output is ``TE_a_b_<target>``.

Not ported yet (raises NotImplementedError): the parquet artifacts
(``out_path``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import dtypes as md
from ..kernels.groupby import TEState, te_encode
from ..kernels.hash import fold_ids
from ..selector import ColumnSelector
from ..table import Column, TableBatch, to_torch_dtype
from ..tags import Tags
from .groupby_stats import (
    UNSUPPORTED_ARTIFACTS,
    UNSUPPORTED_CAT_CACHE,
    GroupbyStatsAccum,
    KeyedStats,
    key_groups,
    sum_over_folds,
)
from .stat_operator import StatOperator

FOLD_NAME = "__fold__"


class TargetEncoding(StatOperator):
    has_device_state = True

    def __init__(
        self,
        target,
        target_mean=None,
        kfold=None,
        fold_seed=42,
        p_smooth=20,
        out_col=None,
        out_dtype=None,
        split_out=None,
        split_every=None,
        cat_cache="host",
        out_path=None,
        on_host=True,
        name_sep="_",
        drop_folds=True,
        **kwargs,
    ):
        """The reference's signature (target_encoding.py:56-73): ``split_out``,
        ``split_every``, ``on_host`` and other keywords are accepted and
        ignored, as there."""
        super().__init__()
        if out_path is not None:
            raise NotImplementedError(UNSUPPORTED_ARTIFACTS)
        if cat_cache != "host":
            raise NotImplementedError(UNSUPPORTED_CAT_CACHE)
        if isinstance(target, str):
            target = [target]
        if isinstance(target, ColumnSelector):
            target = target.names
        self.target = list(target)
        self.target_mean = target_mean
        self.kfold = kfold or 3
        self.fold_seed = fold_seed
        self.p_smooth = p_smooth
        self.out_col = [out_col] if isinstance(out_col, str) else out_col
        self.out_dtype = out_dtype
        self.name_sep = name_sep
        self.drop_folds = drop_folds
        self.fold_name = FOLD_NAME
        self.means: Dict[str, float] = dict(target_mean or {})
        self.fold_stats: Dict[str, KeyedStats] = {}
        self.overall_stats: Dict[str, KeyedStats] = {}

    @property
    def dependencies(self):
        return [ColumnSelector(self.target)]

    # --- group structure --------------------------------------------------------
    def _group_tag(self, group: List[str]) -> str:
        return self.name_sep.join(group)

    def compute_selector(self, input_schema, selector, parents_selector=None, dependencies_selector=None):
        sel = super().compute_selector(input_schema, selector, parents_selector, dependencies_selector)
        drop = set(self.target)
        return ColumnSelector([n for n in sel._names if n not in drop], subgroups=sel.subgroups)

    def _te_name(self, gi: int, group: List[str], ti: int, target: str) -> str:
        flat = gi * len(self.target) + ti
        if self.out_col and flat < len(self.out_col):
            return self.out_col[flat]
        return f"TE_{self._group_tag(group)}_{target}"

    def column_mapping(self, col_selector: ColumnSelector):
        mapping = {}
        for gi, group in enumerate(key_groups(col_selector)):
            for ti, t in enumerate(self.target):
                mapping[self._te_name(gi, group, ti, t)] = [*group, t]
        if self.kfold > 1 and not self.drop_folds:
            mapping[self.fold_name] = []
        return mapping

    # --- fit ------------------------------------------------------------------------
    def fit_init(self, col_selector, input_schema):
        agg_specs = {t: ["sum", "count"] for t in self.target}
        folds = [self.fold_name] if self.kfold > 1 else []
        return {
            "groups": {
                self._group_tag(g): GroupbyStatsAccum(folds + g, agg_specs) for g in key_groups(col_selector)
            },
            "sum": {t: 0.0 for t in self.target},
            "cnt": {t: 0 for t in self.target},
        }

    def fit_batch(self, col_selector, batch: TableBatch, state):
        targets = {}
        for t in self.target:
            col = batch[t]
            vals = col.values.to(torch.float64)
            if col.validity is not None:
                vals = torch.where(col.validity, vals, float("nan"))
            targets[t] = vals
            valid = ~torch.isnan(vals)
            # device scalars: no host sync per batch
            state["sum"][t] = state["sum"][t] + torch.where(valid, vals, 0.0).sum()
            state["cnt"][t] = state["cnt"][t] + valid.sum()
        folds = []
        if self.kfold > 1:
            folds = [fold_ids(batch.row_offset, batch.num_rows, self.kfold, self.fold_seed, batch.device).long()]
        for group in key_groups(col_selector):
            keys = folds + [batch[k].values for k in group]
            state["groups"][self._group_tag(group)].update(keys, targets)
        return state

    def fit_merge(self, states):
        out = states[0]
        for s in states[1:]:
            for tag in out["groups"]:
                out["groups"][tag].merge(s["groups"][tag])
            for t in self.target:
                out["sum"][t] = float(out["sum"][t]) + float(s["sum"][t])
                out["cnt"][t] = float(out["cnt"][t]) + float(s["cnt"][t])
        return out

    def fit_reduce_multihost(self, state):
        """The (fold, key) tables ride the all_to_all row exchange
        (``groupby_stats.reduce_accums_multihost``); the target sums are
        scalars and take the allgather (target_encoding.py:192-207)."""
        from ..parallel.multihost import allgather_pyobj
        from .groupby_stats import reduce_accums_multihost

        scalars = allgather_pyobj({k: {t: float(state[k][t]) for t in self.target} for k in ("sum", "cnt")})
        groups, self.last_fit_reduce = reduce_accums_multihost(state["groups"])
        return {
            "groups": groups,
            "sum": {t: sum(s["sum"][t] for s in scalars) for t in self.target},
            "cnt": {t: sum(s["cnt"][t] for s in scalars) for t in self.target},
        }

    def fit_finalize(self, state):
        for t in self.target:
            if t not in self.means:
                self.means[t] = float(state["sum"][t]) / max(float(state["cnt"][t]), 1.0)
        for tag, accum in state["groups"].items():
            keyed = accum.finalize()
            self.fold_stats[tag] = keyed
            self.overall_stats[tag] = sum_over_folds(keyed, self.fold_name) if self.kfold > 1 else keyed

    def clear(self):
        super().clear()
        self.fold_stats, self.overall_stats = {}, {}
        self.means = dict(self.target_mean or {})

    # --- device state ------------------------------------------------------------------
    def _fold_matrix(self, tag: str, stat_key: str) -> np.ndarray:
        """[kfold, num_groups + 1] float32 in-fold stats at the OVERALL group
        rows; the pad column stays 0 (target_encoding.py:269-290)."""
        overall, fkeyed = self.overall_stats[tag], self.fold_stats[tag]
        mat = np.zeros((self.kfold, overall.num_groups + 1), dtype=np.float32)
        folds = np.asarray(fkeyed.key_arrays[self.fold_name]).astype(np.int64)
        idx, found = overall.row_indices([fkeyed.key_arrays[k] for k in overall.key_cols])
        mat[folds[found], idx[found]] = np.asarray(fkeyed.stats[stat_key], dtype=np.float64)[found]
        return mat

    def device_state(self, device):
        """Each group's key → row table and the flat TE stats (K10a's
        ``TEState``), in the fitted groups' order."""
        tags = list(self.overall_stats)
        index = {tag: self.overall_stats[tag].group_index(device) for tag in tags}
        sums, counts, fsums, fcnts, stat_off, fold_off, strides = [], [], [], [], [], [], []
        at = fat = 0
        for tag in tags:
            keyed = self.overall_stats[tag]
            strides.append(keyed.num_groups + 1)
            for t in self.target:
                stat_off.append(at)
                sums.append(keyed.padded_stat(f"{t}.sum", 0.0))
                counts.append(keyed.padded_stat(f"{t}.count", 0.0))
                at += keyed.num_groups + 1
                if self.kfold > 1:
                    fold_off.append(fat)
                    fsums.append(self._fold_matrix(tag, f"{t}.sum").reshape(-1))
                    fcnts.append(self._fold_matrix(tag, f"{t}.count").reshape(-1))
                    fat += fsums[-1].shape[0]

        def flat(parts, dtype):
            return torch.from_numpy(np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype))

        te = TEState(
            sums=flat(sums, np.float32), counts=flat(counts, np.float32),
            stat_off=torch.tensor(stat_off, dtype=torch.int64),
            fsums=flat(fsums, np.float32), fcnts=flat(fcnts, np.float32),
            fold_off=torch.tensor(fold_off, dtype=torch.int64),
            strides=torch.tensor(strides, dtype=torch.int64),
            means=torch.tensor([np.float32(self.means.get(t, 0.0)) for t in self.target], dtype=torch.float32),
            p_smooth=float(self.p_smooth), kfold=self.kfold, fold_seed=self.fold_seed,
        )
        return {"tags": tags, "index": index, "te": te.to(device)}

    # --- transform -------------------------------------------------------------------------
    def transform(self, col_selector: ColumnSelector, batch: TableBatch, state=None) -> TableBatch:
        if state is None:
            state = self.device_state(batch.device)
        groups = key_groups(col_selector)
        if [self._group_tag(g) for g in groups] != state["tags"]:
            raise ValueError(f"TargetEncoding was fitted on groups {state['tags']}, not {groups}")
        gidx = torch.stack([state["index"][self._group_tag(g)](*[batch[k] for k in g]) for g in groups])
        te = te_encode(gidx, state["te"], batch.row_offset)
        dtype = to_torch_dtype(self.out_dtype) if self.out_dtype else torch.float32
        out = TableBatch()
        for gi, group in enumerate(groups):
            for ti, t in enumerate(self.target):
                out[self._te_name(gi, group, ti, t)] = Column(te[gi * len(self.target) + ti].to(dtype))
        if self.kfold > 1 and not self.drop_folds:
            out[self.fold_name] = Column(
                fold_ids(batch.row_offset, batch.num_rows, self.kfold, self.fold_seed, batch.device)
            )
        return out

    # --- schema ------------------------------------------------------------------------------
    @property
    def output_dtype(self):
        return md.normalize(self.out_dtype) if self.out_dtype else md.float32

    def _compute_dtype(self, col_schema, input_schema):
        if col_schema.name == self.fold_name:
            return col_schema.with_dtype(md.int32)
        return super()._compute_dtype(col_schema, input_schema)

    @property
    def output_tags(self):
        return [Tags.CONTINUOUS]
