"""Per-key aggregation shared by TargetEncoding and JoinGroupby.

Counterpart of ``nvtabular_tpu/ops/groupby_stats.py`` (:53-189, 364-378,
529-547, 590-610, 629-660) without pyarrow:

* ``GroupbyStatsAccum`` aggregates each batch on the batch's device
  (``torch.unique`` sorted with ``return_inverse``, then ``index_add_`` and
  ``scatter_reduce_``: sums in float64, counts and ``__rows`` in int64),
  merges batches by aggregating their partials again, and finalizes with
  the keys in ascending lexicographic order, as the reference's
  ``pc.sort_indices`` leaves them. Like the reference, it groups key
  *values* and ignores their validity; a NaN or null target stays out of
  ``sum`` and ``count`` but its row counts in ``__rows``.
* ``KeyedStats`` holds the fitted stats as numpy arrays (nothing is written
  to parquet: that waits for save/load) and maps a batch's keys to stat rows
  on the device with the Categorify lookup kernels (``GroupIndex``).

Multi-key groups (the reference's hash-pair branch, :549-588, 611-627) raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dispatch import hash_array, hash_lanes
from ..table import Column
from .lookup import BATCHED, build_lookup, int32_keys, kind_of

_AGG_NEEDS = {
    "count": ("count",),
    "sum": ("sum",),
    "mean": ("sum", "count"),
    "std": ("sum", "sqsum", "count"),
    "var": ("sum", "sqsum", "count"),
    "min": ("min",),
    "max": ("max",),
}
_REAGG_ROWS = 4_000_000
GROUP_TINY_MAX = 512  # group indexes probe one column a launch (groupby_stats.py:541-544)

UNSUPPORTED_MULTI_KEY = (
    "multi-column groups of TargetEncoding and JoinGroupby are not ported yet "
    "(ROADMAP.md queue 2: K10b, the multi-key hash-pair index)"
)
UNSUPPORTED_ARTIFACTS = (
    "the parquet stat artifacts (out_path) are not ported yet: the port keeps fitted "
    "stats in memory (ROADMAP.md queue 1: save/load)"
)


def single_key_groups(col_selector) -> List[List[str]]:
    """The selector's key groups, one column each; a multi-column group raises."""
    groups = []
    for entry in col_selector.grouped_names:
        if isinstance(entry, tuple):
            raise NotImplementedError(UNSUPPORTED_MULTI_KEY)
        groups.append([entry])
    return groups


def hash_multi_key(arrays: Sequence[torch.Tensor], seed: int) -> torch.Tensor:
    """The reference's combined 32-bit hash of int key columns
    (groupby_stats.py:53-62), held in int64."""
    h = hash_array(arrays[0], seed=seed)
    for i, a in enumerate(arrays[1:], start=1):
        h = hash_lanes(h, hash_array(a, seed=seed + 31 * i), seed=seed + 17)
    return h


def _partial_names(needs: Dict[str, set]) -> List[Tuple[str, str]]:
    """(payload name, how partials combine) in the reference's order."""
    out = []
    for cont, need in needs.items():
        for part, name, how in (
            ("count", "cnt", "sum"), ("sum", "sum", "sum"), ("sqsum", "sq", "sum"),
            ("min", "min", "amin"), ("max", "max", "amax"),
        ):
            if part in need:
                out.append((f"{cont}__{name}", how))
    out.append(("__rows", "sum"))
    return out


def _partial_values(part: str, vals: torch.Tensor) -> torch.Tensor:
    """A batch's per-row contribution to one partial aggregate; NaN rows
    contribute nothing."""
    valid = ~torch.isnan(vals)
    if part == "cnt":
        return valid.long()
    if part == "min":
        return torch.where(valid, vals, float("inf"))
    if part == "max":
        return torch.where(valid, vals, float("-inf"))
    safe = torch.where(valid, vals, 0.0)
    return safe if part == "sum" else safe * safe


def _combine(inv: torch.Tensor, size: int, values: torch.Tensor, how: str) -> torch.Tensor:
    if how == "sum":
        return torch.zeros(size, dtype=values.dtype, device=values.device).index_add_(0, inv, values)
    fill = float("inf") if how == "amin" else float("-inf")
    out = torch.full((size,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, inv, values, how)


def _unique_rows(keys: torch.Tensor):
    """Distinct rows of ``keys`` [n, K] in ascending lexicographic order, and
    each row's index among them."""
    if keys.shape[1] == 1:
        uniq, inv = torch.unique(keys[:, 0], sorted=True, return_inverse=True)
        return uniq[:, None], inv
    return torch.unique(keys, dim=0, sorted=True, return_inverse=True)


class GroupbyStatsAccum:
    """Streaming (key → aggregates) accumulator for one key group."""

    def __init__(self, key_cols: List[str], agg_specs: Dict[str, List[str]]):
        """agg_specs: {cont column: [aggs]}; ``__rows`` is always counted."""
        self.key_cols = list(key_cols)
        self.agg_specs = {c: list(a) for c, a in agg_specs.items()}
        self._needs = {c: {p for a in aggs for p in _AGG_NEEDS[a]} for c, aggs in self.agg_specs.items()}
        self._parts = _partial_names(self._needs)
        self.key_dtypes: Optional[List[torch.dtype]] = None
        # partials: (keys [U, K] int64, {payload name: [U]})
        self.partials: List[Tuple[torch.Tensor, Dict[str, torch.Tensor]]] = []
        self.rows = 0

    def update(self, key_arrays: Sequence[torch.Tensor], cont_arrays: Dict[str, torch.Tensor]):
        """One batch: key tensors in ``key_cols`` order and the continuous
        columns as float64 with NaN for nulls, all on one device."""
        dtypes = [k.dtype for k in key_arrays]
        for d in dtypes:
            if d.is_floating_point or d == torch.bool:
                raise NotImplementedError(
                    "non-integer group keys are not ported yet (ROADMAP.md queue 1: strings and hybrid execution)"
                )
        self.key_dtypes = (
            dtypes if self.key_dtypes is None
            else [torch.promote_types(a, b) for a, b in zip(self.key_dtypes, dtypes)]
        )
        keys, inv = _unique_rows(torch.stack([k.long() for k in key_arrays], dim=1))
        U = keys.shape[0]
        payload = {"__rows": _combine(inv, U, torch.ones_like(inv), "sum")}
        for name, how in self._parts[:-1]:
            cont, _, part = name.rpartition("__")
            payload[name] = _combine(inv, U, _partial_values(part, cont_arrays[cont]), how)
        self.partials.append((keys, payload))
        self.rows += U
        if self.rows > _REAGG_ROWS:
            self._reaggregate()

    def _reaggregate(self):
        if len(self.partials) <= 1:
            return
        keys, inv = _unique_rows(torch.cat([k for k, _ in self.partials]))
        payload = {
            name: _combine(inv, keys.shape[0], torch.cat([p[name] for _, p in self.partials]), how)
            for name, how in self._parts
        }
        self.partials = [(keys, payload)]
        self.rows = keys.shape[0]

    def merge(self, other: "GroupbyStatsAccum") -> "GroupbyStatsAccum":
        self.partials.extend(other.partials)
        self.rows += other.rows
        return self

    def finalize(self) -> "KeyedStats":
        """The aggregates as numpy arrays, keys ascending (groupby_stats.py:144-189)."""
        if not self.partials:
            return KeyedStats(self.key_cols, {}, {k: np.array([], dtype=np.int64) for k in self.key_cols})
        self._reaggregate()
        keys, payload = self.partials[0]
        keys = keys.cpu().numpy()
        raw = {name: v.cpu().numpy() for name, v in payload.items()}
        key_arrays = {
            k: keys[:, i].astype(_numpy_dtype(d)) for i, (k, d) in enumerate(zip(self.key_cols, self.key_dtypes))
        }
        stats: Dict[str, np.ndarray] = {"__rows": raw["__rows"].astype(np.float64)}
        for cont, aggs in self.agg_specs.items():
            cnt, s, sq = raw.get(f"{cont}__cnt"), raw.get(f"{cont}__sum"), raw.get(f"{cont}__sq")
            for a in aggs:
                key = f"{cont}.{a}" if cont else a
                with np.errstate(invalid="ignore", divide="ignore"):
                    if a == "count":
                        stats[key] = cnt.astype(np.float64)
                    elif a == "sum":
                        stats[key] = s
                    elif a == "mean":
                        stats[key] = np.where(cnt > 0, s / np.maximum(cnt, 1), np.nan)
                    elif a in ("std", "var"):
                        # ddof=1, as the reference's moments
                        v = (sq - s * s / np.maximum(cnt, 1)) / np.maximum(cnt - 1, 1)
                        v = np.where(cnt > 1, np.maximum(v, 0.0), np.nan)
                        stats[key] = np.sqrt(v) if a == "std" else v
                    else:  # min, max
                        stats[key] = raw[f"{cont}__{a}"]
        return KeyedStats(self.key_cols, stats, key_arrays)


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


class GroupIndex:
    """One group's key → stat-row table on a device: a batch's key column
    maps to its group row, a miss or a null key to the pad slot num_groups
    (the reference's ``device_group_index``, groupby_stats.py:590-610)."""

    def __init__(self, keyed: "KeyedStats", device):
        self.num_groups = keyed.num_groups
        lut = keyed.lookup_struct()
        self.table = None if lut is None else BATCHED[kind_of(lut)]([lut]).to(device)
        self.zero = torch.zeros(1, dtype=torch.int32, device=device)

    def __call__(self, col: Column) -> torch.Tensor:
        """int32 [N] group rows of the key column ``col``."""
        values = int32_keys(col)
        if self.table is None:  # nothing fitted: every row reads the pad slot 0
            return torch.zeros_like(values)
        validity = None if col.validity is None else col.validity[None]
        out = self.table.encode(values[None], validity, self.zero, self.zero, self.num_groups, self.num_groups)
        return out[0]


class KeyedStats:
    """Fitted per-key statistics: ``key_arrays`` (numpy, one per key column)
    and ``stats`` (numpy float64 arrays aligned with them)."""

    def __init__(self, key_cols: List[str], stats: Dict[str, np.ndarray], key_arrays: Dict[str, np.ndarray]):
        self.key_cols = list(key_cols)
        self.stats = stats
        self.key_arrays = key_arrays
        self._lut = None
        self._padded: Dict[tuple, np.ndarray] = {}

    @property
    def num_groups(self) -> int:
        return len(self.key_arrays[self.key_cols[0]]) if self.key_cols else 0

    def _single_key(self) -> np.ndarray:
        if len(self.key_cols) != 1:
            raise NotImplementedError(UNSUPPORTED_MULTI_KEY)
        return np.asarray(self.key_arrays[self.key_cols[0]])

    def row_indices(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host join of one key column → (stat row, found) per entry."""
        fitted = self._single_key()
        if self.num_groups == 0:
            return np.zeros(len(keys), dtype=np.int64), np.zeros(len(keys), dtype=bool)
        order = np.argsort(fitted, kind="stable")
        pos = np.minimum(np.searchsorted(fitted[order], keys), self.num_groups - 1)
        found = fitted[order][pos] == keys
        return np.where(found, order[pos], 0), found

    def lookup_struct(self):
        """Tiny, direct or cuckoo table key → stat row (``tiny_max`` 512,
        groupby_stats.py:529-547), or None with no fitted group."""
        keys = self._single_key()
        if self._lut is None and len(keys):
            self._lut = build_lookup(keys, np.arange(len(keys), dtype=np.int32), tiny_max=GROUP_TINY_MAX)
        return self._lut

    def group_index(self, device) -> GroupIndex:
        return GroupIndex(self, device)

    def padded_stat(self, stat: str, default, dtype=np.float32) -> np.ndarray:
        """The stat with the pad slot ``default`` appended at num_groups;
        counts ride as int32 (exact to 2**31), stats as float32."""
        key = (stat, repr(default), np.dtype(dtype).str)
        if key not in self._padded:
            arr = np.asarray(self.stats[stat]).astype(dtype)
            self._padded[key] = np.append(arr, np.asarray(default).astype(dtype))
        return self._padded[key]


def sum_over_folds(keyed: KeyedStats, fold_name: str) -> KeyedStats:
    """(fold, group) stats summed to per-group totals, keys ascending (the
    reference's _sum_over_folds, target_encoding.py:482-493, orders them as
    arrow's group_by meets them; the stats are the same)."""
    group_cols = [k for k in keyed.key_cols if k != fold_name]
    keys = np.stack([np.asarray(keyed.key_arrays[k]) for k in group_cols], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    stats = {
        name: np.bincount(inv, weights=values, minlength=len(uniq)) for name, values in keyed.stats.items()
    }
    key_arrays = {k: uniq[:, i].astype(keyed.key_arrays[k].dtype) for i, k in enumerate(group_cols)}
    return KeyedStats(group_cols, stats, key_arrays)
