"""Per-key aggregation shared by TargetEncoding and JoinGroupby.

Counterpart of ``nvtabular_tpu/ops/groupby_stats.py`` (:53-189, 364-378,
529-627, 629-660) without pyarrow:

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
  on the device (``GroupIndex``): one key column through the Categorify
  lookup kernels (K10a); a group of several columns through the verified
  hash pair (K10b, ``build_hash_pair``): h1 probes a K1/K3 table built over
  the fitted tuples' h1, and the tuple's h2 must match the row's.

A multi-process fit reduces the accumulators of every rank
(``reduce_accums_multihost``, groupby_stats.py:192-346): large tables
(``NVT_GROUPBY_EXCHANGE_MIN`` groups, 65536 by default) send each partial
row to the owner of its key tuple through one all_to_all and the owners
aggregate what they receive with the same sort-based group-by, by the full
key tuple; small ones take the allgather of whole accumulators.

A multi-column group whose pair cannot be built (keys outside int32, or a
collision among the fitted tuples' h1) raises; the reference joins it on the
host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import os

import numpy as np
import torch

from ..dispatch import hash_array, hash_lanes
from ..kernels.hash_pair import hash_pair, hash_pair_verify
from ..table import Column
from ..unported import message
from .lookup import BATCHED, build_lookup, fits_int32, int32_keys, kind_of

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

UNSUPPORTED_PAIR = (
    "the verified hash pair of a multi-column group cannot be built ({}): the reference joins such "
    "a group on the host, which is not ported yet (ROADMAP.md queue 1 item 4: strings and hybrid execution)"
)
UNSUPPORTED_ARTIFACTS = (
    "the parquet stat artifacts (out_path) are not ported yet: the port keeps fitted "
    "stats in memory (ROADMAP.md queue 1 item 2: save/load)"
)


def key_groups(col_selector) -> List[List[str]]:
    """The selector's key groups: a column alone, or a tuple's columns."""
    return [list(e) if isinstance(e, tuple) else [e] for e in col_selector.grouped_names]


def hash_multi_key(arrays: Sequence[torch.Tensor], seed: int) -> torch.Tensor:
    """The reference's combined 32-bit hash of int key columns
    (groupby_stats.py:53-62), held in int64. The group indexes compute it
    with ``kernels.hash_pair`` (both seeds in one launch)."""
    h = hash_array(arrays[0], seed=seed)
    for i, a in enumerate(arrays[1:], start=1):
        h = hash_lanes(h, hash_array(a, seed=seed + 31 * i), seed=seed + 17)
    return h


def build_hash_pair(arrays: Sequence[np.ndarray]):
    """(table h1 → fitted row, int32 [G + 1] h2 of each fitted tuple then a
    0 pad) over the fitted tuples ``arrays`` (one array a key column; the
    reference's hashed_lookup_struct, groupby_stats.py:549-588, and
    _combo_device_struct, categorify.py:1322-1379). h1 is wrapped to int32
    and the table built with ``tiny_max`` 512. Raises NotImplementedError
    for keys outside int32 and for a collision among the fitted h1."""
    for a in arrays:
        if a.dtype.kind not in ("i", "u"):
            raise NotImplementedError(UNSUPPORTED_PAIR.format("non-integer keys"))
        if not fits_int32(a):
            raise NotImplementedError(UNSUPPORTED_PAIR.format("keys outside int32"))
    h1, h2 = hash_pair([torch.from_numpy(np.asarray(a).astype(np.int64)) for a in arrays])
    h1 = h1.numpy()
    if len(np.unique(h1)) != len(h1):
        raise NotImplementedError(UNSUPPORTED_PAIR.format("the fitted tuples' 32-bit h1 collide"))
    lut = build_lookup(h1, np.arange(len(h1), dtype=np.int32), tiny_max=GROUP_TINY_MAX)
    return lut, np.append(h2.numpy(), np.int32(0))


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
                raise NotImplementedError(message("a non-integer group key", 4))
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
        if len(self.partials) > 1:
            self._group()

    def _group(self):
        """The partials as one, grouped by the full key tuple."""
        keys, inv = _unique_rows(torch.cat([k for k, _ in self.partials]))
        payload = {
            name: _combine(inv, keys.shape[0], torch.cat([p[name] for _, p in self.partials]), how)
            for name, how in self._parts
        }
        self.partials = [(keys, payload)]
        self.rows = keys.shape[0]

    def merge(self, other: "GroupbyStatsAccum") -> "GroupbyStatsAccum":
        """Another rank's accumulator added to this one (on this one's device)."""
        if other.key_dtypes is not None:
            self.key_dtypes = other.key_dtypes if self.key_dtypes is None else [
                torch.promote_types(a, b) for a, b in zip(self.key_dtypes, other.key_dtypes)
            ]
        dev = self.partials[0][0].device if self.partials else None
        for keys, payload in other.partials:
            if dev is not None:
                keys, payload = keys.to(dev), {k: v.to(dev) for k, v in payload.items()}
            self.partials.append((keys, payload))
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


def _h64_multi_key(arrays: Sequence[torch.Tensor]) -> np.ndarray:
    """64-bit composite hash of int key tuples (groupby_stats.py:45-50): the
    hash pair's two 32-bit hashes in one int64; it places a tuple on its
    owner process, nothing more."""
    h1 = hash_multi_key(arrays, seed=0xA1).numpy().astype(np.uint64)
    h2 = hash_multi_key(arrays, seed=0xB7).numpy().astype(np.uint64)
    return ((h1 << np.uint64(32)) | h2).view(np.int64)


def _accum_lane_spec(accum: GroupbyStatsAccum):
    """(name, dtype) of the lanes a partial row travels in (groupby_stats.py:
    192-212): the key columns as int64, then the payloads in the
    accumulator's order. Derived from the op's configuration alone, so every
    process computes the same layout."""
    keys = [(k, np.int64) for k in accum.key_cols]
    payloads = [(name, np.int64 if name == "__rows" or name.endswith("__cnt") else np.float64)
                for name, _ in accum._parts]
    return keys, payloads


def _exchange_accum(accum: GroupbyStatsAccum, key_dtypes) -> GroupbyStatsAccum:
    """One accumulator reduced over every process through the all_to_all
    row exchange (groupby_stats.py:215-272): each partial row goes to the
    owner of its key tuple, owners group what they receive by the full key
    tuple (exact under hash collisions: the hash only places a row), and
    the owners' disjoint tables are gathered by every process. The result
    lies on the host."""
    from ..parallel.multihost import allgather_pyobj, process_count
    from ..parallel.sharded_vocab import _owner_of_int64, exchange_keyed_rows, pack_i64_lanes, unpack_i64_lanes

    accum._reaggregate()
    keys_spec, payload_spec = _accum_lane_spec(accum)
    width = 2 * (len(keys_spec) + len(payload_spec))
    if accum.partials:
        keys, payload = accum.partials[0]
        keys = keys.cpu()
        cols = [keys[:, i].numpy() for i in range(keys.shape[1])]
        cols += [payload[name].cpu().numpy().astype(dt) for name, dt in payload_spec]
        lanes = np.hstack([pack_i64_lanes(np.ascontiguousarray(c)) for c in cols])
        key64 = _h64_multi_key([keys[:, i].contiguous() for i in range(keys.shape[1])]) if keys.shape[1] > 1 else cols[0]
        owner = _owner_of_int64(key64, process_count())
    else:
        lanes, owner = np.empty((0, width), dtype=np.int32), np.empty(0, dtype=np.int64)
    recv = exchange_keyed_rows(lanes, owner)
    owned = GroupbyStatsAccum(accum.key_cols, accum.agg_specs)
    owned.key_dtypes = list(key_dtypes)
    if len(recv):
        nk = len(keys_spec)
        rkeys = np.stack([unpack_i64_lanes(recv[:, 2 * j: 2 * j + 2], np.int64) for j in range(nk)], axis=1)
        rpayload = {
            name: torch.from_numpy(unpack_i64_lanes(recv[:, 2 * (nk + j): 2 * (nk + j) + 2], dt))
            for j, (name, dt) in enumerate(payload_spec)
        }
        owned.partials = [(torch.from_numpy(rkeys), rpayload)]
        owned._group()
    merged = GroupbyStatsAccum(accum.key_cols, accum.agg_specs)
    merged.key_dtypes = list(key_dtypes)
    for shard in allgather_pyobj(owned):
        merged.partials.extend(shard.partials)
        merged.rows += shard.rows
    return merged


def reduce_accums_multihost(accums: Dict[str, GroupbyStatsAccum], threshold: Optional[int] = None):
    """Multi-process reduction of a dict of accumulators (groupby_stats.py:
    275-331): those with at least ``threshold`` groups on some process ride
    the all_to_all row exchange, the others the allgather of whole
    accumulators. The route is decided from allgathered metadata, so every
    process issues the same collectives. Returns (merged accumulators,
    {"exchange": [tags], "gather": [tags]})."""
    from ..parallel.multihost import allgather_pyobj, process_count

    if process_count() == 1:
        return accums, {"exchange": [], "gather": sorted(accums)}
    if threshold is None:
        threshold = int(os.environ.get("NVT_GROUPBY_EXCHANGE_MIN", 65536))
    local_meta = {}
    for tag in sorted(accums):
        a = accums[tag]
        a._reaggregate()
        local_meta[tag] = (a.rows, a.key_dtypes)
    all_meta = allgather_pyobj(local_meta)
    exchange_tags = [t for t in sorted(accums) if max(m[t][0] for m in all_meta) >= threshold]
    gather_tags = [t for t in sorted(accums) if t not in exchange_tags]
    out = {}
    for tag in exchange_tags:
        key_dtypes = None
        for _, kd in (m[tag] for m in all_meta):
            if kd is not None:
                key_dtypes = kd if key_dtypes is None else [torch.promote_types(a, b) for a, b in zip(key_dtypes, kd)]
        out[tag] = _exchange_accum(accums[tag], key_dtypes or [torch.int64] * len(accums[tag].key_cols))
    if gather_tags:
        gathered = allgather_pyobj({t: accums[t] for t in gather_tags})
        merged = gathered[0]
        for other in gathered[1:]:
            for t in merged:
                merged[t].merge(other[t])
        out.update(merged)
    return out, {"exchange": exchange_tags, "gather": gather_tags}


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


class PairIndex:
    """A verified hash pair on a device (``build_hash_pair``'s table and
    fitted h2): a row's key tuple → its fitted row, in three launches (K10b
    and K9): ``hash_pair``, the K1/K3 probe of h1 with the miss code
    ``misses`` (the number of fitted tuples), ``hash_pair_verify``. With no
    fitted tuple (``pair`` None) every row misses."""

    def __init__(self, pair, device, misses: int):
        self.misses = misses
        self.table = None if pair is None else BATCHED[kind_of(pair[0])]([pair[0]]).to(device)
        h2 = np.zeros(1, dtype=np.int32) if pair is None else pair[1]
        self.h2 = torch.from_numpy(h2).to(device)
        self.zero = torch.zeros(1, dtype=torch.int32, device=device)

    def __call__(self, cols: Sequence[Column], hit_offset: int, oov: int, null: int) -> torch.Tensor:
        """int32 [N]: a verified hit → its row + ``hit_offset``; a miss →
        ``oov``; a row with a null member → ``null``."""
        if self.table is None:
            idx = torch.full_like(cols[0].values, self.misses, dtype=torch.int32)
            h2 = torch.zeros_like(idx)
        else:
            h1, h2 = hash_pair([c.values for c in cols])
            idx = self.table.encode(h1[None], None, self.zero, self.zero, self.misses, self.misses)[0]
        validity = [c.validity for c in cols if c.validity is not None]
        return hash_pair_verify(idx, h2, self.h2, validity, self.misses, hit_offset, oov, null)


class GroupIndex:
    """One group's key → stat-row table on a device: a batch's key columns
    map to their group row, a miss or a null key to the pad slot num_groups
    (the reference's ``device_group_index``, groupby_stats.py:590-627)."""

    def __init__(self, keyed: "KeyedStats", device):
        G = self.num_groups = keyed.num_groups
        self.pair = None
        lut = None
        if len(keyed.key_cols) == 1:
            lut = keyed.lookup_struct()
        elif G:
            self.pair = PairIndex(keyed.hashed_lookup_struct(), device, G)
        self.table = None if lut is None else BATCHED[kind_of(lut)]([lut]).to(device)
        self.zero = torch.zeros(1, dtype=torch.int32, device=device)

    def __call__(self, *cols: Column) -> torch.Tensor:
        """int32 [N] group rows of the key columns ``cols`` (in the group's
        key order)."""
        G = self.num_groups
        if self.pair is not None:
            return self.pair(cols, 0, G, G)
        if self.table is None:  # nothing fitted: every row reads the pad slot 0
            return torch.zeros(cols[0].values.shape[0], dtype=torch.int32, device=cols[0].values.device)
        col = cols[0]
        validity = None if col.validity is None else col.validity[None]
        return self.table.encode(int32_keys(col)[None], validity, self.zero, self.zero, G, G)[0]


class KeyedStats:
    """Fitted per-key statistics: ``key_arrays`` (numpy, one per key column)
    and ``stats`` (numpy float64 arrays aligned with them)."""

    def __init__(self, key_cols: List[str], stats: Dict[str, np.ndarray], key_arrays: Dict[str, np.ndarray]):
        self.key_cols = list(key_cols)
        self.stats = stats
        self.key_arrays = key_arrays
        self._lut = None
        self._pair = None
        self._padded: Dict[tuple, np.ndarray] = {}

    @property
    def num_groups(self) -> int:
        return len(self.key_arrays[self.key_cols[0]]) if self.key_cols else 0

    def _keys(self) -> List[np.ndarray]:
        return [np.asarray(self.key_arrays[k]) for k in self.key_cols]

    def row_indices(self, key_arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        """Exact host join of key tuples (one array a key column, in
        ``key_cols`` order) → (stat row, found) per entry."""
        n = len(key_arrays[0])
        if self.num_groups == 0:
            return np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)
        if len(self.key_cols) == 1:
            fitted, keys = self._keys()[0], np.asarray(key_arrays[0])
            order = np.argsort(fitted, kind="stable")
            pos = np.minimum(np.searchsorted(fitted[order], keys), self.num_groups - 1)
            found = fitted[order][pos] == keys
            return np.where(found, order[pos], 0), found
        fitted = np.stack([a.astype(np.int64) for a in self._keys()], axis=1)
        queries = np.stack([np.asarray(a).astype(np.int64) for a in key_arrays], axis=1)
        _, inv = np.unique(np.concatenate([fitted, queries]), axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        row_of = np.full(int(inv.max()) + 1, -1, dtype=np.int64)
        row_of[inv[: self.num_groups]] = np.arange(self.num_groups)
        rows = row_of[inv[self.num_groups :]]
        found = rows >= 0
        return np.where(found, rows, 0), found

    def lookup_struct(self):
        """The table a group index probes, or None with no fitted group: one
        key column's tiny, direct or cuckoo table key → stat row (``tiny_max``
        512, groupby_stats.py:529-547); for several columns the table over
        the fitted tuples' h1 (``hashed_lookup_struct``)."""
        if len(self.key_cols) != 1:
            pair = self.hashed_lookup_struct()
            return None if pair is None else pair[0]
        keys = self._keys()[0]
        if self._lut is None and len(keys):
            self._lut = build_lookup(keys, np.arange(len(keys), dtype=np.int32), tiny_max=GROUP_TINY_MAX)
        return self._lut

    def hashed_lookup_struct(self):
        """(h1 table, h2 of each fitted tuple + pad) of a multi-column group
        (``build_hash_pair``), or None with no fitted group."""
        if self._pair is None and self.num_groups:
            self._pair = build_hash_pair(self._keys())
        return self._pair

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
