"""Categorify — dictionary-encode integer and float categorical columns.

Counterpart of ``nvtabular_tpu/ops/categorify.py`` for joint and
single-column encoding of integer and float columns. Same encoding layout:
code 0 is padding, 1 null, then ``num_buckets`` out-of-vocabulary buckets
from 2 (one by default), then vocabulary ids in descending-frequency order
from ``2 + num_buckets``; ``single_table`` shifts each vocabulary into one
global index space. With ``num_buckets`` nb > 1 a miss takes bucket
``2 + hash_array(v) % nb`` (categorify.py:628-634).

* Fit counts values on the device the batch lives on (``torch.unique`` per
  batch, partials merged) and orders the vocabulary by (-count, value) — the
  JAX fit's order element for element (categorify.py:249, 306-309), then
  applies ``freq_threshold`` and the ``max_size`` budget, ``max_size - (2 +
  nb)`` keys (:1065-1072). Floats drop NaN as null (:155-159) and count by
  bit pattern, as arrow's ``value_counts`` does: -0.0 and 0.0 are two keys.
* Transform is the column-batched device path (``_encode_batched_device``,
  :1614-1685): one kernel launch per table kind (tiny, direct, cuckoo) over
  the stacked [C, N] int32 values, with the null/OOV/offset epilogue fused,
  and one launch of the sorted table (K8) over the stacked float columns as
  float32 — the reference encodes each float column alone through
  ``encode_device``'s searchsorted (:1453, :570-576); one launch over the
  stacked columns gives the same codes.
* A list (multihot) column counts its flat values in the fit, with no
  validity (:848-857); at transform its flat values take a launch of their
  own per table kind, without the null epilogue, and its codes keep the
  column's offsets (:1456-1458, :1631-1669).
* Multi-process and mesh fits (categorify.py:749-1060): ``fit_mesh``
  counts each single integer column of the phase on the mesh's data axis
  (kernel K15a: route, all_to_all, sort; ``parallel/sharded_vocab.py``),
  keys outside int32 or equal to its pad on the host counter;
  ``fit_reduce_multihost`` reduces large integer vocabularies of several
  ranks through an all_to_all of (key, count) pairs
  (``exchange_partial_counts``; ``NVT_VOCAB_EXCHANGE_MIN`` unique keys,
  65536 by default) and the rest through ``fit_merge`` of every rank's
  accumulators.
* ``encode_type="combo"``: a subgroup ``("a", "b")`` is one crossed output
  column ``a_b`` (joined by ``name_sep``, :709-729). The fit counts the
  member tuples on the card (a row with a null member is null, not a
  tuple); the finalize orders them by (-count, the members joined by "_"
  as strings), the reference's order over its string keys (:306-308,
  1827-1840). The vocabulary holds the tuples, int64 [V, k], in code order.
  The transform maps each row's tuple through the verified hash pair (K9,
  ``groupby_stats.PairIndex``, :1322-1410).

* Vocabulary artifacts and memory (categorify.py:413-471, 1110-1259): each
  fitted vocabulary is written to ``<out_path>/categories/unique.<key>.parquet``
  (its values and ``<key>_size`` counts) by the port's parquet writer.
  ``cat_cache`` ("device", "host" or "disk", per column) and
  ``cardinality_memory_limit`` (bytes or a size string) decide which
  vocabularies stay resident: a disk-tier vocabulary is released after the
  fit and after every transform, and an LRU over the columns releases the
  least recently used past the budget (``cache_stats`` counts hits, reloads
  and releases); a released vocabulary reloads from its artifact at its
  next use. ``host_nbytes`` counts what the reference counts, less its C++
  host table.
* K8's solo-table branch (``encode_device``, :552-585): a disk-tier column,
  and every column under a budget, encodes alone through its own tiny,
  direct or cuckoo table (``build_lookup``'s default ``tiny_max``, no lone
  tiny demotion), built once per resident vocabulary and launched with one
  table row on K1, K2 or K3 (``*_lookup_solo`` launches); float
  vocabularies take K8's sorted table the same way.
* ``vocabs=`` (arrays, lists, Columns or parquet paths, :1735-1757) fits the
  op at construction (``fit_generation`` 0, so ``Workflow.fit`` keeps it)
  and writes its artifacts; ``dtype=`` casts the codes.

Not ported yet (raise NotImplementedError, naming the ROADMAP item):
string and bool columns and keys outside int32 (item 4), combo columns with
``num_buckets > 1`` (item 4, the reference's host path). A combo group's
tuples are strings in the reference's artifact: the port writes none for
them (item 16), so a combo vocabulary is never released.
"""

from __future__ import annotations

import logging
import os
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import dtypes as md
from ..kernels.lookup import NULL_INDEX
from ..selector import ColumnSelector
from ..table import Column, TableBatch, to_torch_dtype
from ..tags import Tags
from .groupby_stats import PairIndex, build_hash_pair
from .lookup import BATCHED, build_cuckoo, build_lookup, int32_keys, kind_of
from .stat_operator import StatOperator

OOV_OFFSET = 2  # codes 0 pad, 1 null, 2 out-of-vocabulary (kernels/lookup.py)
_REAGG_ROWS = 1 << 24  # merge partial counts past this many entries
_LONE_TINY_MAX = 512  # categorify.py:1513-1522

UNSUPPORTED_COMBO_BUCKETS = (
    "Categorify(encode_type='combo', num_buckets > 1) runs on the reference's host path, "
    "which is not ported yet (ROADMAP.md queue 1 item 4: strings and hybrid execution)"
)
UNSUPPORTED_KEYS = (
    "Categorify of string, object or bool columns is not ported yet "
    "(ROADMAP.md queue 1 item 4: strings and hybrid execution)"
)
UNSUPPORTED_MIXED = (
    "Categorify of {} is not ported yet (ROADMAP.md queue 1 item 4: strings and hybrid execution)"
)
SOLO_COUNTERS = {"tiny": "tiny_lookup_solo", "direct": "direct_lookup_solo", "cuckoo": "cuckoo_lookup_solo"}
LOG = logging.getLogger("nvtabular_tpu_torch")


def _per_column(option, key, default):
    """dict-or-scalar option pattern."""
    if option is None:
        return default
    if isinstance(option, dict):
        return option.get(key, default)
    return option


def _safe_name(name: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in name)


def _emb_sz_rule(n_cat: int, minimum_size=16, maximum_size=512) -> Tuple[int, int]:
    return n_cat, min(max(minimum_size, round(1.6 * n_cat**0.56)), maximum_size)


_INT64_MAX = torch.iinfo(torch.int64).max


def _order_keys(values: torch.Tensor) -> torch.Tensor:
    """Floats → int64 keys in the same order, one per bit pattern (-0.0 just
    below 0.0): the float64 bits, negatives flipped (float32 widens
    exactly). The map is its own inverse (``_from_order_keys``)."""
    bits = values.to(torch.float64).view(torch.int64)
    return torch.where(bits < 0, bits ^ _INT64_MAX, bits)


def _from_order_keys(keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.where(keys < 0, keys ^ _INT64_MAX, keys).view(torch.float64).to(dtype)


def _on_device_of(mine: List[Tuple[torch.Tensor, torch.Tensor]], theirs):
    """``theirs`` partials on the device of ``mine`` (as they are when
    ``mine`` is empty)."""
    if not mine:
        return list(theirs)
    dev = mine[0][0].device
    return [(a.to(dev), b.to(dev)) for a, b in theirs]


class _VocabAccum:
    """Streaming (value, count) accumulator on the batch's device. Floats
    count by bit pattern (``_order_keys``), NaN dropped as null."""

    def __init__(self):
        self.partials: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.rows = 0
        self.dtype: Optional[torch.dtype] = None  # of every column seen, empty batches too

    def update(self, values: torch.Tensor, validity: Optional[torch.Tensor]):
        if values.dtype == torch.bool:
            raise NotImplementedError(UNSUPPORTED_KEYS)
        if self.dtype is not None and self.dtype.is_floating_point != values.is_floating_point():
            raise NotImplementedError(UNSUPPORTED_MIXED.format("a joint group of integer and float columns"))
        self.dtype = values.dtype if self.dtype is None else torch.promote_types(self.dtype, values.dtype)
        if validity is not None:
            values = values[validity]
        if values.is_floating_point():
            values = _order_keys(values[~torch.isnan(values)])
        if values.numel() == 0:
            return
        uniq, counts = torch.unique(values, return_counts=True)
        self.partials.append((uniq, counts))
        self.rows += uniq.numel()
        if self.rows > _REAGG_ROWS:
            self._merge()

    def merge(self, other: "_VocabAccum") -> "_VocabAccum":
        """Another rank's accumulator added to this one (on this one's device)."""
        if other.dtype is not None:
            if self.dtype is not None and self.dtype.is_floating_point != other.dtype.is_floating_point:
                raise NotImplementedError(UNSUPPORTED_MIXED.format("a joint group of integer and float columns"))
            self.dtype = other.dtype if self.dtype is None else torch.promote_types(self.dtype, other.dtype)
        self.partials.extend(_on_device_of(self.partials, other.partials))
        self.rows += other.rows
        return self

    @classmethod
    def from_counts(cls, values: np.ndarray, counts: np.ndarray, dtype, device) -> "_VocabAccum":
        """The accumulator of (integer value, count) pairs with distinct
        values, in any order; ``dtype`` is the columns' integer dtype."""
        accum = cls()
        accum.dtype = dtype
        if len(values):
            order = np.argsort(values, kind="stable")
            keys = torch.from_numpy(np.ascontiguousarray(values[order])).to(device=device, dtype=dtype)
            accum.partials = [(keys, torch.from_numpy(np.ascontiguousarray(counts[order])).to(device))]
            accum.rows = len(values)
        return accum

    def counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """(values ascending, counts) of an integer accumulator, int64 on the host."""
        if len(self.partials) > 1:
            self._merge()
        if not self.partials:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        values, counts = self.partials[0]
        return values.cpu().numpy().astype(np.int64), counts.cpu().numpy().astype(np.int64)

    def _merge(self):
        values = torch.cat([v.to(torch.int64 if self.dtype.is_floating_point else self.dtype)
                            for v, _ in self.partials])
        counts = torch.cat([c for _, c in self.partials])
        uniq, inverse = torch.unique(values, return_inverse=True)
        merged = torch.zeros(uniq.numel(), dtype=counts.dtype, device=counts.device)
        merged.scatter_add_(0, inverse, counts)
        self.partials = [(uniq, merged)]
        self.rows = uniq.numel()

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """→ (values sorted by (-count, value), counts) as numpy."""
        dtype = self.dtype or torch.int64
        if not self.partials:
            return torch.empty(0, dtype=dtype).numpy(), np.array([], dtype=np.int64)
        if len(self.partials) > 1:
            self._merge()
        values, counts = self.partials[0]  # values ascending
        order = torch.argsort(counts, descending=True, stable=True)
        values = values[order]
        if dtype.is_floating_point:
            values = _from_order_keys(values, dtype)
        return values.cpu().numpy(), counts[order].cpu().numpy()


class _ComboAccum:
    """Streaming (member tuple, count) accumulator of a combo group on the
    batch's device."""

    def __init__(self, width: int):
        self.width = width
        self.partials: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.rows = 0

    def update(self, cols: List[Column]):
        for c in cols:
            if c.values.is_floating_point() or c.values.dtype == torch.bool or c.is_list:
                raise NotImplementedError(UNSUPPORTED_KEYS)
        keys = torch.stack([c.values.long() for c in cols], dim=1)
        valid = None
        for c in cols:  # a null member makes the row null (_combo_values, :1827-1840)
            if c.validity is not None:
                valid = c.validity if valid is None else valid & c.validity
        if valid is not None:
            keys = keys[valid]
        if keys.shape[0] == 0:
            return
        self.partials.append(torch.unique(keys, dim=0, return_counts=True))
        self.rows += self.partials[-1][1].numel()
        if self.rows > _REAGG_ROWS:
            self._merge()

    def merge(self, other: "_ComboAccum") -> "_ComboAccum":
        """Another rank's accumulator added to this one (on this one's device)."""
        self.partials.extend(_on_device_of(self.partials, other.partials))
        self.rows += other.rows
        return self

    def _merge(self):
        keys = torch.cat([k for k, _ in self.partials])
        counts = torch.cat([c for _, c in self.partials])
        uniq, inverse = torch.unique(keys, dim=0, return_inverse=True)
        merged = torch.zeros(uniq.shape[0], dtype=counts.dtype, device=counts.device).scatter_add_(0, inverse, counts)
        self.partials = [(uniq, merged)]
        self.rows = uniq.shape[0]

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """→ (tuples int64 [V, width], counts), by (-count, joined string)."""
        if not self.partials:
            return np.zeros((0, self.width), dtype=np.int64), np.array([], dtype=np.int64)
        if len(self.partials) > 1:
            self._merge()
        keys, counts = (t.cpu().numpy() for t in self.partials[0])
        order = np.lexsort((combo_strings(keys), -counts))
        return keys[order], counts[order]


def combo_strings(tuples: np.ndarray) -> np.ndarray:
    """Each member tuple as the reference's combo key: its values joined by
    "_" (categorify.py:1834-1839)."""
    parts = tuples.astype(str)
    out = parts[:, 0]
    for i in range(1, parts.shape[1]):
        out = np.char.add(np.char.add(out, "_"), parts[:, i])
    return out


def _artifact_dtype(dtype: np.dtype) -> np.dtype:
    """The parquet column dtype a vocabulary's values are stored in."""
    if dtype.kind == "f":
        return np.dtype(np.float32 if dtype.itemsize <= 4 else np.float64)
    return np.dtype(np.int32 if dtype.itemsize < 4 or (dtype.itemsize == 4 and dtype.kind == "i") else np.int64)


class _Vocab:
    """A fitted vocabulary in code order (frequency-descending): values, or
    for a combo group the member tuples, int64 [V, k]. Codes start at
    ``start_index`` = 2 + ``num_buckets`` (categorify.py:350-354). Its
    values can be released to its parquet artifact and reloaded from it
    (categorify.py:408-471); size, offset and dtype survive a release."""

    __slots__ = ("values_by_code", "counts", "num_buckets", "start_index", "offset", "_lookup", "_sv", "_sc",
                 "_solo", "_n_values", "dtype", "is_combo", "artifact_path")

    def __init__(self, values_by_code: np.ndarray, counts: np.ndarray, num_buckets: int = 1):
        self.values_by_code = np.asarray(values_by_code)
        self.counts = counts
        self.num_buckets = max(1, int(num_buckets))
        self.is_combo = self.values_by_code.ndim == 2
        if self.is_combo and self.num_buckets > 1:
            raise NotImplementedError(UNSUPPORTED_COMBO_BUCKETS)
        self.start_index = OOV_OFFSET + self.num_buckets
        self.offset = 0  # single_table shift
        self._n_values = len(self.values_by_code)
        self.dtype = self.values_by_code.dtype
        self.artifact_path: Optional[str] = None
        self._lookup = None
        self._sv = self._sc = None  # values ascending and their codes, built with the lookup
        self._solo = None  # (device, kind, one-row Batched* table on the device)

    @property
    def size(self) -> int:
        """Total domain size including pad/null/OOV."""
        return self.start_index + self._n_values

    @property
    def resident(self) -> bool:
        return self.values_by_code is not None

    def lookup_struct(self):
        """Host-built tiny/direct/cuckoo table of integer keys or sorted
        table of float keys (ops/lookup.py), built once from the values
        ascending, as the reference's ``lookup_struct`` (:539-550); for a
        combo vocabulary its verified hash pair over the tuples (None when
        empty)."""
        if self._lookup is None and self.is_combo:
            if self._n_values:
                self._lookup = build_hash_pair(list(self.values_by_code.T))
        elif self._lookup is None:
            values = self.values_by_code
            if len(values) == 0 and values.dtype.kind not in ("i", "u", "f"):
                values = values.astype(np.int64)  # the JAX fit's empty vocabulary is an object array
            order = np.argsort(values, kind="stable")
            self._sv, self._sc = values[order], (order + self.start_index).astype(np.int64)
            self._lookup = build_lookup(self._sv, self._sc)
        return self._lookup

    def solo_table(self, device, is_float: bool):
        """(kind, this vocabulary's one-row Batched* table on ``device``),
        built once while the vocabulary is resident."""
        if self._n_values == 0:  # every value misses: the column's dtype picks the launch
            kind = "sorted" if is_float else "tiny"
            empty = np.zeros(0, np.float32 if is_float else np.int32)
            return kind, BATCHED[kind]([build_lookup(empty, np.zeros(0, np.int32))]).to(device)
        if self._solo is None or self._solo[0] != device:
            lut = self.lookup_struct()
            self._solo = (device, kind_of(lut), BATCHED[kind_of(lut)]([lut]).to(device))
        return self._solo[1], self._solo[2]

    def host_nbytes(self) -> int:
        """Bytes of host memory this vocabulary holds, counted as the
        reference counts them (categorify.py:413-428): values, counts, the
        ascending copy and its codes, and the lookup table; the reference's
        C++ host table has no counterpart here."""
        total = sum(a.nbytes for a in (self.values_by_code, self.counts, self._sv, self._sc) if a is not None)
        lut = self._lookup
        if lut is not None and not self.is_combo:
            total += sum(getattr(lut, f).nbytes for f in _TABLE_FIELDS[kind_of(lut)])
        return total

    def release_host(self) -> int:
        """Drop the values and every table built from them, the device copy
        included; needs an artifact to reload from. Returns bytes released."""
        if not self.resident or self.artifact_path is None:
            return 0
        freed = self.host_nbytes()
        self.values_by_code = self.counts = self._sv = self._sc = self._lookup = self._solo = None
        return freed

    def ensure_resident(self) -> bool:
        """Reload values and counts from the artifact if released; True when
        a reload happened."""
        if self.resident:
            return False
        if self.artifact_path is None:
            raise RuntimeError("vocabulary released without a parquet artifact")
        from ..io.native_parquet import read_row_groups

        cols = list(read_row_groups(self.artifact_path).values())
        self.values_by_code = cols[0].astype(self.dtype, copy=False)
        self.counts = cols[1] if len(cols) > 1 else np.zeros(len(cols[0]), dtype=np.int64)
        self._n_values = len(self.values_by_code)
        return True


# the arrays of each lookup kind that hold its table (host_nbytes)
_TABLE_FIELDS = {"tiny": ("keys", "codes"), "direct": ("table",), "cuckoo": ("packed",), "stash": ("packed",),
                 "sorted": ("keys", "codes")}


class Categorify(StatOperator):
    has_device_state = True

    def __init__(
        self,
        freq_threshold: Union[int, Dict[str, int]] = 0,
        out_path: Optional[str] = None,
        cat_cache: Union[str, Dict[str, str]] = "host",
        dtype=None,
        on_host: bool = True,
        encode_type: str = "joint",
        vocabs: Optional[Dict[str, Any]] = None,
        max_size: Union[int, Dict[str, int]] = 0,
        num_buckets: Union[None, int, Dict[str, int]] = None,
        single_table: bool = False,
        search_sorted: bool = False,
        split_out=None,
        split_every=None,
        cardinality_memory_limit=None,
        name_sep: str = "_",
        **kwargs,
    ):
        """The reference's signature (categorify.py:638-656). ``on_host``,
        ``split_out``, ``split_every`` and other keywords are accepted and
        ignored, as there; ``search_sorted=True`` warns and is ignored."""
        super().__init__()
        if encode_type not in ("joint", "combo"):
            raise ValueError(f"encode_type must be 'joint' or 'combo', got {encode_type!r}")
        buckets = num_buckets.values() if isinstance(num_buckets, dict) else [num_buckets]
        if encode_type == "combo" and any((nb or 1) > 1 for nb in buckets):
            raise NotImplementedError(UNSUPPORTED_COMBO_BUCKETS)
        if search_sorted:
            warnings.warn(
                "Categorify(search_sorted=True) has no effect in nvtabular_tpu_torch: integer keys take "
                "its hash and direct tables, float keys its sorted table, with the same codes",
                UserWarning,
                stacklevel=2,
            )
        self.freq_threshold = freq_threshold
        self.out_path = out_path or "./categories"
        self.cat_cache = cat_cache
        self.dtype = dtype
        self.max_size = max_size
        self.num_buckets = num_buckets
        self.single_table = single_table
        self.encode_type = encode_type
        self.name_sep = name_sep
        self.cardinality_memory_limit = cardinality_memory_limit
        self.vocabs: Dict[str, _Vocab] = {}
        self.categories: Dict[str, str] = {}  # vocab key → its parquet artifact
        self._batched_cache = None  # (vocab identity token, {kind: (batched, row_index)})
        # LRU over resident vocabularies (categorify.py:1215-1259)
        self._lru: Dict[str, int] = {}
        self._lru_tick = 0
        self.cache_stats = {"hits": 0, "reloads": 0, "releases": 0}
        if vocabs is not None:
            self._load_supplied_vocabs(vocabs)

    # --- groups ------------------------------------------------------------
    def _groups(self, col_selector: ColumnSelector) -> List[Tuple[str, List[str]]]:
        """→ [(vocab key, member columns)]: joint subgroups share one vocab;
        combo subgroups form one crossed column."""
        groups = []
        for entry in col_selector.grouped_names:
            if isinstance(entry, tuple):
                groups.append((self.name_sep.join(entry), list(entry)))
            else:
                groups.append((entry, [entry]))
        return groups

    def _is_combo(self, members: List[str]) -> bool:
        return len(members) > 1 and self.encode_type == "combo"

    def column_mapping(self, col_selector: ColumnSelector) -> Dict[str, List[str]]:
        mapping: Dict[str, List[str]] = {}
        for key, members in self._groups(col_selector):
            if self._is_combo(members):
                mapping[key] = members
            else:
                mapping.update({m: [m] for m in members})
        return mapping

    # --- fit -----------------------------------------------------------------
    def fit_init(self, col_selector: ColumnSelector, input_schema):
        return {
            key: _ComboAccum(len(members)) if self._is_combo(members) else _VocabAccum()
            for key, members in self._groups(col_selector)
        }

    def fit_batch(self, col_selector, batch: TableBatch, state):
        for key, members in self._groups(col_selector):
            if self._is_combo(members):
                state[key].update([batch[m] for m in members])
                continue
            for mcol in members:
                col = batch[mcol]
                # multihots count their flat values (categorify.py:848-857)
                state[key].update(col.values, None if col.is_list else col.validity)
        return state

    def fit_mesh_plan(self, col_selector: ColumnSelector, input_schema) -> Optional[List[str]]:
        """The columns this op counts on the mesh (categorify.py:749-773):
        every group a single integer column, or None."""
        cols: List[str] = []
        for key, members in self._groups(col_selector):
            if len(members) > 1:
                return None  # joint and combo groups mix columns
            col_schema = input_schema.get(members[0]) if input_schema else None
            if col_schema is None or col_schema.dtype is None:
                return None
            if np.dtype(md.to_numpy(col_schema.dtype)).kind not in ("i", "u"):
                return None
            cols.append(members[0])
        return cols or None

    def fit_mesh(self, buffers: Dict[str, List], mesh, axis: str = "data"):
        """Each column's keys counted over the mesh's ``axis``
        (categorify.py:775-839): one exchange (K15a's route, one
        all_to_all, K15a's sort) a column, the host run-length-encoding the
        keys this rank owns. A column with keys outside int32 or equal to
        the exchange's pad on any rank takes the host counter instead.
        ``buffers``: {column: [(values, validity or None), ...]}, gathered by
        the FitEngine's scan. Returns the usual fit state: each rank holds
        the counts of the keys it owns, which ``fit_reduce_multihost``
        merges."""
        from ..kernels.exchange import PAD
        from ..parallel.mesh import all_reduce, comm_device
        from ..parallel.sharded_vocab import owned_value_counts

        group = mesh.get_group(axis)
        state: Dict[str, _VocabAccum] = {}
        for name, parts in buffers.items():
            accum = _VocabAccum()
            chunks = []
            for vals, validity in parts:
                accum.dtype = vals.dtype if accum.dtype is None else torch.promote_types(accum.dtype, vals.dtype)
                chunks.append(vals if validity is None else vals[validity])
            keys = torch.cat(chunks) if chunks else torch.empty(0, dtype=torch.int32)
            in_range = keys.numel() == 0 or (int(keys.min()) >= -(2**31) and int(keys.max()) < PAD)
            flag = torch.tensor([int(in_range)], dtype=torch.int32, device=comm_device(group))
            if not int(all_reduce(flag, group, torch.distributed.ReduceOp.MIN).item()):
                for vals, validity in parts:  # the same exact counts, on the host counter
                    accum.update(vals, validity)
                state[name] = accum
                continue
            values, counts = owned_value_counts(keys.to(torch.int32), mesh, axis)
            dtype = accum.dtype or torch.int64
            state[name] = _VocabAccum.from_counts(values, counts, dtype, keys.device)
        return state

    def fit_merge(self, states):
        out = states[0]
        for s in states[1:]:
            for key in out:
                out[key].merge(s[key])
        return out

    def fit_reduce_multihost(self, state):
        """The rank's accumulators reduced with every other rank's
        (categorify.py:884-1060). Integer vocabularies with at least
        ``NVT_VOCAB_EXCHANGE_MIN`` unique keys on some rank exchange their
        (key, count) pairs through one all_to_all, each pair sent to its
        key's owner once (``exchange_partial_counts``), and every rank
        gathers the owners' disjoint merged shards; the rest take the
        allgather of whole accumulators. The route is decided from
        allgathered metadata, so every rank issues the same collectives."""
        from ..parallel.multihost import allgather_pyobj
        from ..parallel.sharded_vocab import exchange_partial_counts

        threshold = int(os.environ.get("NVT_VOCAB_EXCHANGE_MIN", 65536))
        local_meta = {}
        for key in sorted(state):
            accum = state[key]
            if isinstance(accum, _VocabAccum) and accum.dtype is None:
                local_meta[key] = ("empty", 0, None)
            elif isinstance(accum, _VocabAccum) and not accum.dtype.is_floating_point:
                if len(accum.partials) > 1:
                    accum._merge()
                local_meta[key] = ("int", accum.rows, accum.dtype)
            else:
                local_meta[key] = ("other", accum.rows, None)
        all_meta = allgather_pyobj(local_meta)
        exchange, gather = [], []
        for key in sorted(state):
            flavors = {m[key][0] for m in all_meta}
            large = max(m[key][1] for m in all_meta) >= threshold
            (exchange if "int" in flavors and flavors <= {"int", "empty"} and large else gather).append(key)
        out = {}
        for key in exchange:
            owned = exchange_partial_counts(*state[key].counts())
            shards = allgather_pyobj(owned)
            dtypes = [m[key][2] for m in all_meta if m[key][2] is not None]
            dtype = dtypes[0]
            for d in dtypes[1:]:
                dtype = torch.promote_types(dtype, d)
            out[key] = _VocabAccum.from_counts(
                np.concatenate([s[0] for s in shards]), np.concatenate([s[1] for s in shards]), dtype, "cpu"
            )
        if gather:
            out.update(self.fit_merge(allgather_pyobj({key: state[key] for key in gather})))
        self.last_fit_reduce = {"exchange": exchange, "gather": gather}
        return out

    def fit_finalize(self, state):
        for key, accum in state.items():
            values, counts = accum.finalize()
            ft = _per_column(self.freq_threshold, key, 0)
            nb = _per_column(self.num_buckets, key, 1) or 1
            mx = _per_column(self.max_size, key, 0)
            if ft > 0:
                keep = counts >= ft
                values, counts = values[keep], counts[keep]
            if mx and mx > 0:
                budget = max(0, mx - (OOV_OFFSET + nb))
                values, counts = values[:budget], counts[:budget]
            self.vocabs[key] = _Vocab(values, counts, nb)
        self.set_offsets()
        self._write_vocab_artifacts()
        self._get_batched()  # build the host tables now
        limit = self._memory_limit_bytes()
        if limit is not None:
            total = sum(v.host_nbytes() for v in self.vocabs.values())
            if total > limit:
                LOG.warning("categorify vocabularies use %d bytes (> %d budget); tables will spill to parquet "
                            "under LRU", total, limit)
        self._release_disk_tier()
        self._enforce_memory_limit()

    def set_offsets(self):
        """single_table: one contiguous index space (categorify.py:1104-1109)."""
        if self.single_table:
            offset = 0
            for key in sorted(self.vocabs):
                self.vocabs[key].offset = offset
                offset += self.vocabs[key].size

    def clear(self):
        super().clear()
        self.vocabs = {}
        self.categories = {}
        self._batched_cache = None
        self._lru = {}
        self._lru_tick = 0
        self.cache_stats = {"hits": 0, "reloads": 0, "releases": 0}

    def _load_supplied_vocabs(self, vocabs: Dict[str, Any]):
        """Vocabularies given at construction (categorify.py:1735-1757): an
        array, a list, a Column or a parquet path (its first column), each
        in code order. The op is fitted with ``fit_generation`` 0, so
        ``Workflow.fit`` keeps it, and its artifacts are written now."""
        from ..io.native_parquet import read_row_groups

        for key, vocab in vocabs.items():
            if isinstance(vocab, str):
                values = next(iter(read_row_groups(vocab).values()))
            elif isinstance(vocab, Column):
                values = vocab.values.cpu().numpy()
            else:
                values = np.asarray(vocab)
            nb = _per_column(self.num_buckets, key, 1) or 1
            self.vocabs[key] = _Vocab(values, np.zeros(len(values), dtype=np.int64), nb)
        self.fitted = len(self.vocabs) > 0
        self._write_vocab_artifacts()

    def _write_vocab_artifacts(self):
        """Each vocabulary as ``<out_path>/categories/unique.<key>.parquet``:
        its values in code order and their counts as ``<key>_size``
        (categorify.py:1124-1170), through the port's writer, several files
        at once. A combo group's tuples are strings in the reference's
        artifact, which the port's writer does not write (item 16): combo
        vocabularies get none and stay resident."""
        from concurrent.futures import ThreadPoolExecutor

        from ..io.native_parquet import NativeParquetFile
        from ..io.writer import _plan, resolve_compression

        out_dir = os.path.join(self.out_path, "categories")
        os.makedirs(out_dir, exist_ok=True)
        plan = _plan(resolve_compression(None))

        def write_one(item):
            key, vocab = item
            path = os.path.join(out_dir, f"unique.{_safe_name(key)}.parquet")
            values = vocab.values_by_code.astype(_artifact_dtype(vocab.dtype), copy=False)
            counts = np.asarray(vocab.counts, dtype=np.int64)
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            f = NativeParquetFile(tmp, [(key, values.dtype), (f"{key}_size", counts.dtype)], plan=plan)
            f.write_row_group([[values], [counts]], None, len(values))
            f.close()
            os.replace(tmp, path)  # a reader never sees a half-written artifact
            return key, path

        items = [(k, v) for k, v in self.vocabs.items() if not v.is_combo]
        if len(items) >= 4:
            with ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as pool:
                results = list(pool.map(write_one, items))
        else:
            results = [write_one(it) for it in items]
        for key, path in results:
            self.categories[key] = path
            self.vocabs[key].artifact_path = path

    # --- the vocabulary memory hierarchy (categorify.py:1201-1259) --------------------
    def _tier(self, key: str) -> str:
        tier = _per_column(self.cat_cache, key, "host")
        return tier if tier in ("device", "host", "disk") else "host"

    def _memory_limit_bytes(self) -> Optional[int]:
        limit = self.cardinality_memory_limit
        if limit is None:
            return None
        if isinstance(limit, str):
            from ..io.dataset import parse_bytes

            return parse_bytes(limit)
        return int(limit)

    def _resident_vocab(self, key: str) -> _Vocab:
        """A vocabulary for use now: reloaded from its artifact if released,
        touched in the LRU, and the least recently used others released
        past the budget."""
        vocab = self.vocabs[key]
        if vocab.ensure_resident():
            self.cache_stats["reloads"] += 1
            LOG.info("categorify vocab %r reloaded from %s", key, vocab.artifact_path)
        else:
            self.cache_stats["hits"] += 1
        self._lru_tick += 1
        self._lru[key] = self._lru_tick
        self._enforce_memory_limit(protect=key)
        return vocab

    def _enforce_memory_limit(self, protect: Optional[str] = None):
        limit = self._memory_limit_bytes()
        if limit is None:
            return
        resident = [
            (self._lru.get(k, 0), k, v)
            for k, v in self.vocabs.items()
            if v.resident and v.artifact_path is not None and k != protect
        ]
        total = sum(v.host_nbytes() for _, _, v in resident)
        if protect is not None and protect in self.vocabs:
            total += self.vocabs[protect].host_nbytes()
        for _, k, v in sorted(resident, key=lambda r: (r[0], r[1])):  # oldest LRU tick first
            if total <= limit:
                break
            freed = v.release_host()
            if freed:
                total -= freed
                self.cache_stats["releases"] += 1
                LOG.info("categorify vocab %r released (%d bytes)", k, freed)

    def _release_disk_tier(self):
        """Disk-tier vocabularies do not stay resident between transforms."""
        for key, vocab in self.vocabs.items():
            if self._tier(key) == "disk" and vocab.release_host():
                self.cache_stats["releases"] += 1

    # --- device tables ---------------------------------------------------------
    def _solo_keys(self) -> set:
        """Vocabulary keys that encode alone (K8's solo-table branch): the
        disk tier, and every vocabulary under a memory budget (the batched
        tables would duplicate every table, categorify.py:1484-1499)."""
        if self._memory_limit_bytes() is not None:
            return set(self.vocabs)
        return {k for k in self.vocabs if self._tier(k) == "disk"}

    def _get_batched(self):
        """{kind: (Batched* table on the host, {vocab key: row})}, one table per
        kind over every vocabulary that does not encode solo, built once per
        fitted state. The stash kind holds only vocabularies given a
        ``StashLookup``: ``build_lookup`` never returns one, as in the
        reference (categorify.py:1494-1527). An empty vocabulary is a row
        of the tiny table and of the sorted one: every value misses, and the
        column's dtype picks the launch."""
        token = tuple(sorted((k, id(v)) for k, v in self.vocabs.items()))
        if self._batched_cache is not None and self._batched_cache[0] == token:
            return self._batched_cache[1]
        solo = self._solo_keys()
        by_kind: Dict[str, List] = {"tiny": [], "direct": [], "stash": [], "cuckoo": [], "sorted": []}
        empty = []
        for vkey in sorted(self.vocabs):
            if self.vocabs[vkey].is_combo or vkey in solo:
                continue
            vocab = self._resident_vocab(vkey)
            if vocab.size == vocab.start_index:
                empty.append(vkey)
                continue
            lut = vocab.lookup_struct()
            by_kind[kind_of(lut)].append((vkey, lut))
        if len(by_kind["tiny"]) == 1 and len(by_kind["tiny"][0][1].keys) > _LONE_TINY_MAX:
            # a lone large compare column has no batch to share a launch
            # with: it takes the cuckoo table (categorify.py:1513-1522)
            vkey, lut = by_kind["tiny"].pop()
            by_kind["cuckoo"].append((vkey, build_cuckoo(lut.keys, lut.codes)))
        for vkey in empty:
            by_kind["tiny"].append((vkey, build_lookup(np.zeros(0, np.int32), np.zeros(0, np.int32))))
            by_kind["sorted"].append((vkey, build_lookup(np.zeros(0, np.float32), np.zeros(0, np.int32))))
        out = {}
        for kind, entries in by_kind.items():
            if entries:
                out[kind] = (
                    BATCHED[kind]([lut for _, lut in entries]),
                    {vkey: i for i, (vkey, _) in enumerate(entries)},
                )
        self._batched_cache = (token, out)
        return out

    def device_state(self, device):
        """The batched tables and the combo indexes on ``device``. A
        vocabulary that encodes solo keeps its own table while it is
        resident (``_Vocab.solo_table``); like the reference's
        ``device_state`` (categorify.py:1261-1299), the non-disk ones are
        made resident and their tables built here."""
        solo = self._solo_keys()
        for vkey in self.vocabs:
            if vkey in solo and self._tier(vkey) != "disk":
                self._resident_vocab(vkey).lookup_struct()
        combo = {}
        for key, vocab in self.vocabs.items():
            if vocab.is_combo:
                vocab.ensure_resident()
                combo[key] = PairIndex(vocab.lookup_struct(), device, vocab.size - vocab.start_index)
        return {
            "tables": {
                kind: (blut.to(device), row_index)
                for kind, (blut, row_index) in self._get_batched().items()
            },
            "args": {},  # (kind, names) → (sel, col_offsets, nbuckets) on the device
            "combo": combo,
        }

    def encode_combo(self, key: str, cols: List[Column], state) -> torch.Tensor:
        """int32 codes of a combo group's crossed column (the reference's
        ``_encode_combo_device``, categorify.py:1381-1410): a verified hit →
        its code from ``start_index``, a miss → the OOV code, a row with a
        null member → the null code, each shifted by the vocabulary's
        single_table offset."""
        vocab = self.vocabs[key]
        off = vocab.offset
        return state["combo"][key](cols, vocab.start_index + off, OOV_OFFSET + off, NULL_INDEX + off)

    def encode_solo(self, vkey: str, col: Column) -> torch.Tensor:
        """int32 codes of one column through its vocabulary's own table (K8's
        solo-table branch, categorify.py:552-585): one launch of K1, K2 or
        K3 (or K8's sorted search for float keys) with one table row and the
        null, OOV and offset epilogue fused. A list column's flat values
        take no validity."""
        vocab = self._resident_vocab(vkey)
        values = int32_keys(col)
        kind, table = vocab.solo_table(values.device, values.is_floating_point())
        if (kind == "sorted") != values.is_floating_point():
            what = "a float column against an integer vocabulary" if values.is_floating_point() else \
                "an integer column against a float vocabulary"
            raise NotImplementedError(UNSUPPORTED_MIXED.format(what))
        dev = values.device
        validity = None if col.is_list or col.validity is None else col.validity[None]
        nbuckets = None if vocab.num_buckets == 1 else torch.tensor([vocab.num_buckets], dtype=torch.int32,
                                                                     device=dev)
        return table.encode(
            values[None], validity, torch.zeros(1, dtype=torch.int32, device=dev),
            torch.tensor([vocab.offset], dtype=torch.int32, device=dev), nbuckets=nbuckets,
            counter=SOLO_COUNTERS.get(kind),
        )[0]

    # --- transform ---------------------------------------------------------------
    def transform(self, col_selector: ColumnSelector, batch: TableBatch, state=None) -> TableBatch:
        if state is None:
            state = self.device_state(batch.device)
        codes = {}
        for job in self.lookup_jobs(col_selector, batch, state):
            for name in job["names"]:
                self._resident_vocab(job["vkeys"][name])  # touched in the LRU, as the reference does
            out = job["table"].encode(
                job["values"], job["validity"], job["sel"], job["col_offsets"], nbuckets=job["nbuckets"]
            )
            for i, name in enumerate(job["names"]):
                codes[name] = out[i]
        solo = self._solo_keys()
        result = TableBatch()
        for name, members, vkey in self._columns(col_selector):
            if self._is_combo(members):
                result[name] = Column(self.encode_combo(name, [batch[m] for m in members], state))
                continue
            if vkey in solo:
                codes[name] = self.encode_solo(vkey, batch[name])
            result[name] = Column(codes[name], batch[name].offsets)  # a list keeps its offsets
        self._release_disk_tier()
        if self.dtype is not None:
            out_dtype = to_torch_dtype(self.dtype)
            for name in result.column_names:
                col = result[name]
                result[name] = Column(col.values.to(out_dtype), col.offsets)
        return result

    def _columns(self, col_selector: ColumnSelector):
        """(output column, group members, vocab key) in output order; a combo
        group is one output column."""
        for key, members in self._groups(col_selector):
            if self._is_combo(members):
                yield key, members, key
            else:
                for m in members:
                    yield m, members, key if len(members) > 1 else m

    def lookup_jobs(self, col_selector: ColumnSelector, batch: TableBatch, state):
        """One dict per kernel launch: per table kind present, one for its
        scalar columns and one for each of its list columns (whose flat
        values have a length of their own). Integer columns take the tiny,
        direct, stash and cuckoo tables, float columns the sorted one. Each holds
        the kind's ``table`` and the stacked ``values`` [C, N] (int32, or
        float32 for the sorted table), ``validity`` (or None: a list's flat
        values carry none), ``sel``, ``col_offsets`` and ``nbuckets`` (None
        when every column has one OOV bucket) of its C columns, named in
        ``names``."""
        solo = self._solo_keys()
        jobs = [(name, vkey) for name, members, vkey in self._columns(col_selector)
                if not self._is_combo(members) and vkey not in solo]
        tables = state["tables"]
        for name, vkey in jobs:
            is_float = batch[name].values.is_floating_point()
            if not any(vkey in rows for kind, (_, rows) in tables.items() if (kind == "sorted") == is_float):
                what = "a float column against an integer vocabulary" if is_float else \
                    "an integer column against a float vocabulary"
                raise NotImplementedError(UNSUPPORTED_MIXED.format(what))
        for kind, (blut, row_index) in tables.items():
            items = [
                (name, vkey) for name, vkey in jobs
                if vkey in row_index and batch[name].values.is_floating_point() == (kind == "sorted")
            ]
            scalars = [item for item in items if not batch[item[0]].is_list]
            launches = ([scalars] if scalars else []) + [[item] for item in items if batch[item[0]].is_list]
            for group in launches:
                cols = [batch[name] for name, _ in group]
                values = torch.stack([int32_keys(c) for c in cols])
                validity = None
                if not cols[0].is_list and any(c.validity is not None for c in cols):
                    validity = torch.stack(
                        [c.validity if c.validity is not None else torch.ones_like(c.values, dtype=torch.bool)
                         for c in cols]
                    )
                sel, col_offsets, nbuckets = self._launch_args(state, kind, group, row_index, values.device)
                yield {
                    "kind": kind,
                    "table": blut,
                    "values": values,
                    "validity": validity,
                    "sel": sel,
                    "col_offsets": col_offsets,
                    "nbuckets": nbuckets,
                    "names": [name for name, _ in group],
                    "vkeys": dict(group),
                }

    def _launch_args(self, state, kind, items, row_index, device):
        key = (kind, tuple(items))
        args = state["args"].get(key)
        if args is None:
            vocabs = [self.vocabs[vkey] for _, vkey in items]
            args = (
                torch.tensor([row_index[vkey] for _, vkey in items], dtype=torch.int32, device=device),
                torch.tensor([v.offset for v in vocabs], dtype=torch.int32, device=device),
                None if all(v.num_buckets == 1 for v in vocabs)
                else torch.tensor([v.num_buckets for v in vocabs], dtype=torch.int32, device=device),
            )
            state["args"][key] = args
        return args

    # --- schema ------------------------------------------------------------------
    @property
    def output_dtype(self):
        return md.normalize(self.dtype) if self.dtype is not None else md.int32

    @property
    def output_tags(self):
        return [Tags.CATEGORICAL]

    def _compute_properties(self, col_schema, input_schema):
        vocab = self.vocabs.get(col_schema.name)
        if vocab is None:
            return col_schema.with_properties({})
        card, dim = _emb_sz_rule(vocab.size)
        key = col_schema.name
        return col_schema.with_properties(
            {
                "num_buckets": vocab.num_buckets if vocab.num_buckets > 1 else None,
                "freq_threshold": _per_column(self.freq_threshold, key, 0),
                "max_size": _per_column(self.max_size, key, 0),
                "domain": {"min": 0, "max": vocab.size - 1 + vocab.offset, "name": key},
                "embedding_sizes": {"cardinality": card, "dimension": dim},
            }
        )



def get_embedding_sizes(source):
    """(cardinality, dimension) of each Categorify output column of a fitted
    Workflow (or node), from its output schema (categorify.py:1847-1873):
    ``{col: (card, dim)}``, or the pair ``(single, multihot)`` when a list
    column is present."""
    single: Dict[str, Tuple[int, int]] = {}
    multihot: Dict[str, Tuple[int, int]] = {}
    for cs in getattr(source, "output_schema", None) or []:
        emb = cs.properties.get("embedding_sizes")
        if emb:
            (multihot if cs.is_list else single)[cs.name] = (emb["cardinality"], emb["dimension"])
    return (single, multihot) if multihot else single
