"""Exact lookups for Categorify: host-built tables, column-batched.

Counterpart of ``nvtabular_tpu/ops/lookup.py``. For integer keys the kind
choice is the reference's (``build_lookup``, lookup.py:711-742):

* ``TinyLookup`` for vocabularies of at most ``tiny_max`` keys (``TINY_MAX``,
  4096, for Categorify; 512 for the group indexes of TargetEncoding and
  JoinGroupby, which the reference probes one column at a time);
* ``DirectLookup`` (a dense int32 map) when the key range is at most
  ``max(DIRECT_MAX_RANGE, 8 * keys)``;
* ``CuckooLookup`` (two-choice, 4-slot buckets ``[k0..k3, v0..v3]``)
  otherwise.

Float keys take a ``SortedLookup``: the keys ascending (sorted in their own
precision, then narrowed to float32) with their codes, searched on the card
(K8), as the reference's ``_Vocab.device_arrays`` (categorify.py:517-537)
and the searchsorted branch of ``encode_device`` (:570-576).

Codes depend only on the vocabulary, so the table layouts are this port's
own: one concatenated table per kind, a flat int32 direct table, no padding
for the TPU's gather pockets. ``Batched*`` stack every column of one kind
into one table, placed on the device once, and encode all of them in one
kernel launch (kernels/lookup.py).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..kernels.lookup import (
    BUCKET_SLOTS,
    NULL_INDEX,
    OOV_INDEX,
    SEEDS,
    TINY_MAX,
    cuckoo_lookup,
    direct_lookup,
    sorted_lookup,
    tiny_lookup,
)
from ..table import Column

DIRECT_MAX_RANGE = 1 << 22
CUCKOO_LOAD = 0.8  # 10 B per key; two-choice 4-slot placement holds to ~0.97
EMPTY = -1  # empty slot marker in a value lane (codes are >= 2)
UNSUPPORTED_WIDE_KEYS = (
    "vocabulary keys outside int32 are not ported yet "
    "(ROADMAP.md queue 1: strings and hybrid execution)"
)
UNSUPPORTED_KEYS = (
    "lookups of string, object or bool keys are not ported yet "
    "(ROADMAP.md queue 1 item 4: strings and hybrid execution)"
)
_MAX_EVICTION_ROUNDS = 4000


def _mix32_np(u: np.ndarray, seed: int) -> np.ndarray:
    """Murmur3 finalizer over uint32 (numpy wraps uint32 arithmetic)."""
    h = u.astype(np.uint32) ^ np.uint32(seed)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def fits_int32(values: np.ndarray) -> bool:
    if len(values) == 0:
        return True
    v = np.asarray(values)
    return int(v.min()) >= np.iinfo(np.int32).min and int(v.max()) <= np.iinfo(np.int32).max


class TinyLookup:
    __slots__ = ("keys", "codes")

    def __init__(self, keys: np.ndarray, codes: np.ndarray):
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order].astype(np.int32)
        self.codes = codes[order].astype(np.int32)


class SortedLookup:
    """Float keys ascending as float32, with their int32 codes. Subnormal
    keys are held as 0.0: the search compares as XLA's flush to zero does."""

    __slots__ = ("keys", "codes")

    def __init__(self, keys: np.ndarray, codes: np.ndarray):
        order = np.argsort(keys, kind="stable")  # in the keys' own precision
        self.keys = keys[order].astype(np.float32)
        self.keys[np.abs(self.keys) < np.finfo(np.float32).tiny] = 0.0
        self.codes = codes[order].astype(np.int32)


class DirectLookup:
    __slots__ = ("min_key", "max_key", "table")

    def __init__(self, min_key: int, max_key: int, table: np.ndarray):
        self.min_key = min_key
        self.max_key = max_key
        self.table = table  # int32, EMPTY = missing


class CuckooLookup:
    __slots__ = ("packed", "nb")

    def __init__(self, packed: np.ndarray, nb: int):
        self.packed = packed  # int32 [nb, 8] = [k0..k3, v0..v3]
        self.nb = nb


def build_direct(values: np.ndarray, codes: np.ndarray, max_range: int = DIRECT_MAX_RANGE):
    """Dense map if the key range is compact enough; else None."""
    v = values.astype(np.int64)
    mn, mx = int(v.min()), int(v.max())
    rng = mx - mn + 1
    if rng > max(max_range, 8 * len(v)):
        return None
    table = np.full(rng, EMPTY, dtype=np.int32)
    table[v - mn] = codes.astype(np.int32)
    return DirectLookup(mn, mx, table)


def build_cuckoo(values: np.ndarray, codes: np.ndarray) -> CuckooLookup:
    """Bucketed cuckoo table at load CUCKOO_LOAD, grown on (rare) failure."""
    keys = np.ascontiguousarray(values.astype(np.int32))
    vals = codes.astype(np.int32)
    nb = max(math.ceil(len(keys) / (BUCKET_SLOTS * CUCKOO_LOAD)), 1)
    for _ in range(6):
        packed = _try_build_cuckoo(keys, vals, nb)
        if packed is not None:
            return CuckooLookup(packed, nb)
        nb = int(nb * 1.3) + 1
    raise RuntimeError("cuckoo build failed after 6 capacity growths")


def _place(items, target, slot_item, fill):
    """Put ``items`` into free slots of their ``target`` buckets, in arrival
    order within each bucket; return the items that did not fit."""
    order = np.argsort(target, kind="stable")
    st = target[order]
    is_start = np.ones(len(st), dtype=bool)
    is_start[1:] = st[1:] != st[:-1]
    run_first = np.nonzero(is_start)[0]
    rank = np.arange(len(st)) - run_first[np.cumsum(is_start) - 1]
    slot = fill[st] + rank
    ok = slot < BUCKET_SLOTS
    slot_item[st[ok] * BUCKET_SLOTS + slot[ok]] = items[order[ok]]
    np.add.at(fill, st[ok], 1)
    return items[order[~ok]]


def _try_build_cuckoo(keys: np.ndarray, vals: np.ndarray, nb: int, seed: int = 0):
    """Vectorized two-choice placement → packed [nb, 8] int32, or None.

    Two greedy passes (first choice, then second) place almost every key.
    The rest go through rounds of parallel eviction: each round, a pending
    key takes a free slot of its current bucket if one is left; otherwise
    one pending key per full bucket evicts a random occupant (seeded, so the
    build is deterministic), which then tries its other bucket; the other
    pending keys of that bucket switch to their other bucket."""
    n = len(keys)
    u = keys.view(np.uint32)
    cand = np.stack([(_mix32_np(u, s) % np.uint32(nb)).astype(np.int64) for s in SEEDS])
    slot_item = np.full(nb * BUCKET_SLOTS, -1, dtype=np.int64)
    fill = np.zeros(nb, dtype=np.int64)
    choice = np.zeros(n, dtype=np.int64)
    pending = np.arange(n, dtype=np.int64)
    for c in (0, 1):
        pending = _place(pending, cand[c, pending], slot_item, fill)
        choice[pending] = 1
    rng = np.random.default_rng(seed)
    for _ in range(_MAX_EVICTION_ROUNDS):
        if len(pending) == 0:
            break
        left = _place(pending, cand[choice[pending], pending], slot_item, fill)
        if len(left) == 0:
            pending = left
            break
        tgt = cand[choice[left], left]
        order = np.argsort(tgt, kind="stable")
        st = tgt[order]
        is_start = np.ones(len(st), dtype=bool)
        is_start[1:] = st[1:] != st[:-1]
        evictors, bucket = left[order[is_start]], st[is_start]
        waiting = left[order[~is_start]]
        choice[waiting] ^= 1
        pos = bucket * BUCKET_SLOTS + rng.integers(0, BUCKET_SLOTS, len(evictors))
        victims = slot_item[pos]
        slot_item[pos] = evictors
        # a victim moves to the bucket it is not in now
        choice[victims] = (cand[0, victims] == bucket).astype(np.int64)
        pending = np.concatenate([victims, waiting])
    if len(pending):
        return None
    slots = slot_item.reshape(nb, BUCKET_SLOTS)
    used = slots >= 0
    idx = np.where(used, slots, 0)
    bkeys = np.where(used, keys[idx], 0).astype(np.int32)
    bvals = np.where(used, vals[idx], EMPTY).astype(np.int32)
    return np.concatenate([bkeys, bvals], axis=1)


def int32_keys(col: Column) -> torch.Tensor:
    """A key column's values (a list column's flat values) as int32 for the
    integer lookup kernels, or float32 for the sorted one (float keys, as the
    reference's device path narrows them); raises on what the port does not
    cover (bools, values outside int32)."""
    v = col.values
    if v.is_floating_point():
        return v.to(torch.float32)
    if v.dtype == torch.bool:
        raise NotImplementedError(UNSUPPORTED_KEYS)
    if v.dtype == torch.int32:
        return v
    if v.dtype == torch.int64 and v.numel():
        lo, hi = torch.aminmax(v)
        if int(lo) < -(2**31) or int(hi) > 2**31 - 1:
            raise NotImplementedError(UNSUPPORTED_WIDE_KEYS)
    return v.to(torch.int32)


def build_lookup(values: np.ndarray, codes: np.ndarray, tiny_max: Optional[int] = None):
    """Tiny, direct or cuckoo table for integer keys, a sorted table for
    float keys (see module docstring); ``tiny_max`` defaults to
    ``TINY_MAX``."""
    if values.dtype.kind == "f":
        return SortedLookup(values, codes)
    if values.dtype.kind not in ("i", "u"):
        raise NotImplementedError(UNSUPPORTED_KEYS)
    if not fits_int32(values):
        raise NotImplementedError(UNSUPPORTED_WIDE_KEYS)
    if len(values) <= (TINY_MAX if tiny_max is None else tiny_max):
        return TinyLookup(values.astype(np.int32), codes.astype(np.int32))
    direct = build_direct(values, codes)
    if direct is not None:
        return direct
    return build_cuckoo(values, codes)


class _Batched:
    """Tensors of one column-batched table; ``to`` places them on a device."""

    _tensors: tuple = ()

    def to(self, device) -> "_Batched":
        out = object.__new__(type(self))
        for name in self._tensors:
            setattr(out, name, getattr(self, name).to(device))
        return out

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, n).numel() * getattr(self, n).element_size() for n in self._tensors)


class BatchedTiny(_Batched):
    """Every tiny vocabulary in one [B, vmax] key/code bin. Row b holds its
    ``lens[b]`` keys sorted, then repeats its first key (codes -1) to vmax —
    the reference's layout (lookup.py:143-155)."""

    _tensors = ("keys", "codes", "lens")

    def __init__(self, luts: List[TinyLookup]):
        vmax = max([1] + [len(l.keys) for l in luts])
        keys = np.zeros((len(luts), vmax), dtype=np.int32)
        codes = np.full((len(luts), vmax), EMPTY, dtype=np.int32)
        for i, l in enumerate(luts):
            v = len(l.keys)
            keys[i, :v] = l.keys
            if v:
                keys[i, v:] = l.keys[0]
            codes[i, :v] = l.codes
        self.keys = torch.from_numpy(keys)
        self.codes = torch.from_numpy(codes)
        self.lens = torch.tensor([len(l.keys) for l in luts], dtype=torch.int32)

    def encode(self, values, validity, sel, col_offsets, miss=OOV_INDEX, null=NULL_INDEX, nbuckets=None):
        return tiny_lookup(values, validity, self.keys, self.codes, self.lens, sel, col_offsets, miss, null, nbuckets)


class BatchedDirect(_Batched):
    """Every direct map concatenated into one flat int32 table."""

    _tensors = ("table", "mins", "maxs", "lens", "offsets")

    def __init__(self, luts: List[DirectLookup]):
        self.table = torch.from_numpy(np.concatenate([l.table for l in luts]))
        self.mins = torch.tensor([l.min_key for l in luts], dtype=torch.int32)
        self.maxs = torch.tensor([l.max_key for l in luts], dtype=torch.int32)
        lens = np.array([len(l.table) for l in luts], dtype=np.int64)
        self.lens = torch.from_numpy(lens)
        self.offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64))

    def encode(self, values, validity, sel, col_offsets, miss=OOV_INDEX, null=NULL_INDEX, nbuckets=None):
        return direct_lookup(
            values, validity, self.table, self.mins, self.maxs, self.lens, self.offsets, sel, col_offsets,
            miss, null, nbuckets,
        )


class BatchedCuckoo(_Batched):
    """Every cuckoo table stacked along rows: one [ΣNB, 8] int32 table."""

    _tensors = ("table", "nbs", "row_offsets")

    def __init__(self, luts: List[CuckooLookup]):
        self.table = torch.from_numpy(np.concatenate([l.packed for l in luts], axis=0))
        nbs = np.array([l.nb for l in luts], dtype=np.int64)
        self.nbs = torch.from_numpy(nbs)
        self.row_offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(nbs)[:-1]]).astype(np.int64))

    def encode(self, values, validity, sel, col_offsets, miss=OOV_INDEX, null=NULL_INDEX, nbuckets=None):
        return cuckoo_lookup(
            values, validity, self.table, self.nbs, self.row_offsets, sel, col_offsets, miss, null, nbuckets
        )


class BatchedSorted(_Batched):
    """Every sorted float vocabulary concatenated: keys [K] float32 and codes
    [K] int32; row b spans ``starts[b] : starts[b] + lens[b]``."""

    _tensors = ("keys", "codes", "starts", "lens")

    def __init__(self, luts: List[SortedLookup]):
        self.keys = torch.from_numpy(np.concatenate([np.zeros(0, np.float32)] + [l.keys for l in luts]))
        self.codes = torch.from_numpy(np.concatenate([np.zeros(0, np.int32)] + [l.codes for l in luts]))
        lens = np.array([len(l.keys) for l in luts], dtype=np.int64)
        self.lens = torch.from_numpy(lens)
        self.starts = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64))

    def encode(self, values, validity, sel, col_offsets, miss=OOV_INDEX, null=NULL_INDEX, nbuckets=None):
        return sorted_lookup(
            values, validity, self.keys, self.codes, self.starts, self.lens, sel, col_offsets, miss, null, nbuckets
        )


BATCHED = {"tiny": BatchedTiny, "direct": BatchedDirect, "cuckoo": BatchedCuckoo, "sorted": BatchedSorted}


def kind_of(lut) -> str:
    if isinstance(lut, TinyLookup):
        return "tiny"
    if isinstance(lut, SortedLookup):
        return "sorted"
    return "direct" if isinstance(lut, DirectLookup) else "cuckoo"
