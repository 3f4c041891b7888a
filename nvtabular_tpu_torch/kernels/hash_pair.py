"""Verified hash pairs: CUDA kernels K10b and K9, their wrappers and plain
PyTorch versions.

A group of several key columns (TargetEncoding and JoinGroupby's multi-key
groups, K10b) or the crossed column of ``Categorify(encode_type="combo")``
(K9) maps a row's key tuple to a fitted row in three launches:

* ``hash_pair(columns)`` — both hashes of each row's tuple, h1 and h2
  (``hash_multi_key`` with seeds 0xA1 and 0xB7), as int32 bits;
* the K1/K3 probe of h1 (``kernels.lookup``) with the miss code as an
  argument;
* ``hash_pair_verify(idx, h2, h2_by_group, validity, ...)`` — a hit stands
  only if the row's h2 equals the fitted tuple's; then the code epilogue
  (hit offset, out-of-vocabulary code, null code for a row with any null
  member).

``hash_lanes`` is ``dispatch.hash_lanes`` for CUDA tensors. The kernels are
``csrc/hash_pair.cu``; the hash itself is ``csrc/hash.cuh``'s, as K7's.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library
from .hash import _KINDS, M32, hash_array_plain, hash_lanes_plain, hashable

H1_SEED, H2_SEED = 0xA1, 0xB7  # nvtabular_tpu/ops/groupby_stats.py:572, 575

_P = ctypes.c_void_p
_ARGTYPES = {
    # ptrs, kinds, num_cols, n, seed1, seed2, h1, h2, launches, stream
    "nvt_hash_pair": [_P, _P, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, _P, _P,
                      ctypes.POINTER(ctypes.c_int), _P],
    # idx, h2, h2_by_group, masks, num_masks, n, miss, hit_offset, oov, null, out, launches, stream
    "nvt_hash_pair_verify": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int64] + [ctypes.c_int32] * 4 + [
        _P, ctypes.POINTER(ctypes.c_int), _P],
    # lo, hi, n, seed, out, stream
    "nvt_hash_lanes": [_P, _P, ctypes.c_int64, ctypes.c_uint32, _P, _P],
}


def _fn(name: str):
    fn = getattr(library("hash_pair"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def int32_bits(h: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 → the same 32 bits as int32 (the
    reference's ``astype(np.int64).astype(np.int32)`` wrap)."""
    return (h - ((h >> 31) << 32)).to(torch.int32)


# --- plain versions ---------------------------------------------------------------
def hash_multi_key_plain(columns: Sequence[torch.Tensor], seed: int) -> torch.Tensor:
    """``nvtabular_tpu/ops/groupby_stats.py:53-62`` over int64-held uint32."""
    h = hash_array_plain(columns[0], seed)
    for i, col in enumerate(columns[1:], start=1):
        h = hash_lanes_plain(h, hash_array_plain(col, seed + 31 * i), seed + 17)
    return h


def hash_pair_plain(columns: Sequence[torch.Tensor]):
    return tuple(int32_bits(hash_multi_key_plain(columns, s)) for s in (H1_SEED, H2_SEED))


def hash_pair_verify_plain(idx, h2, h2_by_group, validity, miss, hit_offset, oov, null):
    hit = (idx != miss) & (h2_by_group[idx.long().clamp(max=h2_by_group.shape[0] - 1)] == h2)
    out = torch.where(hit, idx + hit_offset, oov)
    for v in validity or ():
        out = torch.where(v, out, null)
    return out.to(torch.int32)


# --- wrappers ------------------------------------------------------------------------
def hash_pair(columns: Sequence[torch.Tensor]):
    """Replaces ``hash_multi_key(keys, 0xA1)`` and ``(keys, 0xB7)`` of the
    reference's multi-key device lookups (groupby_stats.py:619, 622;
    categorify.py:1397, 1400). ``columns``: 1-d tensors of n rows (int32,
    int64; narrower ints widen) in the group's key order. Returns (h1, h2),
    int32 [n] each, the uint32 hashes' bits."""
    if not columns:
        raise ValueError("hash_pair needs at least one column")
    cols: List[torch.Tensor] = [hashable(c) for c in columns]
    dev, n = cols[0].device, cols[0].shape[0]
    for i, c in enumerate(cols):
        check(c, f"column {i}", c.dtype, dev, (n,))
    if not use_kernel(cols[0]):
        return hash_pair_plain(cols)
    h1 = torch.empty(n, dtype=torch.int32, device=dev)
    h2 = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        k = len(cols)
        ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
        kinds = (ctypes.c_int * k)(*[_KINDS[c.dtype] for c in cols])
        launched = ctypes.c_int(0)
        rc = _fn("nvt_hash_pair")(ptrs, kinds, k, n, H1_SEED, H2_SEED, ptr(h1), ptr(h2), ctypes.byref(launched),
                                  stream_ptr(dev))
        raise_on_error(rc, "hash_pair")
        LAUNCHES["hash_pair"] += launched.value
    return h1, h2


def hash_pair_verify(idx: torch.Tensor, h2: torch.Tensor, h2_by_group: torch.Tensor,
                     validity: Optional[Sequence[torch.Tensor]], miss: int, hit_offset: int, oov: int,
                     null: int) -> torch.Tensor:
    """Replaces the h2 check and epilogue of ``device_group_index``
    (groupby_stats.py:620-627; K10b: hit → idx, else ``num_groups``) and of
    ``_encode_combo_device`` (categorify.py:1398-1409; K9: hit → idx +
    start_index + offset, else OOV + offset, a null member → NULL + offset).

    idx int32 [n]: the probe's fitted row, or ``miss``; h2 int32 [n];
    h2_by_group int32 [miss + 1] (the fitted tuples' h2, then a pad);
    validity: bool [n] masks of the members that have one."""
    dev, n = idx.device, idx.shape[0]
    check(idx, "idx", torch.int32, dev, (n,))
    check(h2, "h2", torch.int32, dev, (n,))
    check(h2_by_group, "h2_by_group", torch.int32, dev, (miss + 1,))
    masks = list(validity or ())
    for i, v in enumerate(masks):
        check(v, f"validity {i}", torch.bool, dev, (n,))
    if not use_kernel(idx):
        return hash_pair_verify_plain(idx, h2, h2_by_group, masks, miss, hit_offset, oov, null)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        k = len(masks)
        mptrs = (ctypes.c_void_p * max(k, 1))(*[m.data_ptr() for m in masks])
        launched = ctypes.c_int(0)
        rc = _fn("nvt_hash_pair_verify")(
            ptr(idx), ptr(h2), ptr(h2_by_group), mptrs, k, n, miss, hit_offset, oov, null, ptr(out),
            ctypes.byref(launched), stream_ptr(dev),
        )
        raise_on_error(rc, "hash_pair_verify")
        LAUNCHES["hash_pair_verify"] += launched.value
    return out


def hash_lanes(lo: torch.Tensor, hi: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``nvtabular_tpu/dispatch.py:41-48``: two uint32 lanes (held in int64,
    each in [0, 2**32)) to a uint32 held in int64."""
    dev, n = lo.device, lo.shape[0]
    check(lo, "lo", torch.int64, dev, (n,))
    check(hi, "hi", torch.int64, dev, (n,))
    if not use_kernel(lo):
        return hash_lanes_plain(lo, hi, seed)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        rc = _fn("nvt_hash_lanes")(ptr(lo), ptr(hi), n, seed & M32, ptr(out), stream_ptr(dev))
        raise_on_error(rc, "hash_lanes")
        LAUNCHES["hash_lanes"] += 1
    return out
