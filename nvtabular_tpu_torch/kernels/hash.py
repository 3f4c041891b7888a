"""Murmur3 hashes: CUDA kernel K7, its wrappers and plain PyTorch versions.

The port's one fmix32: ``fmix32_plain`` here and ``nvt::fmix32`` in
``csrc/hash.cuh``, which every CUDA source that hashes includes. Two
entry points launch ``csrc/hash.cu``:

* ``hashed_cross(columns, num_buckets, seed)`` — HashedCross's
  ``h = h * 31 ^ hash(col)`` over the columns, then ``% num_buckets``, in
  one launch (``num_buckets=None``: the uint32 hash itself);
* ``fold_ids(row_offset, n, kfold, seed)`` — TargetEncoding's fold of each
  global row, ``hash_lanes(lo, hi, seed) % kfold``.

PyTorch on the CPU has no uint32 ``*``, ``>>`` or ``%``, and int32 ``>>`` is
arithmetic, so the plain versions hold uint32 values in int64 lanes masked
to 32 bits. A value's lanes: int32 → (bits, sign extension); int64 → (low
word, high word), which equals the int32 lanes for values inside int32;
float → the bits of its float32 value and 0, as on the reference's device
path (``nvtabular_tpu/dispatch.py:51-85``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

M32 = 0xFFFFFFFF
C1, C2 = 0xCC9E2D51, 0x1B873593
MAX_COLUMNS = 16  # csrc/hash.cu kMaxCols
_KINDS = {torch.int32: 0, torch.int64: 1, torch.float32: 2}

_P = ctypes.c_void_p
_ARGTYPES = {
    # ptrs, kinds, num_cols, n, seed, num_buckets, out, stream
    "nvt_hash_columns": [_P, _P, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, _P, _P],
    # row_offset, n, seed, kfold, out, stream
    "nvt_fold_ids": [ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32, _P, _P],
}


def _fn(name: str):
    fn = getattr(library("hash"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


# --- plain versions: uint32 in int64 lanes -------------------------------------
def _mul32(h, c: int):
    """(h * c) mod 2**32 for h in [0, 2**32) held in int64, without int64
    overflow."""
    return ((h & 0xFFFF) * c + (((h >> 16) * c) & 0xFFFF) * 65536) & M32


def fmix32_plain(h):
    """Murmur3 finalizer over uint32 values held in int64 lanes."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_lanes_plain(lo, hi, seed: int = 0):
    """``nvtabular_tpu/dispatch.py:41-48`` over int64-held uint32 lanes."""
    h = fmix32_plain((_mul32(lo, C1) + seed) & M32)
    return fmix32_plain(h ^ _mul32(hi, C2))


def hashable(values: torch.Tensor) -> torch.Tensor:
    """``values`` as one of the kernel's three kinds (int32, int64, float32):
    narrower ints and bools widen to int32, other floats narrow to float32
    (the reference's device path hashes float32 bits)."""
    if values.dtype in _KINDS:
        return values
    if values.is_floating_point():
        return values.to(torch.float32)
    if values.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8):
        return values.to(torch.int32)
    raise NotImplementedError(f"hashing {values.dtype} columns is not ported")


def lanes_plain(values: torch.Tensor):
    """(lo, hi) uint32 lanes of each value, held in int64."""
    values = hashable(values)
    if values.dtype == torch.float32:
        return values.view(torch.int32).long() & M32, torch.zeros_like(values, dtype=torch.int64)
    v = values.long()
    return v & M32, (v >> 32) & M32


def hash_array_plain(values: torch.Tensor, seed: int = 0) -> torch.Tensor:
    return hash_lanes_plain(*lanes_plain(values), seed)


def hashed_cross_plain(columns: Sequence[torch.Tensor], num_buckets: Optional[int], seed: int = 0):
    h = hash_array_plain(columns[0], seed)
    for col in columns[1:]:
        h = _mul32(h, 31) ^ hash_array_plain(col, seed)
    return h if num_buckets is None else (h % num_buckets).to(torch.int32)


def fold_ids_plain(row_offset: int, n: int, kfold: int, seed: int, device="cpu") -> torch.Tensor:
    idx = torch.arange(row_offset, row_offset + n, dtype=torch.int64, device=device)
    return (hash_lanes_plain(idx & M32, idx >> 32, seed) % kfold).to(torch.int32)


# --- wrappers ---------------------------------------------------------------------
def hashed_cross(columns: Sequence[torch.Tensor], num_buckets: Optional[int], seed: int = 0) -> torch.Tensor:
    """Replaces ``HashedCross.transform`` (nvtabular_tpu/ops/hashed_cross.py:38-52)
    over the device branch of ``hash_array`` (dispatch.py:51-85).

    ``columns``: 1-d tensors of n rows in the order they combine. Returns
    int32 codes ``h % num_buckets``, or with ``num_buckets=None`` the uint32
    hashes held in int64."""
    if not columns:
        raise ValueError("hashed_cross needs at least one column")
    cols: List[torch.Tensor] = [hashable(c) for c in columns]
    dev, n = cols[0].device, cols[0].shape[0]
    for i, c in enumerate(cols):
        check(c, f"column {i}", c.dtype, dev, (n,))
    if num_buckets is not None and not 0 < num_buckets <= M32:
        raise ValueError(f"num_buckets must be in [1, 2**32), got {num_buckets}")
    if not use_kernel(cols[0]):
        return hashed_cross_plain(cols, num_buckets, seed)
    if len(cols) > MAX_COLUMNS:
        raise ValueError(f"hashed_cross takes at most {MAX_COLUMNS} columns, got {len(cols)}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        k = len(cols)
        ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in cols])
        kinds = (ctypes.c_int * k)(*[_KINDS[c.dtype] for c in cols])
        rc = _fn("nvt_hash_columns")(ptrs, kinds, k, n, seed & M32, num_buckets or 0, ptr(out), stream_ptr(dev))
        raise_on_error(rc, "hashed_cross")
        LAUNCHES["hashed_cross"] += 1
    return out.long() & M32 if num_buckets is None else out


def fold_ids(row_offset: int, n: int, kfold: int, seed: int, device) -> torch.Tensor:
    """Replaces ``_fold_ids_dev`` (nvtabular_tpu/ops/target_encoding.py:39-50):
    int32 [n], the fold of global rows ``row_offset .. row_offset + n - 1``."""
    device = torch.device(device)
    if kfold < 1 or row_offset < 0:
        raise ValueError(f"need kfold >= 1 and row_offset >= 0, got {kfold}, {row_offset}")
    if device.type == "cpu":
        return fold_ids_plain(row_offset, n, kfold, seed)
    if device.type != "cuda":
        raise NotImplementedError(f"no kernel or plain version for device {device}")
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        rc = _fn("nvt_fold_ids")(row_offset, n, seed & M32, kfold, ptr(out), stream_ptr(device))
        raise_on_error(rc, "fold_ids")
        LAUNCHES["fold_ids"] += 1
    return out
