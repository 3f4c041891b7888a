"""Row permutation of a chunk: CUDA kernel K14, its wrapper and plain version.

``permute_rows(arrays, perm)`` gathers the rows of every array of a dict by
one permutation in one launch: the counterpart of the one jitted program of
``nvtabular_tpu/loader/device_loader.py:21-31``. The kernel is
``csrc/permute.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

MAX_ARRAYS = 64  # csrc/permute.cu kMaxArrays

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]


def permute_rows(arrays: Dict[str, torch.Tensor], perm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{k: v[perm]}`` for arrays of ``n`` rows and a permutation of
    ``range(n)`` (int64 or int32), all on one device. On CUDA every row must
    be a multiple of 4 bytes wide."""
    if perm.dim() != 1 or perm.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"perm must be a 1-d int64 or int32 tensor, got {perm.dtype} {tuple(perm.shape)}")
    dev, n = perm.device, perm.shape[0]
    check(perm, "perm", perm.dtype, dev)
    for name, v in arrays.items():
        check(v, name, v.dtype, dev)
        if v.dim() == 0 or v.shape[0] != n:
            raise ValueError(f"{name}: expected {n} rows, got shape {tuple(v.shape)}")
    if not use_kernel(perm):
        return permute_rows_plain(arrays, perm)
    if len(arrays) > MAX_ARRAYS:
        raise ValueError(f"permute_rows takes at most {MAX_ARRAYS} arrays, got {len(arrays)}")
    out = {name: torch.empty_like(v) for name, v in arrays.items()}
    row_bytes = [v[0].numel() * v.element_size() if n else 0 for v in arrays.values()]
    bad = [name for name, w in zip(arrays, row_bytes) if n and w % 4]
    if bad:
        raise ValueError(f"permute_rows: rows of {bad} are not a multiple of 4 bytes wide")
    if n == 0 or not arrays:
        return out
    if n * max(row_bytes) // 4 >= 2**31:
        raise ValueError(f"permute_rows: {n} rows of up to {max(row_bytes)} bytes exceed the kernel's int32 index")
    k = len(arrays)
    src = (ctypes.c_void_p * k)(*[v.data_ptr() for v in arrays.values()])
    dst = (ctypes.c_void_p * k)(*[v.data_ptr() for v in out.values()])
    widths = (ctypes.c_int * k)(*row_bytes)
    fn = library("permute").nvt_permute_rows
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(src, dst, widths, k, ptr(perm), int(perm.dtype == torch.int64), n, stream_ptr(dev))
    raise_on_error(rc, "permute_rows")
    LAUNCHES["permute_rows"] += 1
    return out


def permute_rows_plain(arrays: Dict[str, torch.Tensor], perm: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {name: v[perm] for name, v in arrays.items()}
