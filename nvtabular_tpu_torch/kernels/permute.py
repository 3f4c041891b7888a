"""Row permutation of a chunk: CUDA kernel K14, its wrapper and plain version.

``permute_rows(arrays, perm)`` gathers the rows of every array of a dict by
one permutation: the counterpart of the one jitted program of
``nvtabular_tpu/loader/device_loader.py:21-31``, which takes arrays of any
dtype. The kernel is ``csrc/permute.cu``: one launch for up to MAX_ARRAYS
arrays and ``launch_rows`` rows, each array copied in its own element width
(``element_bytes``: 4, 2 or 1 bytes).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

MAX_ARRAYS = 64  # csrc/permute.cu kMaxArrays: the arrays of one launch (more launch in chunks)
MAX_INDEX = 2**31 - 1  # a launch's flat index: its rows times the widest row's elements

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]


def element_bytes(row_bytes: int, *addresses: int) -> int:
    """The element an array's copy moves: the widest of 4, 2 or 1 bytes that
    divides its row width and each of its addresses."""
    for width in (4, 2):
        if row_bytes % width == 0 and all(a % width == 0 for a in addresses):
            return width
    return 1


def launch_rows(n: int, row_elements: Sequence[int]) -> int:
    """The rows of a launch: all ``n`` unless the widest row's elements times
    the rows would pass the kernel's int32 index (at least one row)."""
    widest = max(row_elements, default=1)
    return max(1, min(n, MAX_INDEX // max(widest, 1)))


def permute_rows(arrays: Dict[str, torch.Tensor], perm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{k: v[perm]}`` for arrays of ``n`` rows and a permutation of
    ``range(n)`` (int64 or int32), all on one device, of any dtype."""
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
    out = {name: torch.empty_like(v) for name, v in arrays.items()}
    # rows of no bytes have nothing to copy
    pairs = [(v, out[name], v[0].numel() * v.element_size()) for name, v in arrays.items() if n and v[0].numel()]
    if not pairs:
        return out
    k = len(pairs)
    row_bytes = [w for _, _, w in pairs]
    elems = [element_bytes(w, v.data_ptr(), o.data_ptr()) for v, o, w in pairs]
    rows = launch_rows(n, [w // e for w, e in zip(row_bytes, elems)])
    src = (ctypes.c_void_p * k)(*[v.data_ptr() for v, _, _ in pairs])
    dst = (ctypes.c_void_p * k)(*[o.data_ptr() for _, o, _ in pairs])
    fn = library("permute").nvt_permute_rows
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    launched = ctypes.c_int(0)
    rc = fn(src, dst, (ctypes.c_int64 * k)(*row_bytes), (ctypes.c_int * k)(*elems), k, ptr(perm),
            int(perm.dtype == torch.int64), n, rows, ctypes.byref(launched), stream_ptr(dev))
    raise_on_error(rc, "permute_rows")
    LAUNCHES["permute_rows"] += launched.value
    return out


def permute_rows_plain(arrays: Dict[str, torch.Tensor], perm: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {name: v[perm] for name, v in arrays.items()}
