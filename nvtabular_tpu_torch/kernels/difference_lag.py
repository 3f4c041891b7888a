"""Partition-aware shifts: CUDA kernel K12a, its wrapper and plain version.

``difference_lag(keys, values, shifts)`` computes, for every shift s and
value column c, ``x_c[i] - x_c[i - s]`` in float32 where row ``i - s`` lies
in the batch and every partition key of the two rows is equal, and NaN
elsewhere: DifferenceLag's transform (nvtabular_tpu/ops/difference_lag.py:
44-115) in one launch a batch. The kernel is ``csrc/difference_lag.cu``.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

MAX_KEYS, MAX_VALUES, MAX_SHIFTS = 8, 16, 16  # csrc/difference_lag.cu
MAX_ABS_SHIFT = 2**62
_KEY_KINDS = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}

_P = ctypes.c_void_p
_ARGTYPES = {
    # keys, key_kinds, num_keys, values, num_values, shifts, num_shifts, n, out, stream
    "nvt_difference_lag": [_P, _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int64, _P, _P],
}


def _fn(name: str):
    fn = getattr(library("difference_lag"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def comparable_key(key: torch.Tensor) -> torch.Tensor:
    """A partition key as one of the kernel's kinds; widening keeps every
    equality (and a NaN unequal to everything)."""
    if key.dtype in _KEY_KINDS:
        return key
    if key.is_floating_point():
        return key.to(torch.float64)
    if key.dtype in (torch.bool, torch.int8, torch.int16, torch.uint8):
        return key.to(torch.int32)
    raise NotImplementedError(f"DifferenceLag partition keys of dtype {key.dtype} are not ported")


def difference_lag_plain(keys: Sequence[torch.Tensor], values: Sequence[torch.Tensor], shifts: Sequence[int]):
    n = values[0].shape[0] if values else (keys[0].shape[0] if keys else 0)
    out = torch.empty((len(shifts), len(values), n), dtype=torch.float32, device=_device(keys, values))
    i = torch.arange(n, device=out.device)
    for si, s in enumerate(shifts):
        j = i - s
        same = (j >= 0) & (j < n)
        j = j.clamp(0, max(n - 1, 0))
        for k in keys:
            same &= k == k[j]
        for ci, x in enumerate(values):
            out[si, ci] = torch.where(same, x - x[j], float("nan"))
    return out


def _device(keys, values):
    return (values[0] if values else keys[0]).device


def difference_lag(keys: Sequence[torch.Tensor], values: Sequence[torch.Tensor], shifts: Sequence[int]):
    """Replaces ``_shift`` and ``_shift_equal`` as DifferenceLag combines them
    (nvtabular_tpu/ops/difference_lag.py:44-66, 79-115).

    keys: partition key columns (int32, int64, float32, float64; narrower
    types widen); values: float32 columns; both 1-d of n rows. Returns
    float32 [len(shifts), len(values), n]."""
    if not values:
        raise ValueError("difference_lag needs at least one value column")
    ks: List[torch.Tensor] = [comparable_key(k) for k in keys]
    dev, n = values[0].device, values[0].shape[0]
    for i, k in enumerate(ks):
        check(k, f"key {i}", k.dtype, dev, (n,))
    for i, x in enumerate(values):
        check(x, f"value {i}", torch.float32, dev, (n,))
    shifts = [int(s) for s in shifts]
    if any(abs(s) >= MAX_ABS_SHIFT for s in shifts):
        raise ValueError(f"shifts must lie inside +-2**62, got {shifts}")
    if not use_kernel(values[0]):
        return difference_lag_plain(ks, values, shifts)
    if len(ks) > MAX_KEYS or len(values) > MAX_VALUES or len(shifts) > MAX_SHIFTS:
        raise ValueError(
            f"difference_lag takes at most {MAX_KEYS} keys, {MAX_VALUES} value columns and {MAX_SHIFTS} shifts"
        )
    out = torch.empty((len(shifts), len(values), n), dtype=torch.float32, device=dev)
    if n and shifts:
        kptrs = (ctypes.c_void_p * max(len(ks), 1))(*[k.data_ptr() for k in ks])
        kinds = (ctypes.c_int * max(len(ks), 1))(*[_KEY_KINDS[k.dtype] for k in ks])
        vptrs = (ctypes.c_void_p * len(values))(*[x.data_ptr() for x in values])
        sarr = (ctypes.c_int64 * len(shifts))(*shifts)
        rc = _fn("nvt_difference_lag")(
            kptrs, kinds, len(ks), vptrs, len(values), sarr, len(shifts), n, ptr(out), stream_ptr(dev)
        )
        raise_on_error(rc, "difference_lag")
        LAUNCHES["difference_lag"] += 1
    return out
