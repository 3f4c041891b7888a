"""Per-column partial moments: CUDA kernel K15c, wrapper and plain version.

``column_moments(x)`` is ``local_partials`` of
``nvtabular_tpu/parallel/stats.py:50-63``, the per-device body of
``sharded_moments``: over a float32 [rows, cols] array, NaN as null, each
column's count (int32), mean, M2 = sum (x - mean)^2, min and max (+inf /
-inf when empty). The kernel is ``csrc/moments.cu``; it sums in float64
before rounding to float32, so it agrees with the plain version (float32
sums, as the reference's) within a tolerance, and bit for bit on count,
min and max.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

_P = ctypes.c_void_p
# x, rows, cols, count, mean, m2, min, max, stream
_ARGTYPES = [_P, ctypes.c_int64, ctypes.c_int, _P, _P, _P, _P, _P, _P]

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def column_moments(x: torch.Tensor) -> Moments:
    """float32 [rows, cols] → (count int32, mean, m2, min, max float32), each [cols]."""
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, cols], got shape {tuple(x.shape)}")
    check(x, "x", torch.float32, x.device)
    if not use_kernel(x):
        return column_moments_plain(x)
    rows, cols = x.shape
    dev = x.device
    count = torch.empty(cols, dtype=torch.int32, device=dev)
    mean, m2, mn, mx = (torch.empty(cols, dtype=torch.float32, device=dev) for _ in range(4))
    fn = library("moments").nvt_column_moments
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(x), rows, cols, ptr(count), ptr(mean), ptr(m2), ptr(mn), ptr(mx), stream_ptr(dev))
    raise_on_error(rc, "column_moments")
    LAUNCHES["column_moments"] += 1
    return count, mean, m2, mn, mx


def column_moments_plain(x: torch.Tensor) -> Moments:
    """stats.py:50-63 in PyTorch, float32 throughout."""
    valid = ~torch.isnan(x)
    count = valid.sum(dim=0, dtype=torch.int32)
    mean = torch.where(valid, x, 0.0).sum(dim=0) / count.clamp(min=1).to(x.dtype)
    d = torch.where(valid, x - mean, 0.0)
    m2 = (d * d).sum(dim=0)
    mn = torch.where(valid, x, float("inf")).amin(dim=0) if x.shape[0] else torch.full_like(mean, float("inf"))
    mx = torch.where(valid, x, float("-inf")).amax(dim=0) if x.shape[0] else torch.full_like(mean, float("-inf"))
    return count, mean, m2, mn, mx
