"""Bucketize: CUDA kernel K12b, its wrapper and plain PyTorch version.

``bucketize(x, bounds)`` is ``jnp.searchsorted(bounds, x, side="right")``
as int32: the number of bounds at or below each value, NaN past the last
bound. ``bounds`` must be ascending and of ``x``'s dtype (the op casts them).
The kernel is ``csrc/bucketize.cu``: a block stages ``bound_chunk`` bounds
at once, and past one chunk its one launch sums the chunks' counts.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

BOUNDS_CHUNK = 4096  # csrc/bucketize.cu kMaxBounds: the bounds a block stages at once
_KINDS = {torch.float32: 0, torch.float64: 1, torch.int32: 2, torch.int64: 3}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p]


def bucketize(x: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Replaces the device branch of ``Bucketize.transform``
    (nvtabular_tpu/ops/bucketize.py:35-52). x: 1-d; returns int32 [n]."""
    if x.dim() != 1 or bounds.dim() != 1:
        raise ValueError(f"x and bounds must be 1-d, got {tuple(x.shape)} and {tuple(bounds.shape)}")
    if x.dtype not in _KINDS:
        raise NotImplementedError(f"Bucketize of {x.dtype} columns is not ported")
    check(x, "x", x.dtype, x.device)
    check(bounds, "bounds", x.dtype, x.device)
    if not use_kernel(x):
        return bucketize_plain(x, bounds)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    if x.shape[0]:
        fn = library("bucketize").nvt_bucketize
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        nb = bounds.shape[0]
        rc = fn(ptr(x), ptr(bounds), nb, bound_chunk(nb), x.shape[0], _KINDS[x.dtype], ptr(out), stream_ptr(x.device))
        raise_on_error(rc, "bucketize")
        LAUNCHES["bucketize"] += 1
    return out


def bound_chunk(nb: int) -> int:
    """The bounds a block of the kernel stages in shared memory at once: all
    ``nb`` up to BOUNDS_CHUNK, else chunks of BOUNDS_CHUNK."""
    return min(nb, BOUNDS_CHUNK)


def bucketize_plain(x: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    # the count of bounds that x is not below: NaN is below none
    return (~(x[:, None] < bounds[None, :])).sum(dim=1, dtype=torch.int32)
