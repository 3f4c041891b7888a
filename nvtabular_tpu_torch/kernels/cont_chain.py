"""Fused continuous chain: CUDA kernel K5, its wrapper and plain version.

FillMissing → Clip → LogOp → Normalize over stacked float32 columns
``x`` [C, N] in one pass. ``params`` [C, 5] float32 holds each column's
(fill, lo, hi, sub, div); ``flags`` [C] int32 says which stages apply (bits
below). The kernel is ``csrc/cont_chain.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

FILL, LO, HI, LOG, NORM = 1, 2, 4, 8, 16
N_PARAMS = 5  # fill, lo, hi, sub, div

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]


def cont_chain(x, validity, params, flags) -> torch.Tensor:
    """Replaces the XLA-fused chain of nvtabular_tpu/ops/{fill,clip,logop,
    normalize}.py. Returns the chain's output [C, N] float32."""
    if x.dim() != 2:
        raise ValueError(f"x must be [C, N], got shape {tuple(x.shape)}")
    dev = x.device
    C, N = x.shape
    check(x, "x", torch.float32, dev)
    check(validity, "validity", torch.bool, dev, x.shape, optional=True)
    check(params, "params", torch.float32, dev, (C, N_PARAMS))
    check(flags, "flags", torch.int32, dev, (C,))
    if not use_kernel(x):
        return cont_chain_plain(x, validity, params, flags)
    out = torch.empty_like(x)
    if C == 0 or N == 0:
        return out
    fn = library("cont_chain").nvt_cont_chain
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(x), ptr(validity), ptr(params), ptr(flags), ptr(out), C, N, stream_ptr(dev))
    raise_on_error(rc, "cont_chain")
    LAUNCHES["cont_chain"] += 1
    return out


def cont_chain_plain(x, validity, params, flags) -> torch.Tensor:
    f = flags[:, None]
    p = [params[:, k : k + 1] for k in range(N_PARAMS)]
    null = torch.isnan(x) if validity is None else (torch.isnan(x) | ~validity)
    x = torch.where(((f & FILL) != 0) & null, p[0], x)
    x = torch.where(((f & LO) != 0) & (x < p[1]), p[1], x)  # keeps NaN, as jnp.clip
    x = torch.where(((f & HI) != 0) & (x > p[2]), p[2], x)
    x = torch.where((f & LOG) != 0, torch.log1p(x), x)
    return torch.where((f & NORM) != 0, (x - p[3]) / p[4], x)
