"""Fused continuous chain: CUDA kernel K5, its wrapper and plain version.

FillMissing / FillMedian → Clip → LogOp → Normalize / NormalizeMinMax over
stacked float32 columns ``x`` [C, N] in one pass. ``params`` [C, 5] float32
holds each column's (fill, lo, hi, sub, div); ``flags`` [C] int32 says which
stages apply (bits below: ZERO is NormalizeMinMax over a zero span, whose
output is 0). The store is float32, or float16 / bfloat16 for a chain
ending in a normalize with that ``out_dtype``: the normalize stage then
rounds its input and each of its two operations to the 16-bit type, with
``sub`` and ``div`` already rounded to it. ``with_mask`` also returns the
input's null mask [C, N] (bool), the ``_filled`` columns of a fill that
ends its branch. The kernel is ``csrc/cont_chain.cu``; each launch counts
under its mode: ``cont_chain`` (float32, no mask), ``cont_chain_16`` (a
16-bit store) or ``cont_chain_mask``.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

FILL, LO, HI, LOG, NORM, ZERO = 1, 2, 4, 8, 16, 32
N_PARAMS = 5  # fill, lo, hi, sub, div
OUT_KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]


def _mode(out_dtype: torch.dtype, with_mask: bool) -> str:
    if with_mask:
        if out_dtype != torch.float32:
            raise ValueError("the mask comes with a float32 store (a fill ends its branch)")
        return "cont_chain_mask"
    return "cont_chain" if out_dtype == torch.float32 else "cont_chain_16"


def cont_chain(x, validity, params, flags, out_dtype: torch.dtype = torch.float32, with_mask: bool = False):
    """Replaces the XLA-fused chain of nvtabular_tpu/ops/{fill,clip,logop,
    normalize}.py. Returns the chain's output [C, N] of ``out_dtype``, and
    with ``with_mask`` the pair (output, bool null mask [C, N])."""
    if x.dim() != 2:
        raise ValueError(f"x must be [C, N], got shape {tuple(x.shape)}")
    dev = x.device
    C, N = x.shape
    check(x, "x", torch.float32, dev)
    check(validity, "validity", torch.bool, dev, x.shape, optional=True)
    check(params, "params", torch.float32, dev, (C, N_PARAMS))
    check(flags, "flags", torch.int32, dev, (C,))
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"out_dtype must be one of {list(OUT_KINDS)}, got {out_dtype}")
    mode = _mode(out_dtype, with_mask)
    if not use_kernel(x):
        return cont_chain_plain(x, validity, params, flags, out_dtype, with_mask)
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    mask = torch.empty(x.shape, dtype=torch.bool, device=dev) if with_mask else None
    if C and N:
        fn = library("cont_chain").nvt_cont_chain
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        rc = fn(ptr(x), ptr(validity), ptr(params), ptr(flags), ptr(out), ptr(mask), C, N, OUT_KINDS[out_dtype],
                stream_ptr(dev))
        raise_on_error(rc, "cont_chain")
        LAUNCHES[mode] += 1
    return (out, mask) if with_mask else out


def _rounded(v: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    return v.to(out_dtype).to(torch.float32)


def cont_chain_plain(x, validity, params, flags, out_dtype: torch.dtype = torch.float32, with_mask: bool = False):
    f = flags[:, None]
    p = [params[:, k : k + 1] for k in range(N_PARAMS)]
    null = torch.isnan(x) if validity is None else (torch.isnan(x) | ~validity)
    y = torch.where(((f & FILL) != 0) & null, p[0], x)
    y = torch.where(((f & LO) != 0) & (y < p[1]), p[1], y)  # keeps NaN, as jnp.clip
    y = torch.where(((f & HI) != 0) & (y > p[2]), p[2], y)
    y = torch.where((f & LOG) != 0, torch.log1p(y), y)
    normed = _rounded(_rounded(y, out_dtype) - p[3], out_dtype) / p[4]
    y = torch.where((f & NORM) != 0, normed, y)
    y = torch.where((f & ZERO) != 0, 0.0, y).to(out_dtype)
    return (y, null) if with_mask else y
