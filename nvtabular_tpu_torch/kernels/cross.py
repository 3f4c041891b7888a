"""The DCN-v2 cross layer's epilogue and its gradient: CUDA kernel K17,
wrappers, plain versions.

``nvtabular_tpu/models/deepfm.py:126-134`` computes each cross layer as
``x0 * (xw + b) + x`` over [B, N] float32, where ``xw`` is the float32
product of the bfloat16-rounded ``x`` and ``W``. The product is kernel
K21 (``kernels/mlp_mm.py``); these kernels are everything after it
(``csrc/cross.cu``). Inputs may be strided views (each row contiguous);
outputs are contiguous.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import LAUNCHES, check, check_rows, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

MAX_ROW_BLOCKS = 65535  # csrc/cross.cu kMaxRowBlocks: gridDim.y's limit
ROWS_PER_BLOCK = 256

_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                 ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _check(xw: torch.Tensor, b: torch.Tensor, x0: torch.Tensor) -> Tuple[int, int]:
    if xw.dim() != 2:
        raise ValueError(f"xw must be [B, N], got shape {tuple(xw.shape)}")
    B, N = xw.shape
    dev = xw.device
    check_rows(xw, "xw", (B, N), dev)
    check(b, "b", torch.float32, dev, (N,))
    check_rows(x0, "x0", (B, N), dev)
    if use_kernel(xw) and N < 1:
        raise ValueError(f"the cross kernels take N >= 1, got [{B}, {N}]")
    return B, N


def row_blocks(B: int) -> int:
    """The kernels' blocks in y (gridDim.y): one a range of ROWS_PER_BLOCK
    rows up to MAX_ROW_BLOCKS, whose blocks then walk every
    MAX_ROW_BLOCKS-th range."""
    return max(1, min(-(-B // ROWS_PER_BLOCK), MAX_ROW_BLOCKS))


def cross_fwd(xw: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x0 * (xw + b) + x`` → float32 [B, N]."""
    B, N = _check(xw, b, x0)
    check_rows(x, "x", (B, N), xw.device)
    if not use_kernel(xw):
        return cross_fwd_plain(xw, b, x0, x)
    out = torch.empty((B, N), dtype=torch.float32, device=xw.device)
    if B == 0:
        return out
    fn = library("cross").nvt_cross_fwd
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(xw), xw.stride(0), ptr(b), ptr(x0), x0.stride(0), ptr(x), x.stride(0), B, N, row_blocks(B),
            ptr(out), stream_ptr(xw.device))
    raise_on_error(rc, "cross_fwd")
    LAUNCHES["cross_fwd"] += 1
    return out


def cross_bwd(g: torch.Tensor, xw: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``cross_fwd`` for the output gradient ``g`` [B, N]:
    (dxw = g * x0, dx0 = g * (xw + b), db = the column sums of g * x0); the
    gradient of ``x`` is ``g`` itself."""
    B, N = _check(xw, b, x0)
    check_rows(g, "g", (B, N), xw.device)
    if not use_kernel(xw):
        return cross_bwd_plain(g, xw, b, x0)
    dev = xw.device
    dxw = torch.empty((B, N), dtype=torch.float32, device=dev)
    dx0 = torch.empty((B, N), dtype=torch.float32, device=dev)
    db = torch.zeros(N, dtype=torch.float32, device=dev)
    if B == 0:
        return dxw, dx0, db
    fn = library("cross").nvt_cross_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(g), g.stride(0), ptr(xw), xw.stride(0), ptr(b), ptr(x0), x0.stride(0), B, N, row_blocks(B),
            ptr(dxw), ptr(dx0), ptr(db), stream_ptr(dev))
    raise_on_error(rc, "cross_bwd")
    LAUNCHES["cross_bwd"] += 1
    return dxw, dx0, db


def cross_fwd_plain(xw, b, x0, x) -> torch.Tensor:
    return x0 * (xw + b) + x


def cross_bwd_plain(g, xw, b, x0):
    dxw = g * x0
    return dxw, g * (xw + b), dxw.sum(dim=0)


class CrossLayer(torch.autograd.Function):
    """One cross layer after its product: (xw, b, x0, x) → x0 * (xw + b) + x."""

    @staticmethod
    def forward(ctx, xw, b, x0, x):
        ctx.save_for_backward(xw, b, x0)
        return cross_fwd(xw, b, x0, x)

    @staticmethod
    def backward(ctx, g):
        xw, b, x0 = ctx.saved_tensors
        if g.shape[1] > 1 and g.stride(1) != 1:
            g = g.contiguous()
        dxw, dx0, db = cross_bwd(g, xw, b, x0)
        need = ctx.needs_input_grad
        return (dxw if need[0] else None, db if need[1] else None, dx0 if need[2] else None, g if need[3] else None)


def cross_layer(xw: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return CrossLayer.apply(xw, b, x0, x)
