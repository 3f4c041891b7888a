"""The xDeepFM CIN layer and its gradient: CUDA kernel K13d, wrappers, plain versions.

``cin_fwd(x_k, x_0, w)`` is ``nvtabular_tpu/models/layers.py:120-141``
(``xdeepfm_outer_product``): for x_k float32 [B, Hk, D], x_0 float32
[B, F, D] and w float32 [Hk * F, Hn],

    out[b, h, d] = sum_{i, j} w[i * F + j, h] * x_k[b, i, d] * x_0[b, j, d]

→ float32 [B, Hn, D], the pair index i-major as the reference's reshape has
it. The kernel builds the outer product tile by tile in shared memory and
never stores it; ``cin_bwd`` gives dx_k, dx_0 and dw, dw's reduction over
B * D inside the kernel. ``CIN`` wires both through autograd; x_k and x_0
may be one tensor (CIN's first layer), and autograd then sums the two
gradients. The kernels are ``csrc/cin.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

SMEM_OPT_IN = 227 * 1024  # the H100's shared memory a block can opt into
FWD_COLS, FWD_DEPTH = 64, 16  # csrc/cin.cu kFwdCols, kFwdDepth
BX_COLS, BX_ROWS, BX_DEPTH, BX_CHUNK = 64, 256, 32, 128  # csrc/cin.cu kBxCols, kBxRows, kBxDepth, kBxChunk

# x_k, x_0, w, B, Hk, F, D, Hn, ci, cj, out, stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
# x_k, x_0, w, g, B, Hk, F, D, Hn, jr, xk_rows, dx_k, dx_0, dw, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4


def pass_rows(Hn: int) -> int:
    """Rows h of a forward or dw pass (csrc/cin.cu fwd_rows): 8 for each 8
    of Hn, at most 256 (the block's threads)."""
    return 8 * min(32, -(-Hn // 8))


def fwd_smem_bytes(rows: int, ci: int, cj: int) -> int:
    """csrc/cin.cu fwd_smem: the columns' offsets, ci rows of x_k and cj of
    x_0 (64 columns each), two buffers of w and z tiles."""
    return 3 * FWD_COLS * 8 + ((ci + cj) * FWD_COLS + 2 * FWD_DEPTH * (rows + FWD_COLS)) * 4


def fwd_plan(Hk: int, F: int, Hn: int):
    """(rows, ci, cj): the forward stages all Hk + F rows where they fit
    SMEM_OPT_IN, else x_k in chunks of ci rows beside x_0 (all F rows where
    F leaves room for 16 rows of x_k, else halves of what fits)."""
    rows = pass_rows(Hn)
    if fwd_smem_bytes(rows, Hk, F) <= SMEM_OPT_IN:
        return rows, Hk, F
    room = (SMEM_OPT_IN - fwd_smem_bytes(rows, 0, 0)) // (FWD_COLS * 4)  # rows of x a block holds
    cj = F if F + 16 <= room else room // 2
    return rows, min(Hk, room - cj), cj


def bwd_x_plan(F: int):
    """(jr, xk_rows, smem) of cin_bwd_x (csrc/cin.cu bx_layout): x_0 in n =
    ceil(F / BX_CHUNK) chunks of jr = ceil(F / n) rows, a pass's 256 pairs
    spanning at most xk_rows rows of x_k in the narrowest chunk."""
    n = -(-F // BX_CHUNK)
    jr = -(-F // n)
    narrowest = F - (n - 1) * jr
    xk_rows = -(-(BX_ROWS - 1) // narrowest) + 1
    floats = 2 * BX_ROWS * BX_DEPTH + 2 * BX_DEPTH * BX_COLS + 2 * jr * BX_COLS + xk_rows * BX_COLS
    return jr, xk_rows, 3 * BX_COLS * 8 + 3 * BX_ROWS * 4 + floats * 4


def _check(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor):
    """Validates the layer's inputs; returns (B, Hk, F, D, Hn)."""
    if x_k.dim() != 3 or x_0.dim() != 3 or w.dim() != 2:
        raise ValueError(f"expected x_k [B, Hk, D], x_0 [B, F, D] and w [Hk * F, Hn], got shapes "
                         f"{tuple(x_k.shape)}, {tuple(x_0.shape)}, {tuple(w.shape)}")
    for t, what in ((x_k, "x_k"), (x_0, "x_0"), (w, "w")):
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"xdeepfm_outer_product takes float32 only, got {what} {t.dtype} "
                "(ROADMAP.md queue 1 item 9: K13d in bfloat16)"
            )
    B, Hk, D = x_k.shape
    F = x_0.shape[1]
    dev = x_k.device
    check(x_0, "x_0", torch.float32, dev, (B, F, D))
    check(x_k, "x_k", torch.float32, dev)
    if w.shape[0] != Hk * F:
        raise ValueError(f"w must have Hk * F = {Hk * F} rows, got {w.shape[0]}")
    check(w, "w", torch.float32, dev)
    if use_kernel(x_k) and min(Hk, F, D, w.shape[1]) < 1:
        raise ValueError(f"the CIN kernels take Hk, F, D and Hn >= 1, got {Hk}, {F}, {D}, {w.shape[1]}")
    return B, Hk, F, D, w.shape[1]


def cin_fwd(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """→ float32 [B, Hn, D]."""
    B, Hk, F, D, Hn = _check(x_k, x_0, w)
    if not use_kernel(x_k):
        return cin_fwd_plain(x_k, x_0, w)
    lib = library("cin")
    if lib.nvt_cin_fwd.argtypes is None:
        lib.nvt_cin_fwd.argtypes = _FWD_ARGTYPES
        lib.nvt_cin_fwd.restype = ctypes.c_int
    out = torch.empty((B, Hn, D), dtype=torch.float32, device=x_k.device)
    if B == 0:
        return out
    _, ci, cj = fwd_plan(Hk, F, Hn)
    rc = lib.nvt_cin_fwd(ptr(x_k), ptr(x_0), ptr(w), B, Hk, F, D, Hn, ci, cj, ptr(out), stream_ptr(x_k.device))
    raise_on_error(rc, "cin_fwd")
    LAUNCHES["cin_fwd"] += 1
    return out


def cin_bwd(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor, grad: torch.Tensor):
    """The gradients of ``cin_fwd`` at (x_k, x_0, w) for the output gradient
    ``grad`` [B, Hn, D] → (dx_k, dx_0, dw), float32."""
    B, Hk, F, D, Hn = _check(x_k, x_0, w)
    check(grad, "grad", torch.float32, x_k.device, (B, Hn, D))
    if not use_kernel(x_k):
        return cin_bwd_plain(x_k, x_0, w, grad)
    lib = library("cin")
    if lib.nvt_cin_bwd.argtypes is None:
        lib.nvt_cin_bwd.argtypes = _BWD_ARGTYPES
        lib.nvt_cin_bwd.restype = ctypes.c_int
    dx_k, dx_0 = torch.empty_like(x_k), torch.empty_like(x_0)
    dw = torch.empty_like(w)
    jr, xk_rows, _ = bwd_x_plan(F)
    rc = lib.nvt_cin_bwd(ptr(x_k), ptr(x_0), ptr(w), ptr(grad), B, Hk, F, D, Hn, jr, xk_rows, ptr(dx_k), ptr(dx_0),
                         ptr(dw), stream_ptr(x_k.device))
    raise_on_error(rc, "cin_bwd")
    LAUNCHES["cin_bwd"] += 1
    return dx_k, dx_0, dw


def outer_product_plain(x_k: torch.Tensor, x_0: torch.Tensor) -> torch.Tensor:
    """z [B, Hk * F, D], pair index i-major (layers.py:133-135)."""
    B, Hk, D = x_k.shape
    return (x_k[:, :, None, :] * x_0[:, None, :, :]).reshape(B, Hk * x_0.shape[1], D)


def cin_fwd_plain(x_k, x_0, w) -> torch.Tensor:
    return torch.matmul(w.t(), outer_product_plain(x_k, x_0))  # [B, Hn, D]


def cin_bwd_plain(x_k, x_0, w, grad):
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x_k, x_0, w)]
        return torch.autograd.grad(cin_fwd_plain(*leaves), leaves, grad)


class CIN(torch.autograd.Function):
    """``cin_fwd`` with ``cin_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, x_k, x_0, w):
        ctx.save_for_backward(x_k, x_0, w)
        return cin_fwd(x_k, x_0, w)

    @staticmethod
    def backward(ctx, grad):
        x_k, x_0, w = ctx.saved_tensors
        return cin_bwd(x_k, x_0, w, grad.contiguous())


def cin(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return CIN.apply(x_k, x_0, w)
