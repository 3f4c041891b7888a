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

SMEM_LIMIT = 227 * 1024  # the H100's shared memory a block can opt into

# x_k, x_0, w, B, Hk, F, D, Hn, out, stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
# x_k, x_0, w, g, B, Hk, F, D, Hn, dx_k, dx_0, dw, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4


def _check(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor):
    """Validates the layer's inputs; returns (B, Hk, F, D, Hn)."""
    if x_k.dim() != 3 or x_0.dim() != 3 or w.dim() != 2:
        raise ValueError(f"expected x_k [B, Hk, D], x_0 [B, F, D] and w [Hk * F, Hn], got shapes "
                         f"{tuple(x_k.shape)}, {tuple(x_0.shape)}, {tuple(w.shape)}")
    for t, what in ((x_k, "x_k"), (x_0, "x_0"), (w, "w")):
        if t.dtype != torch.float32:
            raise NotImplementedError(
                f"xdeepfm_outer_product takes float32 only, got {what} {t.dtype} "
                "(ROADMAP.md queue 2: K13d in bfloat16)"
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
    out = torch.empty((B, Hn, D), dtype=torch.float32, device=x_k.device)
    if B == 0:
        return out
    fn = library("cin").nvt_cin_fwd
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(x_k), ptr(x_0), ptr(w), B, Hk, F, D, Hn, ptr(out), stream_ptr(x_k.device))
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
        lib.nvt_cin_bwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.nvt_cin_bwd_smem.restype = ctypes.c_int64
        lib.nvt_cin_bwd.argtypes = _BWD_ARGTYPES
        lib.nvt_cin_bwd.restype = ctypes.c_int
    smem = lib.nvt_cin_bwd_smem(Hk, F)
    if smem > SMEM_LIMIT:
        raise ValueError(f"cin_bwd: Hk + F = {Hk + F} needs {smem} B of shared memory a block, over {SMEM_LIMIT}")
    dx_k, dx_0 = torch.empty_like(x_k), torch.empty_like(x_0)
    dw = torch.empty_like(w)
    rc = lib.nvt_cin_bwd(ptr(x_k), ptr(x_0), ptr(w), ptr(grad), B, Hk, F, D, Hn, ptr(dx_k), ptr(dx_0), ptr(dw),
                         stream_ptr(x_k.device))
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
