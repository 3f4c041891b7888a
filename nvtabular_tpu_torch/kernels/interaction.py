"""DLRM dot interaction and its gradient: CUDA kernel K13b, wrappers, plain versions.

For features ``x`` float32 [B, F, D], the interaction is the P = F (F - 1) / 2
dot products of distinct feature pairs in ``np.tril_indices(F, -1)`` order,
as ``nvtabular_tpu/models/layers.py:97-117`` computes them. The kernels are
``csrc/interaction.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import LAUNCHES, check, check_rows, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

SMEM_LIMIT = 48 * 1024  # static-launch shared memory, no opt-in attribute
MAX_SAMPLES_PER_BLOCK = 8

_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def num_pairs(f: int) -> int:
    return f * (f - 1) // 2


def _samples_per_block(F: int, D: int, backward: bool) -> int:
    """Samples a block stages (csrc/interaction.cu smem_bytes: rows padded to
    D + 1 floats, or D + 4 in the backward when D % 4 == 0)."""
    if backward:
        per_sample = (F * (D + 4 if D % 4 == 0 else D + 1) + num_pairs(F)) * 4
    else:
        per_sample = F * (D + 1) * 4
    if per_sample > SMEM_LIMIT:
        raise ValueError(f"interaction kernels: one sample of [{F}, {D}] needs {per_sample} B of shared memory")
    return min(MAX_SAMPLES_PER_BLOCK, SMEM_LIMIT // per_sample)


def interaction_fwd(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 [B, F, D] → [B, P]. ``out`` may be a column slice of a wider
    [B, W] buffer (rows strided, each row contiguous)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, F, D], got shape {tuple(x.shape)}")
    B, F, D = x.shape
    check(x, "x", torch.float32, x.device)
    P = num_pairs(F)
    if out is None:
        out = torch.empty((B, P), dtype=torch.float32, device=x.device)
    check_rows(out, "out", (B, P), x.device)
    if not use_kernel(x):
        out.copy_(interaction_fwd_plain(x))
        return out
    if B == 0 or P == 0:
        return out
    G = _samples_per_block(F, D, backward=False)
    fn = library("interaction").nvt_interaction_fwd
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(x), B, F, D, G, ptr(out), out.stride(0), stream_ptr(x.device))
    raise_on_error(rc, "interaction_fwd")
    LAUNCHES["interaction_fwd"] += 1
    return out


def interaction_bwd(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The gradient of ``interaction_fwd`` at ``x`` for the output gradient
    ``grad`` [B, P] (rows may be strided) → float32 [B, F, D]."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, F, D], got shape {tuple(x.shape)}")
    B, F, D = x.shape
    check(x, "x", torch.float32, x.device)
    P = num_pairs(F)
    check_rows(grad, "grad", (B, P), x.device)
    if not use_kernel(x):
        return interaction_bwd_plain(x, grad)
    if B == 0 or P == 0:
        return torch.zeros_like(x)
    dx = torch.empty_like(x)
    G = _samples_per_block(F, D, backward=True)
    fn = library("interaction").nvt_interaction_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(x), ptr(grad), grad.stride(0), B, F, D, G, ptr(dx), stream_ptr(x.device))
    raise_on_error(rc, "interaction_bwd")
    LAUNCHES["interaction_bwd"] += 1
    return dx


def _pair_index(f: int, device) -> torch.Tensor:
    rows, cols = np.tril_indices(f, k=-1)
    return torch.from_numpy(rows * f + cols).to(device)


def interaction_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    B, F, _ = x.shape
    inter = torch.bmm(x, x.transpose(1, 2))  # [B, F, F]
    return inter.reshape(B, F * F)[:, _pair_index(F, x.device)]


def interaction_bwd_plain(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(interaction_fwd_plain(leaf), leaf, grad)
    return dx


class DotInteraction(torch.autograd.Function):
    """[B, F, D] features → [B, W + P]: an optional leading [B, W] block
    (DLRM's bottom-MLP output, the concatenation at
    nvtabular_tpu/models/dlrm.py:135), then the P pair dots written in place
    by the kernel."""

    @staticmethod
    def forward(ctx, x, lead):
        B, F, _ = x.shape
        W = 0 if lead is None else lead.shape[1]
        out = torch.empty((B, W + num_pairs(F)), dtype=torch.float32, device=x.device)
        if lead is not None:
            out[:, :W].copy_(lead)
        interaction_fwd(x, out=out[:, W:])
        ctx.save_for_backward(x)
        ctx.width = W
        return out

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        W = ctx.width
        grad = grad.contiguous()
        dx = interaction_bwd(x, grad[:, W:]) if ctx.needs_input_grad[0] else None
        d_lead = grad[:, :W] if W and ctx.needs_input_grad[1] else None
        return dx, d_lead


def dot_interaction(x: torch.Tensor, lead: Optional[torch.Tensor] = None) -> torch.Tensor:
    return DotInteraction.apply(x, lead)
