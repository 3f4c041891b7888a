"""DLRM dot interaction and its gradient: CUDA kernel K13b, wrappers, plain versions.

For features ``x`` float32 [B, F, D], the interaction is the P = F (F - 1) / 2
dot products of distinct feature pairs in ``np.tril_indices(F, -1)`` order,
as ``nvtabular_tpu/models/layers.py:97-117`` computes them; with
``self_interaction`` the P = F (F + 1) / 2 pairs of ``np.tril_indices(F, 0)``,
each feature's dot with itself included (a mode of both kernels, counted
apart as ``interaction_self_fwd`` / ``_bwd``). The kernels are
``csrc/interaction.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import LAUNCHES, check, check_rows, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

SMEM_LIMIT = 48 * 1024  # the forward's static-launch shared memory, no opt-in attribute
MAX_SAMPLES_PER_BLOCK = 8  # the forward's
SMEM_OPT_IN = 227 * 1024  # the shared memory an H100 block can opt into: the backward's two stages
BWD_THREADS = 256  # csrc/interaction.cu kBwdThreads
BWD_ROWS = 8  # csrc/interaction.cu kBwdRows: rows of a sample a backward thread sums

# x, B, F, D, G, self_mode, out, out row stride, stream
_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
# x, g, g row stride, B, F, D, G, cols, self_mode, dx, stream
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def num_pairs(f: int, self_interaction: bool = False) -> int:
    return f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2


def _fwd_samples_per_block(F: int, D: int) -> int:
    """Samples a forward block stages (csrc/interaction.cu fwd_smem_bytes:
    rows padded to D + 1 floats)."""
    per_sample = F * (D + 1) * 4
    if per_sample > SMEM_LIMIT:
        raise ValueError(f"interaction kernels: one sample of [{F}, {D}] needs {per_sample} B of shared memory")
    return min(MAX_SAMPLES_PER_BLOCK, SMEM_LIMIT // per_sample)


def bwd_columns(D: int, aligned: bool) -> int:
    """Columns of a row one backward thread sums: 4 (float4 reads) when D is
    a multiple of 4 and x is 16-byte aligned, else 1."""
    return 4 if aligned and D % 4 == 0 else 1


def bwd_smem_bytes(F: int, D: int, cols: int, G: int, self_interaction: bool) -> int:
    """The backward block's shared memory (csrc/interaction.cu
    bwd_stage_floats): two stages of G samples' X and gradient slots, and
    the stages' two 8-byte barriers. An X slot holds F * D floats at a pad
    of up to 3, in a number of 16-byte units equal to the row's column
    chunks mod 8; a gradient slot P + 1 floats at a pad of up to 3, in an
    odd number of 16-byte units."""
    chunks = D // cols
    x_units = (F * D + 6) // 4
    while (x_units - chunks) % 8:
        x_units += 1
    g_units = (num_pairs(F, self_interaction) + 7) // 4
    g_units += 1 - g_units % 2
    return 2 * G * (x_units + g_units) * 16 + 16


def bwd_plan(F: int, D: int, cols: int, self_interaction: bool) -> int:
    """Samples G of a backward group. A thread takes BWD_ROWS rows and
    ``cols`` columns of a sample, at most one such item a group: G =
    BWD_THREADS // items a sample (16 at DLRM's [27, 16]), less where two
    stages would not fit SMEM_OPT_IN."""
    items = -(-F // BWD_ROWS) * (D // cols)
    G = BWD_THREADS // items
    while G > 0 and bwd_smem_bytes(F, D, cols, G, self_interaction) > SMEM_OPT_IN:
        G -= 1
    if G == 0:
        raise ValueError(f"interaction_bwd: a sample of [{F}, {D}] is {items} items of {BWD_ROWS} rows and {cols} "
                         f"columns, over {BWD_THREADS}, or its two stages need "
                         f"{bwd_smem_bytes(F, D, cols, 1, self_interaction)} B of shared memory, over {SMEM_OPT_IN}")
    return G


def _check_x(x: torch.Tensor):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, F, D], got shape {tuple(x.shape)}")
    check(x, "x", torch.float32, x.device)
    return x.shape


def interaction_fwd(x: torch.Tensor, out: Optional[torch.Tensor] = None,
                    self_interaction: bool = False) -> torch.Tensor:
    """float32 [B, F, D] → [B, P]. ``out`` may be a column slice of a wider
    [B, W] buffer (rows strided, each row contiguous)."""
    B, F, D = _check_x(x)
    P = num_pairs(F, self_interaction)
    if out is None:
        out = torch.empty((B, P), dtype=torch.float32, device=x.device)
    check_rows(out, "out", (B, P), x.device)
    if not use_kernel(x):
        out.copy_(interaction_fwd_plain(x, self_interaction))
        return out
    if B == 0 or P == 0:
        return out
    G = _fwd_samples_per_block(F, D)
    fn = library("interaction").nvt_interaction_fwd
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(x), B, F, D, G, int(self_interaction), ptr(out), out.stride(0), stream_ptr(x.device))
    name = "interaction_self_fwd" if self_interaction else "interaction_fwd"
    raise_on_error(rc, name)
    LAUNCHES[name] += 1
    return out


def interaction_bwd(x: torch.Tensor, grad: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    """The gradient of ``interaction_fwd`` at ``x`` for the output gradient
    ``grad`` [B, P] (rows may be strided) → float32 [B, F, D]."""
    B, F, D = _check_x(x)
    P = num_pairs(F, self_interaction)
    check_rows(grad, "grad", (B, P), x.device)
    if not use_kernel(x):
        return interaction_bwd_plain(x, grad, self_interaction)
    if B == 0 or P == 0:
        return torch.zeros_like(x)
    dx = torch.empty_like(x)
    cols = bwd_columns(D, x.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0)
    G = bwd_plan(F, D, cols, self_interaction)
    fn = library("interaction").nvt_interaction_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(x), ptr(grad), grad.stride(0), B, F, D, G, cols, int(self_interaction), ptr(dx),
            stream_ptr(x.device))
    name = "interaction_self_bwd" if self_interaction else "interaction_bwd"
    raise_on_error(rc, name)
    LAUNCHES[name] += 1
    return dx


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fmaf(a, b, c)``: the product of two float32 values is exact
    in float64, so one float64 sum and its rounding to float32 give it (a
    double rounding differs from fmaf's single one about once in 2^29)."""
    return (a.double() * b.double() + c.double()).float()


def interaction_fwd_plain(x: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    """The pair dots as the kernel sums them: over d in order, one fmaf a
    step."""
    B, F, D = x.shape
    rows, cols = (torch.from_numpy(a).to(x.device) for a in np.tril_indices(F, k=0 if self_interaction else -1))
    out = torch.zeros((B, rows.numel()), dtype=x.dtype, device=x.device)
    for d in range(D):
        xd = x[:, :, d]
        out = _fma(xd[:, rows], xd[:, cols], out)
    return out


def interaction_bwd_plain(x: torch.Tensor, grad: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    """dX[b, i] = sum_j w[b, i, j] X[b, j] as the kernel sums it: over j in
    order, one fmaf a step, w the pairs' gradient as a symmetric [F, F]
    matrix (2 g_ii on its diagonal in the self mode, 0 in the strict one)."""
    B, F, D = x.shape
    rows, cols = (torch.from_numpy(a).to(x.device) for a in np.tril_indices(F, k=0 if self_interaction else -1))
    w = torch.zeros((B, F, F), dtype=x.dtype, device=x.device)
    w[:, rows, cols] = grad
    w = w + w.transpose(1, 2)
    dx = torch.zeros_like(x)
    for j in range(F):
        dx = _fma(w[:, :, j, None], x[:, None, j, :], dx)
    return dx


class DotInteraction(torch.autograd.Function):
    """[B, F, D] features → [B, W + P]: an optional leading [B, W] block
    (DLRM's bottom-MLP output, the concatenation at
    nvtabular_tpu/models/dlrm.py:135), then the P pair dots written in place
    by the kernel."""

    @staticmethod
    def forward(ctx, x, lead, self_interaction):
        B, F, _ = x.shape
        W = 0 if lead is None else lead.shape[1]
        out = torch.empty((B, W + num_pairs(F, self_interaction)), dtype=torch.float32, device=x.device)
        if lead is not None:
            out[:, :W].copy_(lead)
        interaction_fwd(x, out=out[:, W:], self_interaction=self_interaction)
        ctx.save_for_backward(x)
        ctx.meta = (W, self_interaction)
        return out

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        W, self_interaction = ctx.meta
        grad = grad.contiguous()
        dx = interaction_bwd(x, grad[:, W:], self_interaction) if ctx.needs_input_grad[0] else None
        d_lead = grad[:, :W] if W and ctx.needs_input_grad[1] else None
        return dx, d_lead, None


def dot_interaction(x: torch.Tensor, lead: Optional[torch.Tensor] = None,
                    self_interaction: bool = False) -> torch.Tensor:
    return DotInteraction.apply(x, lead, self_interaction)


class PlainInteraction(torch.autograd.Function):
    """``interaction_fwd_plain`` with ``interaction_bwd_plain`` as its
    backward, on any device: the reference a model's forward through the
    kernels is held against, with the kernels' fmaf steps in their order."""

    @staticmethod
    def forward(ctx, x, self_interaction):
        ctx.save_for_backward(x)
        ctx.self_interaction = self_interaction
        return interaction_fwd_plain(x, self_interaction)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return interaction_bwd_plain(x, grad.contiguous(), ctx.self_interaction), None


def dot_interaction_plain(x: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    return PlainInteraction.apply(x, self_interaction)
