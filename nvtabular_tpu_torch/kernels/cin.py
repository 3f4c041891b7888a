"""The xDeepFM CIN layer and its gradient: CUDA kernel K13d, wrappers, plain versions.

``cin_fwd(x_k, x_0, w)`` is ``nvtabular_tpu/models/layers.py:120-141``
(``xdeepfm_outer_product``): for x_k [B, Hk, D] and x_0 [B, F, D] of one
dtype T (float32, bfloat16 or float16) and w [Hk * F, Hn] in T or float32,

    out[b, h, d] = sum_{i, j} w[i * F + j, h] * x_k[b, i, d] * x_0[b, j, d]

→ T [B, Hn, D], the pair index i-major as the reference's reshape has it.
The kernel builds the outer product tile by tile in shared memory and
never stores it; ``cin_bwd`` gives dx_k, dx_0 (in T) and dw (in w's
dtype), dw's reduction over B * D inside the kernel. ``CIN`` wires both
through autograd; x_k and x_0 may be one tensor (CIN's first layer), and
autograd then sums the two gradients. The kernels are ``csrc/cin.cu``.

In 16 bits the layer rounds where the reference's casts round: each
product z = x_k * x_0 to T, the float32 sum over pairs to T; in the
backward, dz = sum_h w g (g widened to float32) to T, each product dz * x_0
and dz * x_k to T before dx_k's and dx_0's float32 sums, which are
rounded to T, and dw's float32 sum to w's dtype. In float32 every round
is the identity.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

SMEM_OPT_IN = 227 * 1024  # the H100's shared memory a block can opt into
FWD_COLS, FWD_DEPTH = 64, 16  # csrc/cin.cu kFwdCols, kFwdDepth
BX_COLS, BX_ROWS, BX_DEPTH, BX_CHUNK = 64, 256, 32, 128  # csrc/cin.cu kBxCols, kBxRows, kBxDepth, kBxChunk
BX_WORK_BYTES = BX_ROWS * BX_COLS * 4  # csrc/cin.cu kBxWorkBytes: the w tiles' room, then a pass's products
# csrc/cin.cu with_types: the element types of x_k, x_0, g and the outputs,
# and of w and dw (T or float32); the launch counts' key suffix of each T
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
COUNT_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16", torch.float16: "_f16"}

# x_k, x_0, w, B, Hk, F, D, Hn, ci, cj, dtype, w dtype, out, stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
# x_k, x_0, w, g, B, Hk, F, D, Hn, jr, xk_rows, dtype, w dtype, dx_k, dx_0, dw, dx_k's and dw's float32 sums, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 6


def pass_rows(Hn: int) -> int:
    """Rows h of a forward or dw pass (csrc/cin.cu fwd_rows): 8 for each 8
    of Hn, at most 256 (the block's threads)."""
    return 8 * min(32, -(-Hn // 8))


def fwd_smem_bytes(rows: int, ci: int, cj: int, es: int = 4, ws: int = 4) -> int:
    """csrc/cin.cu fwd_smem: the columns' offsets, ci rows of x_k and cj of
    x_0 (64 columns each, ``es`` bytes an element), two buffers of w tiles
    (``ws`` bytes an element) and of float32 z tiles."""
    return 3 * FWD_COLS * 8 + (ci + cj) * FWD_COLS * es + 2 * FWD_DEPTH * rows * ws + 2 * FWD_DEPTH * FWD_COLS * 4


def fwd_plan(Hk: int, F: int, Hn: int, es: int = 4, ws: int = 4):
    """(rows, ci, cj): the forward stages all Hk + F rows where they fit
    SMEM_OPT_IN, else x_k in chunks of ci rows beside x_0 (all F rows where
    F leaves room for 16 rows of x_k, else halves of what fits). ``es`` and
    ``ws``: the bytes of an element of x and of w (a 16-bit row takes half
    the room, so more rows fit)."""
    rows = pass_rows(Hn)
    if fwd_smem_bytes(rows, Hk, F, es, ws) <= SMEM_OPT_IN:
        return rows, Hk, F
    room = (SMEM_OPT_IN - fwd_smem_bytes(rows, 0, 0, es, ws)) // (FWD_COLS * es)  # rows of x a block holds
    cj = F if F + 16 <= room else room // 2
    return rows, min(Hk, room - cj), cj


def bwd_x_plan(F: int, es: int = 4):
    """(jr, xk_rows, smem) of cin_bwd_x (csrc/cin.cu bx_layout): x_0 in n =
    ceil(F / BX_CHUNK) chunks of jr = ceil(F / n) rows, a pass's 256 pairs
    spanning at most xk_rows rows of x_k in the narrowest chunk; ``es`` the
    bytes of an element of x and g (their staged rows and tiles)."""
    n = -(-F // BX_CHUNK)
    jr = -(-F // n)
    narrowest = F - (n - 1) * jr
    xk_rows = -(-(BX_ROWS - 1) // narrowest) + 1
    smem = (3 * BX_COLS * 8 + 3 * BX_ROWS * 4 + BX_WORK_BYTES + 2 * BX_DEPTH * BX_COLS * es + jr * BX_COLS * 4
            + (jr + xk_rows) * BX_COLS * es)
    return jr, xk_rows, smem


def _check(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor):
    """Validates the layer's inputs; returns (B, Hk, F, D, Hn)."""
    if x_k.dim() != 3 or x_0.dim() != 3 or w.dim() != 2:
        raise ValueError(f"expected x_k [B, Hk, D], x_0 [B, F, D] and w [Hk * F, Hn], got shapes "
                         f"{tuple(x_k.shape)}, {tuple(x_0.shape)}, {tuple(w.shape)}")
    if x_k.dtype not in DTYPES or x_0.dtype != x_k.dtype or w.dtype not in (x_k.dtype, torch.float32):
        raise TypeError(
            "xdeepfm_outer_product takes x_k and x_0 of one dtype of float32, bfloat16 and float16, and w in "
            f"theirs or float32; got {x_k.dtype}, {x_0.dtype} and {w.dtype}"
        )
    B, Hk, D = x_k.shape
    F = x_0.shape[1]
    dev = x_k.device
    check(x_0, "x_0", x_k.dtype, dev, (B, F, D))
    check(x_k, "x_k", x_k.dtype, dev)
    if w.shape[0] != Hk * F:
        raise ValueError(f"w must have Hk * F = {Hk * F} rows, got {w.shape[0]}")
    check(w, "w", w.dtype, dev)
    if use_kernel(x_k) and min(Hk, F, D, w.shape[1]) < 1:
        raise ValueError(f"the CIN kernels take Hk, F, D and Hn >= 1, got {Hk}, {F}, {D}, {w.shape[1]}")
    return B, Hk, F, D, w.shape[1]


def cin_fwd(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """→ [B, Hn, D] in x_k's dtype."""
    B, Hk, F, D, Hn = _check(x_k, x_0, w)
    if not use_kernel(x_k):
        return cin_fwd_plain(x_k, x_0, w)
    lib = library("cin")
    if lib.nvt_cin_fwd.argtypes is None:
        lib.nvt_cin_fwd.argtypes = _FWD_ARGTYPES
        lib.nvt_cin_fwd.restype = ctypes.c_int
    out = torch.empty((B, Hn, D), dtype=x_k.dtype, device=x_k.device)
    if B == 0:
        return out
    _, ci, cj = fwd_plan(Hk, F, Hn, x_k.element_size(), w.element_size())
    rc = lib.nvt_cin_fwd(ptr(x_k), ptr(x_0), ptr(w), B, Hk, F, D, Hn, ci, cj, DTYPES[x_k.dtype], DTYPES[w.dtype],
                         ptr(out), stream_ptr(x_k.device))
    raise_on_error(rc, "cin_fwd")
    LAUNCHES["cin_fwd" + COUNT_SUFFIX[x_k.dtype]] += 1
    return out


def cin_bwd(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor, grad: torch.Tensor):
    """The gradients of ``cin_fwd`` at (x_k, x_0, w) for the output gradient
    ``grad`` [B, Hn, D] in x_k's dtype → (dx_k, dx_0, dw) in the dtypes of
    x_k, x_0 and w. A 16-bit dx_k or dw is summed in a float32 scratch and
    rounded into its output by one more launch."""
    B, Hk, F, D, Hn = _check(x_k, x_0, w)
    check(grad, "grad", x_k.dtype, x_k.device, (B, Hn, D))
    if not use_kernel(x_k):
        return cin_bwd_plain(x_k, x_0, w, grad)
    lib = library("cin")
    if lib.nvt_cin_bwd.argtypes is None:
        lib.nvt_cin_bwd.argtypes = _BWD_ARGTYPES
        lib.nvt_cin_bwd.restype = ctypes.c_int
    dx_k, dx_0 = torch.empty_like(x_k), torch.empty_like(x_0)
    dw = torch.empty_like(w)
    dx_k_acc = None if x_k.dtype == torch.float32 else torch.empty(x_k.shape, device=x_k.device)
    dw_acc = None if w.dtype == torch.float32 else torch.empty(w.shape, device=w.device)
    jr, xk_rows, _ = bwd_x_plan(F, x_k.element_size())
    rc = lib.nvt_cin_bwd(ptr(x_k), ptr(x_0), ptr(w), ptr(grad), B, Hk, F, D, Hn, jr, xk_rows, DTYPES[x_k.dtype],
                         DTYPES[w.dtype], ptr(dx_k), ptr(dx_0), ptr(dw), ptr(dx_k_acc), ptr(dw_acc),
                         stream_ptr(x_k.device))
    raise_on_error(rc, "cin_bwd")
    LAUNCHES["cin_bwd" + COUNT_SUFFIX[x_k.dtype]] += 1
    return dx_k, dx_0, dw


def outer_product_plain(x_k: torch.Tensor, x_0: torch.Tensor) -> torch.Tensor:
    """z [B, Hk * F, D], pair index i-major (layers.py:133-135)."""
    B, Hk, D = x_k.shape
    return (x_k[:, :, None, :] * x_0[:, None, :, :]).reshape(B, Hk * x_0.shape[1], D)


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 ``t`` rounded to ``dtype`` and widened again (``t`` itself for float32)."""
    return t.to(dtype).float()


def cin_fwd_plain(x_k, x_0, w) -> torch.Tensor:
    """The products of the widened inputs (exact for 16-bit values), each
    rounded to x_k's dtype, summed in float32 and rounded again."""
    T = x_k.dtype
    z = _rounded(outer_product_plain(x_k.float(), x_0.float()), T)
    return torch.matmul(w.float().t(), z).to(T)  # [B, Hn, D]


def cin_bwd_plain(x_k, x_0, w, grad):
    """dz = sum_h w g in float32, rounded to T; each product dz * x_0 and
    dz * x_k rounded to T, summed in float32 and rounded to T; dw = sum_{b,
    d} g z in float32, rounded to w's dtype."""
    T = x_k.dtype
    B, Hk, D = x_k.shape
    F = x_0.shape[1]
    xk, x0, g = x_k.float(), x_0.float(), grad.float()
    z = _rounded(outer_product_plain(xk, x0), T)  # [B, K, D]
    dz = _rounded(torch.matmul(w.float(), g), T).view(B, Hk, F, D)
    dx_k = _rounded(dz * x0[:, None], T).sum(dim=2).to(T)
    dx_0 = _rounded(dz * xk[:, :, None], T).sum(dim=1).to(T)
    dw = torch.einsum("bkd,bhd->kh", z, g).to(w.dtype)
    return dx_k, dx_0, dw


class CIN(torch.autograd.Function):
    """``cin_fwd`` with ``cin_bwd`` as its backward; ``plain``: their plain
    versions, on any device (the reference a kernel path is held against)."""

    @staticmethod
    def forward(ctx, x_k, x_0, w, plain):
        ctx.save_for_backward(x_k, x_0, w)
        ctx.plain = plain
        return (cin_fwd_plain if plain else cin_fwd)(x_k, x_0, w)

    @staticmethod
    def backward(ctx, grad):
        x_k, x_0, w = ctx.saved_tensors
        return (*(cin_bwd_plain if ctx.plain else cin_bwd)(x_k, x_0, w, grad.contiguous()), None)


def cin(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor, plain: bool = False) -> torch.Tensor:
    return CIN.apply(x_k, x_0, w, plain)
