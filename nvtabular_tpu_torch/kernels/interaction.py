"""DLRM dot interaction and its gradient: CUDA kernel K13b, wrappers, plain versions.

For features ``x`` float32 [B, F, D], the interaction is the P = F (F - 1) / 2
dot products of distinct feature pairs in ``np.tril_indices(F, -1)`` order,
as ``nvtabular_tpu/models/layers.py:97-117`` computes them; with
``self_interaction`` the P = F (F + 1) / 2 pairs of ``np.tril_indices(F, 0)``,
each feature's dot with itself included (a mode of both kernels, counted
apart as ``interaction_self_fwd`` / ``_bwd``). The kernels are
``csrc/interaction.cu``. Where one stage of one sample passes SMEM_OPT_IN
(``fwd_plan`` and ``bwd_plan`` give 0 stages) both directions take their
streamed kernels, counted apart as ``interaction[_self]_{fwd,bwd}_streamed``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import LAUNCHES, check, check_rows, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

SMEM_OPT_IN = 227 * 1024  # the shared memory an H100 block can opt into
SMEM_SM, SMEM_RESERVED = 228 * 1024, 1024  # an H100 SM's shared memory; what each resident block reserves of it
SMEM_TWO_BLOCKS = SMEM_SM // 2 - SMEM_RESERVED  # a block's share where two fit an SM
SM_THREADS, SM_BLOCKS = 2048, 32  # an H100 SM's resident threads and blocks, at most
FWD_MIN_WARPS = 8  # the forward's resident warps an SM, below which one stage (more blocks) beats two
FWD_MAX_THREADS = 256  # csrc/interaction.cu kFwdMaxThreads
FWD_TILE = 4  # csrc/interaction.cu kFwdTile: a forward tile is 4 rows i x 4 rows j
BWD_THREADS = 256  # csrc/interaction.cu kBwdThreads
BWD_ROWS = 8  # csrc/interaction.cu kBwdRows: rows of a sample a backward thread sums
STREAMED = 0  # the stages of a plan that streams one sample through shared memory
STREAM_STAGES = 3  # csrc/interaction.cu kStreamStages: both streamed kernels' ring of chunks
SF_THREADS = 128  # kSfThreads: the streamed forward's block, one 8 x 8 tile of pairs a thread
SF_TILE = 8  # kSfTile
SF_ROWS = 120  # kSfRows: a row block, whose triangle is 120 tiles
SF_STRIP = 64  # kSfStrip: the columns of a strip below a row block (120 x 64 pairs: 120 tiles)
SF_COLS = 32  # kSfCols: columns d of a chunk
SB_STEPS = 16  # kSbSteps: steps j of a chunk
SB_ROWS = 64  # Sb::kRows: rows of a tile of dX, 8 a warp
SB_COLS = 256  # Sb::kCols: columns of a tile of dX, two float4 a lane

# x, B, F, D, G, threads, cols, stages, self_mode, out, out row stride, stream
_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int64,
                                                                          ctypes.c_void_p]
# x, g, g row stride, B, F, D, G, cols, stages, self_mode, dx, stream
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_void_p]
# x, B, F, D, cols, rows, stages, items, self_mode, out, out row stride, stream
_FWD_STREAM_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_int64, ctypes.c_int,
                                                                                ctypes.c_void_p, ctypes.c_int64,
                                                                                ctypes.c_void_p]
# x, g, g row stride, B, F, D, cols, stages, once, items, self_mode, dx, stream
_BWD_STREAM_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64] + [ctypes.c_int] * 5 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def num_pairs(f: int, self_interaction: bool = False) -> int:
    return f * (f + 1) // 2 if self_interaction else f * (f - 1) // 2


def _odd_slot(n: int) -> int:
    """csrc/interaction.cu odd_slot: n floats at a pad of up to 3, in an odd
    number of 16-byte units (floats)."""
    units = (n + 6) // 4
    return 4 * (units if units % 2 else units + 1)


def fwd_tiles(F: int) -> int:
    """Tiles of 4 x 4 rows in the triangle (diagonal tiles included)."""
    nb = -(-F // FWD_TILE)
    return nb * (nb + 1) // 2


def fwd_smem_bytes(F: int, D: int, G: int, self_interaction: bool, stages: int = 2) -> int:
    """The forward block's shared memory (csrc/interaction.cu
    fwd_stage_floats): `stages` stages of G samples' X slots (F * D floats)
    and output slots (P floats), each at a pad of up to 3 in an odd number of
    16-byte units, and the two 8-byte barriers."""
    per_sample = _odd_slot(F * D) + _odd_slot(num_pairs(F, self_interaction))
    return stages * G * per_sample * 4 + 16


def _stages(fits) -> int:
    """2 or 1 where a plan's stages fit, else STREAMED."""
    return 2 if fits(2) else 1 if fits(1) else STREAMED


def stream_fwd_items(F: int) -> int:
    """A sample's items in the streamed forward: row block I (SF_ROWS rows)
    is its diagonal item and ceil(120 I / 64) strips of SF_STRIP columns
    below it, each at most 120 tiles of 8 x 8 pairs (csrc/interaction.cu
    sf_items)."""
    return sum(1 + -(-SF_ROWS * I // SF_STRIP) for I in range(-(-F // SF_ROWS)))


def stream_fwd_plan(F: int):
    """(rows, stages, items) of the streamed forward: the rows of a stage
    (8 ceil(F / 8) where a sample is one diagonal item, F <= 120, else a
    row block's 120 and a strip's 64; SF_COLS columns each), STREAM_STAGES,
    and ``stream_fwd_items(F)`` items a sample. At phase 23's F = 120: 120
    rows (15,360 B a stage, 46,080 B the ring: four blocks an SM), one item
    a sample."""
    rows = SF_TILE * -(-F // SF_TILE) if F <= SF_ROWS else SF_ROWS + SF_STRIP
    return rows, STREAM_STAGES, stream_fwd_items(F)


def stream_fwd_smem_bytes(F: int) -> int:
    rows, stages, _ = stream_fwd_plan(F)
    return stages * rows * SF_COLS * 4


def _stream_bwd_smem(F: int, once: int) -> int:
    w, x = SB_STEPS * (SB_ROWS + 4), SB_STEPS * SB_COLS  # a chunk's weights (rows + 4 floats a step) and x_j columns
    return 4 * (-(-F // SB_STEPS) * w + STREAM_STAGES * x if once else STREAM_STAGES * (w + x))


def stream_bwd_plan(F: int, D: int):
    """(stages, once, items) of the streamed backward. A tile of a sample's
    dX is SB_ROWS x SB_COLS (a warp's lanes 8 rows x 8 columns each);
    STREAM_STAGES chunks of SB_STEPS steps j in the ring. ``once``: several
    column blocks, at least 3 chunks, and a row block's weights beside the
    ring within SMEM_TWO_BLOCKS (F <= 240): an item is a sample's row block,
    its column blocks in turn, its weights staged once (ceil(F / 64) items a
    sample: 2 at phase 23's [120, 1024]); else an item is a tile
    (ceil(F / 64) x ceil(D / 256))."""
    once = int(D > SB_COLS and -(-F // SB_STEPS) >= 3 and _stream_bwd_smem(F, 1) <= SMEM_TWO_BLOCKS)
    return STREAM_STAGES, once, -(-F // SB_ROWS) * (1 if once else -(-D // SB_COLS))


def stream_bwd_smem_bytes(F: int, D: int) -> int:
    """The ring of x_j's columns, and the weights: a row block's all chunks
    (once) or each stage's chunk."""
    _, once, _ = stream_bwd_plan(F, D)
    return _stream_bwd_smem(F, once)


def resident_warps(threads: int, smem: int) -> int:
    """Warps an SM holds of blocks of ``threads`` threads and ``smem`` bytes
    of shared memory (registers aside: the forward's stay within them)."""
    return min(SMEM_SM // (smem + SMEM_RESERVED), SM_THREADS // threads, SM_BLOCKS) * threads // 32


def fwd_plan(F: int, D: int, self_interaction: bool):
    """(G, threads, stages) of the forward: G the least power of two >= 8
    whose G * T tiles fill FWD_MAX_THREADS threads (16 at DLRM's [27, 16],
    T = 28), at most 256; halved while two stages pass SMEM_TWO_BLOCKS
    (down to 8) or SMEM_OPT_IN (down to 1); the block's threads G * T,
    rounded up to a warp, at most FWD_MAX_THREADS (a multiple of G). Two
    stages where they fit and leave an SM FWD_MIN_WARPS warps (16 at [27,
    16]), else one (phase 22's [4, 64]: 6 warps, not 3; on an H100 80GB
    HBM3 at 700 W, kernel_ab.py: 0.0397-0.0405 ms against 0.0437-0.0449,
    while one stage at [27, 16] takes 0.0985-0.0990 against 0.0909-0.0917).
    Where one stage of one sample passes SMEM_OPT_IN: (1, SF_THREADS,
    STREAMED), the streamed kernel (``stream_fwd_plan``)."""
    T = fwd_tiles(F)
    G = 8
    while G < 256 and G * T < FWD_MAX_THREADS:
        G *= 2
    while G > 8 and fwd_smem_bytes(F, D, G, self_interaction) > SMEM_TWO_BLOCKS:
        G //= 2
    while G > 1 and fwd_smem_bytes(F, D, G, self_interaction) > SMEM_OPT_IN:
        G //= 2
    threads = min(FWD_MAX_THREADS, -(-G * T // 32) * 32)

    def fits(st):
        smem = fwd_smem_bytes(F, D, G, self_interaction, st)
        return smem <= SMEM_OPT_IN and (st == 1 or resident_warps(threads, smem) >= FWD_MIN_WARPS)

    stages = _stages(fits)
    return (G, threads, stages) if stages != STREAMED else (1, SF_THREADS, STREAMED)


def columns(D: int, aligned: bool) -> int:
    """Columns of a row a thread reads at once in both kernels: 4 (float4
    reads) when D is a multiple of 4 and x is 16-byte aligned, else 1."""
    return 4 if aligned and D % 4 == 0 else 1


def bwd_smem_bytes(F: int, D: int, cols: int, G: int, self_interaction: bool, stages: int = 2) -> int:
    """The backward block's shared memory (csrc/interaction.cu
    bwd_stage_floats): `stages` stages of G samples' X and gradient slots,
    and the two 8-byte barriers. An X slot holds F * D floats at a pad of
    up to 3, in a number of 16-byte units equal to the row's column chunks
    mod 8; a gradient slot P + 1 floats at a pad of up to 3, in an odd
    number of 16-byte units."""
    chunks = D // cols
    x_units = (F * D + 6) // 4
    while (x_units - chunks) % 8:
        x_units += 1
    g_units = (num_pairs(F, self_interaction) + 7) // 4
    g_units += 1 - g_units % 2
    return stages * G * (x_units + g_units) * 16 + 16


def bwd_items(F: int, D: int, cols: int) -> int:
    """A sample's backward work items: BWD_ROWS rows x ``cols`` columns each."""
    return -(-F // BWD_ROWS) * (D // cols)


def bwd_plan(F: int, D: int, cols: int, self_interaction: bool):
    """(G, stages) of the backward. A thread takes one item of a group:
    G = BWD_THREADS // items a sample (16 at DLRM's [27, 16]), less where
    two stages would not fit SMEM_OPT_IN; where a sample's items pass
    BWD_THREADS, G = 1 and a thread takes several (the kernel's direct
    path). Two stages where they fit SMEM_OPT_IN, else one; (1, STREAMED)
    where one stage of one sample does not fit: the streamed kernel
    (``stream_bwd_plan``)."""
    G = max(1, BWD_THREADS // bwd_items(F, D, cols))
    while G > 1 and bwd_smem_bytes(F, D, cols, G, self_interaction) > SMEM_OPT_IN:
        G -= 1
    return G, _stages(lambda st: bwd_smem_bytes(F, D, cols, G, self_interaction, st) <= SMEM_OPT_IN)


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
    G, threads, stages = fwd_plan(F, D, self_interaction)
    name = "interaction_self_fwd" if self_interaction else "interaction_fwd"
    if stages == STREAMED:
        name += "_streamed"
        fn = library("interaction").nvt_interaction_fwd_stream
        if fn.argtypes is None:
            fn.argtypes = _FWD_STREAM_ARGTYPES
            fn.restype = ctypes.c_int
        rows, st, items = stream_fwd_plan(F)
        rc = fn(ptr(x), B, F, D, columns(D, x.data_ptr() % 16 == 0), rows, st, items, int(self_interaction),
                ptr(out), out.stride(0), stream_ptr(x.device))
    else:
        fn = library("interaction").nvt_interaction_fwd
        if fn.argtypes is None:
            fn.argtypes = _FWD_ARGTYPES
            fn.restype = ctypes.c_int
        rc = fn(ptr(x), B, F, D, G, threads, columns(D, x.data_ptr() % 16 == 0), stages, int(self_interaction),
                ptr(out), out.stride(0), stream_ptr(x.device))
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
    cols = columns(D, x.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0)
    G, stages = bwd_plan(F, D, cols, self_interaction)
    name = "interaction_self_bwd" if self_interaction else "interaction_bwd"
    if stages == STREAMED:
        name += "_streamed"
        fn = library("interaction").nvt_interaction_bwd_stream
        if fn.argtypes is None:
            fn.argtypes = _BWD_STREAM_ARGTYPES
            fn.restype = ctypes.c_int
        st, once, items = stream_bwd_plan(F, D)
        rc = fn(ptr(x), ptr(grad), grad.stride(0), B, F, D, cols, st, once, items, int(self_interaction), ptr(dx),
                stream_ptr(x.device))
    else:
        fn = library("interaction").nvt_interaction_bwd
        if fn.argtypes is None:
            fn.argtypes = _BWD_ARGTYPES
            fn.restype = ctypes.c_int
        rc = fn(ptr(x), ptr(grad), grad.stride(0), B, F, D, G, cols, stages, int(self_interaction), ptr(dx),
                stream_ptr(x.device))
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
    matrix (2 g_ii on its diagonal in the self mode, 0 in the strict one).
    Then the reference's rule at non-finite x (its autograd's dense products
    take every zero weight): NaN wherever another row's x[b, j, d] is not
    finite; the strict mode's zero diagonal has made it NaN already where
    x[b, i, d] itself is not."""
    B, F, D = x.shape
    rows, cols = (torch.from_numpy(a).to(x.device) for a in np.tril_indices(F, k=0 if self_interaction else -1))
    w = torch.zeros((B, F, F), dtype=x.dtype, device=x.device)
    w[:, rows, cols] = grad
    w = w + w.transpose(1, 2)
    dx = torch.zeros_like(x)
    for j in range(F):
        dx = _fma(w[:, :, j, None], x[:, None, j, :], dx)
    bad = ~torch.isfinite(x)
    others = bad.sum(1, keepdim=True) - bad.to(torch.int64) > 0
    return dx.masked_fill(others, float("nan"))


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
