"""The MLP layer epilogue's gradient and the compute-dtype rounds: CUDA
kernel K19, wrappers, host plans, plain versions and the rounds' autograd
function ``MLP`` and ``CrossNetwork`` go through.

``nvtabular_tpu/models/layers.py:56-66`` (``mlp_apply``) casts its input
and each weight to ``compute_dtype``, adds the bias to each float32
product, applies ReLU and casts each hidden layer to ``compute_dtype``;
DCN's cross layers cast ``x`` and ``W`` the same way
(``nvtabular_tpu/models/deepfm.py:126-131``). XLA fuses all of it into the
products' operands and epilogues; the products are kernel K21
(``kernels/mlp_mm.py``), whose store runs the forward epilogue. Here:

* ``mlp_epilogue_fwd_plain(y, b, relu, round_dtype)``: the forward
  epilogue's plain version, in place over the product ``y`` [B, N]:
  ``round_c(relu(y + b))`` where ``round_c`` is the round trip through
  ``round_dtype`` (None: no round), and the mask ``z > 0`` of the
  pre-activation where ReLU applies. ``jax.nn.relu``'s edges: -0.0 gives
  +0.0, NaN gives NaN. K21's fused store is held against it.
* ``mlp_epilogue_bwd(g, mask, relu, round_dtype)``: ``dz = mask ? round_c(g)
  : 0`` (a cast's transpose rounds the gradient that flows back through
  it; ReLU's is ``jax.nn.relu``'s select, so a NaN pre-activation takes no
  gradient and an infinite ``g`` stays out of masked elements) and ``db``,
  the column sums of ``dz``, in a fixed order: the same bits from run to
  run.
* ``round_group(tensors, dtype)``: each tensor rounded to ``dtype`` and
  back, a group of them in one launch (K18's plan, ``adagrad_plan``), a
  2-D view with strided rows read as it lies.

``RoundGroup`` is the round's autograd function (K21's ``MLPProduct``
runs the epilogue's backward); with ``plain=True`` it runs the plain
version on any device (the reference forwards that the kernels are held
against on the card).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import LAUNCHES, check, check_rows, ptr, raise_on_error, stream_ptr, tickets, use_kernel, vec_width
from .adagrad import adagrad_plan
from .build import library

THREADS = 256  # csrc/mlp_epilogue.cu kThreads: a block's threads
WARP = 32
# blocks a launch aims at across its column tiles: 8 resident blocks of 256
# threads on each of an H100's 132 SMs (a constant, so that db's partial
# sums, and so its bits, depend on B and N alone)
TARGET_BLOCKS = 1056
MAX_ROW_BLOCKS = 65535  # gridDim.y's limit
ROUND_KINDS = {None: 0, torch.bfloat16: 1, torch.float16: 2}  # csrc/mlp_epilogue.cu round_c

# g, g row stride, mask, dz, partial, tickets, db, B, N, mode, vec, tx, col tiles, row blocks, stream
_BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int]
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# src, dst, n, cols, row stride, start, segments, round kind, stream
_ROUND_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def epilogue_plan(B: int, N: int, vec: int) -> Tuple[int, int, int]:
    """The launch of an epilogue over [B, N] with ``vec`` floats a thread
    (4 where N and every row start are 16-byte aligned, else 1): ``(tx,
    col_tiles, row_blocks)``. A block's THREADS threads are ``tx`` across a
    tile of ``tx * vec`` columns (tx the power of two that covers N / vec,
    at most a warp) by ``THREADS / tx`` rows; blockIdx.x is the column tile,
    and the ``row_blocks`` blocks of a tile take its steps of ``THREADS /
    tx`` rows in turn (block y the steps y, y + row_blocks, ...), about
    TARGET_BLOCKS blocks in all."""
    if B < 0 or N < 1 or vec not in (1, 4) or N % vec:
        raise ValueError(f"no epilogue plan for [{B}, {N}] with {vec} floats a thread")
    groups = -(-N // vec)
    tx = min(WARP, 1 << (groups - 1).bit_length())
    col_tiles = -(-N // (tx * vec))
    steps = -(-B // (THREADS // tx))
    row_blocks = max(1, min(steps, -(-TARGET_BLOCKS // col_tiles), MAX_ROW_BLOCKS))
    return tx, col_tiles, row_blocks


def _mode(relu: bool, round_dtype: Optional[torch.dtype]) -> int:
    if round_dtype not in ROUND_KINDS:
        raise NotImplementedError(f"no round to {round_dtype}: bfloat16, float16 or None")
    return int(bool(relu)) | ROUND_KINDS[round_dtype] << 1


def _round(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype).to(torch.float32)


def mlp_epilogue_bwd(g: torch.Tensor, mask: Optional[torch.Tensor], relu: bool,
                     round_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of the forward epilogue for the output gradient ``g``
    [B, N] (rows may be strided, each row's floats contiguous) → (dz, db):
    dz = mask ? round_c(g) : 0 (``g`` itself with neither ReLU nor round),
    db its column sums."""
    if g.dim() != 2:
        raise ValueError(f"g must be [B, N], got shape {tuple(g.shape)}")
    B, N = g.shape
    check_rows(g, "g", (B, N), g.device)
    check(mask, "mask", torch.bool, g.device, (B, N), optional=not relu)
    mode = _mode(relu, round_dtype)
    if not use_kernel(g):
        return mlp_epilogue_bwd_plain(g, mask, relu, round_dtype)
    dev = g.device
    dz = g if mode == 0 else torch.empty((B, N), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return dz, torch.zeros(N, dtype=torch.float32, device=dev)
    vec = vec_width(N, g, dz, *([mask] if relu else []))
    tx, col_tiles, row_blocks = epilogue_plan(B, N, vec)
    db = torch.empty(N, dtype=torch.float32, device=dev)
    partial = torch.empty((row_blocks, N), dtype=torch.float32, device=dev)
    fn = library("mlp_epilogue").nvt_mlp_epilogue_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    stream = stream_ptr(dev)
    rc = fn(ptr(g), g.stride(0), ptr(mask), ptr(None if mode == 0 else dz), ptr(partial),
            ptr(tickets(dev, stream, col_tiles)), ptr(db), B, N, mode, vec, tx, col_tiles, row_blocks, stream)
    raise_on_error(rc, "mlp_epilogue_bwd")
    LAUNCHES["mlp_epilogue_bwd"] += 1
    return dz, db


def mlp_epilogue_fwd_plain(y: torch.Tensor, b: torch.Tensor, relu: bool, round_dtype: Optional[torch.dtype] = None,
                           ) -> Optional[torch.Tensor]:
    y.add_(b)
    mask = None
    if relu:
        mask = y > 0
        y.masked_fill_(y <= 0, 0.0)  # +0.0 for -0.0; NaN stays
    if round_dtype is not None:
        y.copy_(_round(y, round_dtype))
    return mask


def mlp_epilogue_bwd_plain(g: torch.Tensor, mask: Optional[torch.Tensor], relu: bool,
                           round_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    dz = _round(g, round_dtype)
    if relu:
        dz = torch.where(mask, dz, 0.0)
    return dz, dz.sum(dim=0)


def _segment(t: torch.Tensor) -> Tuple[int, int]:
    """(cols, row stride) of a 2-D view whose rows are strided, else (0, 0)."""
    if t.is_contiguous():
        return 0, 0
    if t.dim() == 2 and (t.shape[1] == 1 or t.stride(1) == 1) and t.stride(0) >= t.shape[1]:
        return t.shape[1], t.stride(0)
    raise ValueError(f"round_group takes contiguous tensors or 2-D views with contiguous rows, got strides "
                     f"{t.stride()} for shape {tuple(t.shape)}")


def round_group(tensors: Sequence[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """Each float32 tensor rounded to ``dtype`` (bfloat16 or float16) and
    back to float32, as new contiguous tensors: one launch for up to
    MAX_SEGMENTS nonempty tensors (``adagrad_plan``'s units of 4 floats)."""
    tensors = list(tensors)
    if dtype not in (torch.bfloat16, torch.float16):
        raise NotImplementedError(f"no round to {dtype}: bfloat16 or float16")
    if not tensors:
        return []
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"tensors[{i}]: expected float32 on {dev}, got {t.dtype} on {t.device}")
    views = [_segment(t) for t in tensors]
    if not use_kernel(tensors[0]):
        return round_group_plain(tensors, dtype)
    outs = [torch.empty(t.shape, dtype=torch.float32, device=dev) for t in tensors]
    fn = library("mlp_epilogue").nvt_round_group
    if fn.argtypes is None:
        fn.argtypes = _ROUND_ARGTYPES
        fn.restype = ctypes.c_int
    stream = stream_ptr(dev)
    for idx, start in adagrad_plan([t.numel() for t in tensors]):
        k = len(idx)
        src = (ctypes.c_void_p * k)(*[tensors[i].data_ptr() for i in idx])
        dst = (ctypes.c_void_p * k)(*[outs[i].data_ptr() for i in idx])
        lengths = (ctypes.c_int64 * k)(*[tensors[i].numel() for i in idx])
        cols = (ctypes.c_int64 * k)(*[views[i][0] for i in idx])
        strides = (ctypes.c_int64 * k)(*[views[i][1] for i in idx])
        rc = fn(src, dst, lengths, cols, strides, (ctypes.c_uint64 * (k + 1))(*start), k, ROUND_KINDS[dtype], stream)
        raise_on_error(rc, "round_group")
        LAUNCHES["round_group"] += 1
    return outs


def round_group_plain(tensors: Sequence[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    return [_round(t, dtype).contiguous() for t in tensors]


class RoundGroup(torch.autograd.Function):
    """(t_1, .., t_k) → each rounded to ``dtype`` and back; the backward
    rounds the gradients that arrive, one launch for all of them. An output
    whose input needs no gradient is marked non-differentiable, so no
    gradient is computed for it."""

    @staticmethod
    def forward(ctx, dtype, plain, *tensors):
        ctx.set_materialize_grads(False)
        ctx.dtype, ctx.plain = dtype, plain
        outs = (round_group_plain if plain else round_group)(tensors, dtype)
        frozen = [o for o, need in zip(outs, ctx.needs_input_grad[2:]) if not need]
        if frozen:
            ctx.mark_non_differentiable(*frozen)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        live = [i for i, (g, need) in enumerate(zip(grads, ctx.needs_input_grad[2:])) if need and g is not None]
        rounded = (round_group_plain if ctx.plain else round_group)([grads[i] for i in live], ctx.dtype)
        out = [None] * len(grads)
        for i, r in zip(live, rounded):
            out[i] = r
        return (None, None, *out)


def round_tensors(tensors: Sequence[torch.Tensor], dtype: torch.dtype, plain: bool = False) -> List[torch.Tensor]:
    """``tensors`` as ``RoundGroup`` rounds them; float32 compute rounds
    nothing and launches nothing."""
    if dtype == torch.float32:
        return list(tensors)
    return list(RoundGroup.apply(dtype, plain, *tensors))


__all__ = ["RoundGroup", "epilogue_plan", "mlp_epilogue_bwd", "mlp_epilogue_bwd_plain", "mlp_epilogue_fwd_plain",
           "round_group", "round_group_plain", "round_tensors"]
