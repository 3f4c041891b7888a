"""Multihot embedding bag and its gradient: CUDA kernel K13c, wrappers, plain versions.

``embedding_bag_fwd(table, values, mask, combiner)`` is
``nvtabular_tpu/models/layers.py:75-94`` (``multihot_embedding_lookup``):
the masked sum of a row's table entries, divided by ``max(sum(mask), 1)``
for ``"mean"``, over DeviceLoader's padded ``values`` int32 [B, L] and
``mask`` float32 [B, L]. Ids follow ``jnp.take``'s defaults as K13a's do: a
negative id wraps once, an id still out of range reads a NaN row (and NaN
times a 0 mask is NaN) and its gradient is dropped. The forward's kernel
is ``csrc/embedding_bag.cu``; the backward is ``range_bag_grad``'s kernel
on the whole table.

``embedding_range_bag`` is the per-rank half of the row-sharded bag (kernel
K15b, ``nvtabular_tpu/parallel/embeddings.py:73-81``): the weighted sums over
a rank's rows ``[start, start + rows_local)`` of a table, with global ids and
weights ``mask * in_range`` (the zero rule: an id no rank holds reads
zeros). ``range_bag`` is the same kernel in take mode, the forward of K15d's
bag in the sharded DLRM step: ids follow ``jnp.take`` on the whole padded
table, and an id no rank holds makes its bag NaN on model rank 0 only.
``range_bag_grad`` is its transpose for either rule, this rank's rows of the
table's gradient (no collective). Their kernels are
``csrc/sharded_embedding.cu``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import LAUNCHES, check, check_range_table, check_rows, ptr, raise_on_error, stream_ptr, use_kernel, vec_width
from .build import library

COMBINERS = ("mean", "sum")

# table, V, D, values, mask, B, L, mean, rows a launch, out, out row stride, vec, launches, stream
_FWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
]
# table, rows_local, start, D, values, mask, B, L, take, padded, write_nan, out, out row stride, vec, tile bags,
# stream
_RANGE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
# grad, grad row stride, values, mask, B, L, D, start, rows_local, padded, wrap, mean, dtable, vec, S, blocks,
# stream
_RANGE_GRAD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
SMEM_OPT_IN = 227 * 1024  # the shared memory an H100 block can opt into
SMEM_PER_SM = 228 * 1024  # an H100 SM's, 1 KB of it reserved a block
BAG_GRAD_THREADS = 512  # csrc/sharded_embedding.cu kBagThreads
H100_SMS = 132


def bag_grad_plan(B: int, D: int, rows_local: int, vec: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(S, blocks) of range_bag_grad's shared path, or (0, 0) for its global
    path. A bag takes S lanes (the least power of two >= D / vec, at most
    32) and each group of S lanes a private copy of the [rows_local, D]
    gradient: a block of BAG_GRAD_THREADS needs BAG_GRAD_THREADS / S copies
    within SMEM_OPT_IN. The grid is as many blocks as ``sms`` SMs hold at
    once, by threads and by shared memory, at most one a group of bags."""
    S = 1
    while S < min(D // vec, 32):
        S *= 2
    groups = BAG_GRAD_THREADS // S
    smem = groups * rows_local * D * 4
    if smem > SMEM_OPT_IN:
        return 0, 0
    per_sm = min(2048 // BAG_GRAD_THREADS, SMEM_PER_SM // (smem + 1024))
    return S, max(1, min(sms * per_sm, -(-B // groups)))


BAG_TILE_IDS = 2048  # csrc/sharded_embedding.cu kBagTileIds: the ids a range_bag tile decides at once
BAG_STAGE_FLOATS = 4096  # csrc/sharded_embedding.cu kBagStageFloats: the largest shard range_bag stages
BAG_THREADS = 256  # csrc/sharded_embedding.cu kThreads: range_bag's block
BAG_TILE_SUMS = 1024  # the (bag, vector) sums a range_bag tile aims at: 4 a thread


def bag_fwd_plan(L: int, D: int, rows_local: int, vec: int) -> int:
    """The bags of a tile of the range bag's kernel (``range_bag``,
    ``embedding_range_bag``), or 0 for a thread a vector. Tiles stage the
    shard in shared memory, so they need its rows_local x D floats within
    BAG_STAGE_FLOATS and a tile's ids within BAG_TILE_IDS; a tile holds
    enough bags for BAG_TILE_SUMS sums of ``vec`` floats, rounded down to a
    whole number of the block's passes (BAG_THREADS // (D // vec) bags) where
    one fits, so that every thread takes as many sums."""
    if rows_local * D > BAG_STAGE_FLOATS or L > BAG_TILE_IDS:
        return 0
    per_row = max(D // vec, 1)
    bags = -(-BAG_TILE_SUMS // per_row)
    if L:
        bags = min(bags, BAG_TILE_IDS // L)
    a_pass = BAG_THREADS // per_row
    if a_pass and bags >= a_pass:
        bags -= bags % a_pass
    return max(bags, 1)


def _check_bag(values: torch.Tensor, mask: torch.Tensor, combiner: str, device) -> Tuple[int, int]:
    """Validates the padded ids and mask; returns (B, L)."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    if values.dim() != 2:
        raise ValueError(f"values must be [B, L], got shape {tuple(values.shape)}")
    check(values, "values", torch.int32, device)
    check(mask, "mask", torch.float32, device, tuple(values.shape))
    return values.shape


def fwd_rows(B: int, D: int, vec: int) -> int:
    """The rows of one K13c forward launch over B bags of D floats in
    vectors of ``vec``: all B unless the flat index (rows x vectors a row)
    would pass int32; the kernel launches once for each chunk of these rows
    (at least one)."""
    return max(1, min(B, (2**31 - 1) // max(D // vec, 1)))


def _check_bag_grad(grad: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                    combiner: str) -> Tuple[int, int, int]:
    """Validates a bag gradient [B, D] (rows may be strided) and its ids;
    returns (B, L, D)."""
    if grad.dim() != 2:
        raise ValueError(f"grad must be [B, D], got shape {tuple(grad.shape)}")
    B, L = _check_bag(values, mask, combiner, grad.device)
    D = grad.shape[1]
    check_rows(grad, "grad", (B, D), grad.device)
    return B, L, D


def embedding_bag_fwd(table: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, combiner: str = "mean",
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """→ float32 [B, D]. ``out`` may be a view into a wider buffer (rows
    strided, each row contiguous); it is allocated when not given."""
    if table.dim() != 2:
        raise ValueError(f"table must be [V, D], got shape {tuple(table.shape)}")
    check(table, "table", torch.float32, table.device)
    B, L = _check_bag(values, mask, combiner, table.device)
    V, D = table.shape
    if out is None:
        out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    check_rows(out, "out", (B, D), table.device)
    if not use_kernel(table):
        out.copy_(embedding_bag_fwd_plain(table, values, mask, combiner))
        return out
    if B == 0 or D == 0:
        return out
    fn = library("embedding_bag").nvt_embedding_bag_fwd
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    vec = vec_width(D, table, out)
    launched = ctypes.c_int(0)
    rc = fn(ptr(table), V, D, ptr(values), ptr(mask), B, L, int(combiner == "mean"), fwd_rows(B, D, vec), ptr(out),
            out.stride(0), vec, ctypes.byref(launched), stream_ptr(table.device))
    raise_on_error(rc, "embedding_bag_fwd")
    LAUNCHES["embedding_bag_fwd"] += launched.value
    return out


def embedding_bag_bwd(grad: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, num_rows: int,
                      combiner: str = "mean") -> torch.Tensor:
    """The transpose of ``embedding_bag_fwd``: the dense float32 [num_rows, D]
    gradient of the table, given the gradient [B, D] of the bags (a view, as
    ``out`` above). It is ``range_bag_grad``'s kernel on the whole table
    (rows ``[0, num_rows)``, negatives wrapped by ``num_rows``), counted as
    ``embedding_bag_bwd``."""
    B, L, D = _check_bag_grad(grad, values, mask, combiner)
    if not use_kernel(grad):
        return range_bag_grad_plain(grad, values, mask, 0, num_rows, num_rows, combiner)
    if B == 0 or L == 0 or D == 0 or num_rows == 0:
        return torch.zeros((num_rows, D), dtype=torch.float32, device=grad.device)
    return _launch_range_bag_grad("embedding_bag_bwd", grad, values, mask, 0, num_rows, num_rows, combiner, True)


def _launch_range_bag(name, table, values, mask, start, take, padded, write_nan, out) -> None:
    B, L = values.shape
    D = table.shape[1]
    if B == 0 or D == 0:
        return
    fn = library("sharded_embedding").nvt_range_bag
    if fn.argtypes is None:
        fn.argtypes = _RANGE_ARGTYPES
        fn.restype = ctypes.c_int
    vec = vec_width(D, table, out)
    rc = fn(ptr(table), table.shape[0], start, D, ptr(values), ptr(mask), B, L, int(take), padded, int(write_nan),
            ptr(out), out.stride(0), vec, bag_fwd_plan(L, D, table.shape[0], vec), stream_ptr(table.device))
    raise_on_error(rc, name)
    LAUNCHES[name] += 1


def embedding_range_bag(table: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, start: int) -> torch.Tensor:
    """→ float32 [B, D]: ``sum_l table[clip(values - start)] * (mask *
    in_range)``, summed in l order; a row outside the table's range weighs
    zero."""
    check_range_table(table, start)
    B, L = _check_bag(values, mask, "sum", table.device)
    if not use_kernel(table):
        return embedding_range_bag_plain(table, values, mask, start)
    out = torch.empty((B, table.shape[1]), dtype=torch.float32, device=table.device)
    _launch_range_bag("embedding_range_bag", table, values, mask, start, False, 0, False, out)
    return out


def _check_shard(rows: int, start: int, padded: int) -> None:
    if start < 0 or rows < 0 or start + rows > padded:
        raise ValueError(f"shard rows [{start}, {start + rows}) outside the padded table's {padded}")


def range_bag(table: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, start: int, padded: int,
              model_rank: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15d bag forward → float32 [B, D]: ``sum_l table[id - start] *
    mask`` over the ids (negatives wrapped by ``padded``) this rank holds,
    summed in l order; on model rank 0 a NaN bag where an id lies outside
    ``[-padded, padded)``, masked or not. ``table`` is this rank's rows
    ``[start, start + rows_local)`` of the padded table. ``out`` may be a
    view into a wider buffer (rows strided, each row contiguous)."""
    check_range_table(table, start)
    _check_shard(table.shape[0], start, padded)
    B, L = _check_bag(values, mask, "sum", table.device)
    if out is None:
        out = torch.empty((B, table.shape[1]), dtype=torch.float32, device=table.device)
    check_rows(out, "out", (B, table.shape[1]), table.device)
    if not use_kernel(table):
        out.copy_(range_bag_plain(table, values, mask, start, padded, model_rank))
        return out
    _launch_range_bag("range_bag", table, values, mask, start, True, padded, model_rank == 0, out)
    return out


def range_bag_grad(grad: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, start: int, rows_local: int,
                   padded: int, combiner: str = "mean", wrap: bool = True) -> torch.Tensor:
    """The transpose of this rank's part of the sharded bag: the dense
    float32 [rows_local, D] gradient of its rows ``[start, start +
    rows_local)``, given the gradient [B, D] of the pooled bags (a view, rows
    strided): ``(g[b] / count[b]) * mask[b, l]`` added at ``id - start`` for
    each id it holds (``count`` = max(sum(mask), 1) for ``"mean"``, 1 for
    ``"sum"``). ``wrap`` wraps negatives by ``padded`` (``range_bag``'s
    take rule); without it (``embedding_range_bag``'s zero rule) they are
    no row's. Ids outside the table add nothing."""
    _check_bag_grad(grad, values, mask, combiner)
    _check_shard(rows_local, start, padded)
    if not use_kernel(grad):
        return range_bag_grad_plain(grad, values, mask, start, rows_local, padded, combiner, wrap)
    return _launch_range_bag_grad("range_bag_grad", grad, values, mask, start, rows_local, padded, combiner, wrap)


def _launch_range_bag_grad(name, grad, values, mask, start, rows_local, padded, combiner, wrap) -> torch.Tensor:
    B, L = values.shape
    D = grad.shape[1]
    dtable = torch.empty((rows_local, D), dtype=torch.float32, device=grad.device)
    if D == 0:
        return dtable
    vec = vec_width(D, grad, dtable)
    S, blocks = bag_grad_plan(B, D, rows_local, vec, _sm_count(grad.device))
    fn = library("sharded_embedding").nvt_range_bag_grad
    if fn.argtypes is None:
        fn.argtypes = _RANGE_GRAD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(grad), grad.stride(0), ptr(values), ptr(mask), B, L, D, start, rows_local, padded, int(wrap),
            int(combiner == "mean"), ptr(dtable), vec, S, blocks, stream_ptr(grad.device))
    raise_on_error(rc, name)
    LAUNCHES[name] += 1
    return dtable


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bag_shard_rows(values: torch.Tensor, start: int, rows_local: int, padded: int, wrap: bool = True):
    """int64 [B, L] rows of the shard (0 where not held), the [B, L] mask of
    the ids this rank holds and the [B, L] mask of the ids no rank holds
    (outside ``[0, padded)`` after the wrap of negatives, when ``wrap``)."""
    idx = values.long()
    if wrap:
        idx = torch.where(idx < 0, idx + padded, idx)
    valid = (idx >= 0) & (idx < padded)
    local = idx - start
    mine = valid & (local >= 0) & (local < rows_local)
    return torch.where(mine, local, 0), mine, ~valid


def range_bag_plain(table, values, mask, start, padded, model_rank) -> torch.Tensor:
    rows, mine, no_rank = bag_shard_rows(values, start, table.shape[0], padded)
    emb = table[rows]  # [B, L, D]
    s = torch.zeros((values.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    for l in range(values.shape[1]):  # in l order; another rank's ids add nothing
        s = s + torch.where(mine[:, l, None], emb[:, l] * mask[:, l, None], 0.0)
    if model_rank == 0:
        s = torch.where(no_rank.any(dim=1)[:, None], float("nan"), s)
    return s


def range_bag_grad_plain(grad, values, mask, start, rows_local, padded, combiner="mean", wrap=True) -> torch.Tensor:
    rows, mine, _ = bag_shard_rows(values, start, rows_local, padded, wrap)
    scaled = grad / bag_counts(mask)[:, None] if combiner == "mean" else grad
    terms = scaled[:, None, :] * mask[..., None]  # [B, L, D]
    dtable = torch.zeros((rows_local, grad.shape[1]), dtype=torch.float32, device=grad.device)
    return dtable.index_add_(0, rows[mine], terms[mine])


def embedding_range_bag_plain(table, values, mask, start) -> torch.Tensor:
    """embeddings.py:73-81 before the psum, summed in l order."""
    local = values.long() - start
    in_range = (local >= 0) & (local < table.shape[0])
    emb = table[local.clamp(0, table.shape[0] - 1)]  # [B, L, D]
    w = mask * in_range.to(mask.dtype)
    s = torch.zeros((values.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    for l in range(values.shape[1]):
        s = s + emb[:, l] * w[:, l, None]
    return s


def bag_rows(values: torch.Tensor, num_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 [B, L] table rows (0 where out of range) and the [B, L] mask of
    ids inside the table, after jnp.take's wrap of negatives."""
    idx = values.long()
    idx = torch.where(idx < 0, idx + num_rows, idx)
    valid = (idx >= 0) & (idx < num_rows)
    return torch.where(valid, idx, 0), valid


def bag_counts(mask: torch.Tensor) -> torch.Tensor:
    """max(sum_l mask, 1), summed in l order as the kernel sums it."""
    cnt = torch.zeros(mask.shape[0], dtype=torch.float32, device=mask.device)
    for l in range(mask.shape[1]):
        cnt = cnt + mask[:, l]
    return cnt.clamp(min=1.0)


def embedding_bag_fwd_plain(table, values, mask, combiner="mean") -> torch.Tensor:
    rows, valid = bag_rows(values, table.shape[0])
    emb = torch.where(valid[..., None], table[rows], float("nan")) if table.shape[0] else torch.full(
        (*values.shape, table.shape[1]), float("nan"), device=table.device)
    s = torch.zeros((values.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    for l in range(values.shape[1]):  # in l order, one rounding per product and per sum
        s = s + emb[:, l] * mask[:, l, None]
    return s / bag_counts(mask)[:, None] if combiner == "mean" else s


class EmbeddingBag(torch.autograd.Function):
    """``embedding_bag_fwd`` with ``embedding_bag_bwd`` as its backward
    (the gradient flows to the table only)."""

    @staticmethod
    def forward(ctx, table, values, mask, combiner):
        ctx.save_for_backward(values, mask)
        ctx.meta = (table.shape[0], combiner)
        return embedding_bag_fwd(table, values, mask, combiner)

    @staticmethod
    def backward(ctx, grad):
        values, mask = ctx.saved_tensors
        num_rows, combiner = ctx.meta
        d_table = embedding_bag_bwd(grad.contiguous(), values, mask, num_rows, combiner) if ctx.needs_input_grad[0] else None
        return d_table, None, None, None


def embedding_bag(table, values, mask, combiner: str = "mean") -> torch.Tensor:
    return EmbeddingBag.apply(table, values, mask, combiner)
