"""Multihot embedding bag and its gradient: CUDA kernel K13c, wrappers, plain versions.

``embedding_bag_fwd(table, values, mask, combiner)`` is
``nvtabular_tpu/models/layers.py:75-94`` (``multihot_embedding_lookup``):
the masked sum of a row's table entries, divided by ``max(sum(mask), 1)``
for ``"mean"``, over DeviceLoader's padded ``values`` int32 [B, L] and
``mask`` float32 [B, L]. Ids follow ``jnp.take``'s defaults as K13a's do: a
negative id wraps once, an id still out of range reads a NaN row (and NaN
times a 0 mask is NaN) and its gradient is dropped. The kernels are
``csrc/embedding_bag.cu``.

``embedding_range_bag`` is the per-rank half of the row-sharded bag (kernel
K15b, ``nvtabular_tpu/parallel/embeddings.py:73-81``): the weighted sums over
a rank's rows ``[start, start + rows_local)`` of a table, with global ids and
weights ``mask * in_range``. Its kernel is ``csrc/sharded_embedding.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import LAUNCHES, check, check_rows, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library
from .embedding import _vec  # float4 accesses where rows are 16-byte aligned
from .embedding import check_range_table

COMBINERS = ("mean", "sum")

_FWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
]
# table, rows_local, start, D, values, mask, B, L, out, vec, stream
_RANGE_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]
_BWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]


def _check_bag(values: torch.Tensor, mask: torch.Tensor, combiner: str, device) -> Tuple[int, int]:
    """Validates the padded ids and mask; returns (B, L)."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    if values.dim() != 2:
        raise ValueError(f"values must be [B, L], got shape {tuple(values.shape)}")
    check(values, "values", torch.int32, device)
    check(mask, "mask", torch.float32, device, tuple(values.shape))
    return values.shape


def _check_limits(B: int, L: int, D: int) -> None:
    if B * L * D >= 2**31:
        raise ValueError(f"[{B}, {L}, {D}] exceeds the embedding bag kernels' int32 index")


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
    _check_limits(B, L, D)
    if B == 0 or D == 0:
        return out
    fn = library("embedding_bag").nvt_embedding_bag_fwd
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(table), V, D, ptr(values), ptr(mask), B, L, int(combiner == "mean"), ptr(out), out.stride(0),
            _vec(D, table, out), stream_ptr(table.device))
    raise_on_error(rc, "embedding_bag_fwd")
    LAUNCHES["embedding_bag_fwd"] += 1
    return out


def embedding_bag_bwd(grad: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, num_rows: int,
                      combiner: str = "mean") -> torch.Tensor:
    """The transpose of ``embedding_bag_fwd``: the dense float32 [num_rows, D]
    gradient of the table, given the gradient [B, D] of the bags (a view, as
    ``out`` above)."""
    if grad.dim() != 2:
        raise ValueError(f"grad must be [B, D], got shape {tuple(grad.shape)}")
    B, L = _check_bag(values, mask, combiner, grad.device)
    D = grad.shape[1]
    check_rows(grad, "grad", (B, D), grad.device)
    if not use_kernel(grad):
        return embedding_bag_bwd_plain(grad, values, mask, num_rows, combiner)
    _check_limits(B, L, D)
    dtable = torch.zeros((num_rows, D), dtype=torch.float32, device=grad.device)
    if B == 0 or L == 0 or D == 0 or num_rows == 0:
        return dtable
    fn = library("embedding_bag").nvt_embedding_bag_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(grad), grad.stride(0), ptr(values), ptr(mask), B, L, D, num_rows, int(combiner == "mean"),
            ptr(dtable), _vec(D, grad, dtable), stream_ptr(grad.device))
    raise_on_error(rc, "embedding_bag_bwd")
    LAUNCHES["embedding_bag_bwd"] += 1
    return dtable


def embedding_range_bag(table: torch.Tensor, values: torch.Tensor, mask: torch.Tensor, start: int) -> torch.Tensor:
    """→ float32 [B, D]: ``sum_l table[clip(values - start)] * (mask *
    in_range)``, summed in l order; a row outside the table's range weighs
    zero."""
    check_range_table(table, start)
    B, L = _check_bag(values, mask, "sum", table.device)
    if not use_kernel(table):
        return embedding_range_bag_plain(table, values, mask, start)
    D = table.shape[1]
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B == 0 or D == 0:
        return out
    fn = library("sharded_embedding").nvt_range_bag
    if fn.argtypes is None:
        fn.argtypes = _RANGE_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(table), table.shape[0], start, D, ptr(values), ptr(mask), B, L, ptr(out), _vec(D, table, out),
            stream_ptr(table.device))
    raise_on_error(rc, "embedding_range_bag")
    LAUNCHES["embedding_range_bag"] += 1
    return out


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


def _counts(mask: torch.Tensor) -> torch.Tensor:
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
    return s / _counts(mask)[:, None] if combiner == "mean" else s


def embedding_bag_bwd_plain(grad, values, mask, num_rows, combiner="mean") -> torch.Tensor:
    rows, valid = bag_rows(values, num_rows)
    scaled = grad / _counts(mask)[:, None] if combiner == "mean" else grad
    terms = scaled[:, None, :] * mask[..., None]  # [B, L, D]
    dtable = torch.zeros((num_rows, grad.shape[1]), dtype=torch.float32, device=grad.device)
    return dtable.index_add_(0, rows[valid], terms[valid])


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
