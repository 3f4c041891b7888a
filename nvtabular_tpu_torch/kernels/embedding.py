"""Embedding gather and its gradient: CUDA kernel K13a, wrappers, plain versions.

The embedding tables of a model live in one concatenated float32
``[sum V, D]`` tensor; column ``c`` owns rows ``offsets[c]`` to
``offsets[c] + sizes[c]``. Ids are int32 ``[B]`` tensors, one per column, and
follow ``jnp.take``'s defaults (``nvtabular_tpu/models/layers.py:70-72``): a
negative id wraps once, an id still out of range reads a NaN row and its
gradient is dropped. The kernels are ``csrc/embedding.cu``.

``embedding_range_gather`` is the per-rank half of the row-sharded lookup
(kernel K15b, ``nvtabular_tpu/parallel/embeddings.py:40-50``): a rank's rows
``[start, start + rows_local)`` of a table, global ids, and zeros for the rows
another rank holds. Its kernel is ``csrc/sharded_embedding.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

MAX_COLUMNS = 64  # csrc/embedding.cu kMaxCols

_GATHER_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_void_p,
]
# table, rows_local, start, D, ids, n, out, vec, stream
_RANGE_GATHER_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]
_SCATTER_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p,
]


def _check_columns(table: torch.Tensor, ids: Sequence[torch.Tensor], offsets, sizes) -> int:
    """Validates the table and ids; returns the batch size B."""
    dev = table.device
    if table.dim() != 2:
        raise ValueError(f"table must be [rows, D], got shape {tuple(table.shape)}")
    check(table, "table", torch.float32, dev)
    if not (len(ids) == len(offsets) == len(sizes)):
        raise ValueError(f"{len(ids)} id columns, {len(offsets)} offsets and {len(sizes)} sizes")
    if not ids:
        raise ValueError("at least one id column is required")
    B = ids[0].shape[0] if ids[0].dim() == 1 else -1
    for c, (v, off, size) in enumerate(zip(ids, offsets, sizes)):
        check(v, f"ids[{c}]", torch.int32, dev, (B,))
        if off < 0 or size < 0 or off + size > table.shape[0]:
            raise ValueError(f"column {c}: rows [{off}, {off + size}) outside the table's {table.shape[0]}")
    return B


def check_view(t: torch.Tensor, what: str, shape: Tuple[int, ...], device) -> None:
    """A float32 [B, C, D] view whose rows may be strided (slots of a wider
    buffer) but whose [C, D] block is contiguous."""
    if t.dtype != torch.float32 or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected float32 {tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if shape[0] and (t.stride(2) != 1 or t.stride(1) != shape[2]):
        raise ValueError(f"{what}: the [C, D] block of each row must be contiguous, strides {t.stride()}")


def _vec(D: int, *tensors: torch.Tensor) -> int:
    """4 (float4 accesses) when D and every row start are 16-byte aligned."""
    aligned = all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 for t in tensors)
    return 4 if D % 4 == 0 and aligned else 1


def c_columns(ids, offsets, sizes):
    k = len(ids)
    return (
        (ctypes.c_void_p * k)(*[v.data_ptr() for v in ids]),
        (ctypes.c_int64 * k)(*[int(o) for o in offsets]),
        (ctypes.c_int64 * k)(*[int(s) for s in sizes]),
    )


def _check_kernel_limits(B: int, C: int, D: int) -> None:
    if C > MAX_COLUMNS:
        raise ValueError(f"the embedding kernels take at most {MAX_COLUMNS} columns, got {C}")
    if B * C * D >= 2**31:
        raise ValueError(f"[{B}, {C}, {D}] exceeds the embedding kernels' int32 index")


def embedding_gather(
    table: torch.Tensor,
    ids: Sequence[torch.Tensor],
    offsets: Sequence[int],
    sizes: Sequence[int],
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[b, c] = table[offsets[c] + ids[c][b]]`` → float32 [B, C, D].
    ``out`` may be a view into a wider buffer (rows strided, each row's
    [C, D] block contiguous); it is allocated when not given."""
    B = _check_columns(table, ids, offsets, sizes)
    C, D = len(ids), table.shape[1]
    if out is None:
        out = torch.empty((B, C, D), dtype=torch.float32, device=table.device)
    check_view(out, "out", (B, C, D), table.device)
    if not use_kernel(table):
        out.copy_(embedding_gather_plain(table, ids, offsets, sizes))
        return out
    _check_kernel_limits(B, C, D)
    if B == 0:
        return out
    fn = library("embedding").nvt_embedding_gather
    if fn.argtypes is None:
        fn.argtypes = _GATHER_ARGTYPES
        fn.restype = ctypes.c_int
    c_ids, c_offs, c_sizes = c_columns(ids, offsets, sizes)
    rc = fn(c_ids, c_offs, c_sizes, C, ptr(table), D, B, ptr(out), out.stride(0),
            _vec(D, table, out), stream_ptr(table.device))
    raise_on_error(rc, "embedding_gather")
    LAUNCHES["embedding_gather"] += 1
    return out


def embedding_scatter_grad(
    grad: torch.Tensor,
    ids: Sequence[torch.Tensor],
    offsets: Sequence[int],
    sizes: Sequence[int],
    num_rows: int,
) -> torch.Tensor:
    """The transpose of ``embedding_gather``: the dense float32
    [num_rows, D] gradient of the table, given the gradient [B, C, D] of the
    gathered rows (a view, as ``out`` above)."""
    if grad.dim() != 3:
        raise ValueError(f"grad must be [B, C, D], got shape {tuple(grad.shape)}")
    B, C, D = grad.shape
    dev = grad.device
    if not (len(ids) == len(offsets) == len(sizes) == C):
        raise ValueError(f"grad has {C} columns; {len(ids)} id columns, {len(offsets)} offsets, {len(sizes)} sizes")
    for c, (v, off, size) in enumerate(zip(ids, offsets, sizes)):
        check(v, f"ids[{c}]", torch.int32, dev, (B,))
        if off < 0 or size < 0 or off + size > num_rows:
            raise ValueError(f"column {c}: rows [{off}, {off + size}) outside the table's {num_rows}")
    check_view(grad, "grad", (B, C, D), dev)
    if not use_kernel(grad):
        return embedding_scatter_grad_plain(grad, ids, offsets, sizes, num_rows)
    _check_kernel_limits(B, C, D)
    dtable = torch.zeros((num_rows, D), dtype=torch.float32, device=dev)
    if B == 0:
        return dtable
    fn = library("embedding").nvt_embedding_scatter_grad
    if fn.argtypes is None:
        fn.argtypes = _SCATTER_ARGTYPES
        fn.restype = ctypes.c_int
    c_ids, c_offs, c_sizes = c_columns(ids, offsets, sizes)
    rc = fn(c_ids, c_offs, c_sizes, C, ptr(grad), grad.stride(0), D, B, ptr(dtable),
            _vec(D, grad, dtable), stream_ptr(dev))
    raise_on_error(rc, "embedding_scatter_grad")
    LAUNCHES["embedding_scatter_grad"] += 1
    return dtable


def check_range_table(table: torch.Tensor, start: int) -> None:
    """A rank's rows of a row-sharded table: float32 [rows_local >= 1, D]."""
    if table.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"table must be [rows_local >= 1, D], got shape {tuple(table.shape)}")
    check(table, "table", torch.float32, table.device)
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start}")


def embedding_range_gather(table: torch.Tensor, ids: torch.Tensor, start: int) -> torch.Tensor:
    """``out[i] = table[ids[i] - start]`` where that row is one of the
    table's, zeros elsewhere → float32 [n, D]."""
    check_range_table(table, start)
    if ids.dim() != 1:
        raise ValueError(f"ids must be 1-d, got shape {tuple(ids.shape)}")
    check(ids, "ids", torch.int32, table.device)
    if not use_kernel(table):
        return embedding_range_gather_plain(table, ids, start)
    n, D = ids.shape[0], table.shape[1]
    out = torch.empty((n, D), dtype=torch.float32, device=table.device)
    if n == 0 or D == 0:
        return out
    fn = library("sharded_embedding").nvt_range_gather
    if fn.argtypes is None:
        fn.argtypes = _RANGE_GATHER_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(table), table.shape[0], start, D, ptr(ids), n, ptr(out), _vec(D, table, out),
            stream_ptr(table.device))
    raise_on_error(rc, "embedding_range_gather")
    LAUNCHES["embedding_range_gather"] += 1
    return out


def embedding_range_gather_plain(table, ids, start) -> torch.Tensor:
    """embeddings.py:40-50 before the psum."""
    local = ids.long() - start
    in_range = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(in_range[:, None], rows, 0.0)


def table_rows(ids, offsets, sizes) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 [B, C] rows of the concatenated table and the [B, C] mask of
    ids inside their column's table, after jnp.take's wrap of negatives."""
    idx = torch.stack([v.long() for v in ids], dim=1)
    size = torch.tensor(list(sizes), dtype=torch.int64, device=idx.device)
    idx = torch.where(idx < 0, idx + size, idx)
    valid = (idx >= 0) & (idx < size)
    offs = torch.tensor(list(offsets), dtype=torch.int64, device=idx.device)
    return torch.where(valid, idx + offs, 0), valid


def embedding_gather_plain(table, ids, offsets, sizes) -> torch.Tensor:
    rows, valid = table_rows(ids, offsets, sizes)
    return torch.where(valid[..., None], table[rows], float("nan"))


def embedding_scatter_grad_plain(grad, ids, offsets, sizes, num_rows) -> torch.Tensor:
    rows, valid = table_rows(ids, offsets, sizes)
    dtable = torch.zeros((num_rows, grad.shape[2]), dtype=torch.float32, device=grad.device)
    return dtable.index_add_(0, rows[valid], grad[valid])


class EmbeddingFeatures(torch.autograd.Function):
    """``[lead, table rows of column 0, ..., column C-1]`` → float32
    [B, (lead is not None) + C, D]: the gathered rows written straight after
    an optional leading [B, D] feature (DLRM's bottom-MLP output), as the
    JAX forward's ``jnp.stack`` of its features. The backward hands the
    lead its slice of the gradient and the table the dense scatter-add."""

    @staticmethod
    def forward(ctx, lead, table, offsets, sizes, *ids):
        B, D = ids[0].shape[0], table.shape[1]
        L = 0 if lead is None else 1
        feats = torch.empty((B, L + len(ids), D), dtype=torch.float32, device=table.device)
        if lead is not None:
            feats[:, 0].copy_(lead)
        embedding_gather(table, ids, offsets, sizes, out=feats[:, L:])
        ctx.save_for_backward(*ids)
        ctx.meta = (L, tuple(offsets), tuple(sizes), table.shape[0])
        return feats

    @staticmethod
    def backward(ctx, grad):
        L, offsets, sizes, num_rows = ctx.meta
        ids = ctx.saved_tensors
        grad = grad.contiguous()
        d_lead = grad[:, 0] if L and ctx.needs_input_grad[0] else None
        d_table = None
        if ctx.needs_input_grad[1]:
            d_table = embedding_scatter_grad(grad[:, L:], ids, offsets, sizes, num_rows)
        return (d_lead, d_table, None, None) + (None,) * len(ids)


def embedding_features(lead, table, ids, offsets, sizes) -> torch.Tensor:
    return EmbeddingFeatures.apply(lead, table, tuple(offsets), tuple(sizes), *ids)


class EmbeddingRow(torch.autograd.Function):
    """``[table rows of column 0, ..., column C-1, trail]`` → float32
    [B, C*D + W]: each row's gathered fields flattened into its first C*D
    columns, then an optional trailing [B, W] block (the dense features),
    as DeepFM's and DCN's ``jnp.concatenate`` of their features
    (nvtabular_tpu/models/deepfm.py:71, :123). The gather writes into the
    buffer through its [B, C, D] view (row stride C*D + W); the backward
    hands the table the scatter-add of the same view of the gradient and the
    trail its slice."""

    @staticmethod
    def forward(ctx, trail, table, offsets, sizes, *ids):
        B, C, D = ids[0].shape[0], len(ids), table.shape[1]
        W = 0 if trail is None else trail.shape[1]
        x = torch.empty((B, C * D + W), dtype=torch.float32, device=table.device)
        embedding_gather(table, ids, offsets, sizes, out=x[:, : C * D].unflatten(1, (C, D)))
        if W:
            x[:, C * D :].copy_(trail)
        ctx.save_for_backward(*ids)
        ctx.meta = (D, tuple(offsets), tuple(sizes), table.shape[0])
        return x

    @staticmethod
    def backward(ctx, grad):
        D, offsets, sizes, num_rows = ctx.meta
        ids = ctx.saved_tensors
        CD = len(ids) * D
        grad = grad.contiguous()
        d_trail = grad[:, CD:] if ctx.needs_input_grad[0] else None
        d_table = None
        if ctx.needs_input_grad[1]:
            d_table = embedding_scatter_grad(grad[:, :CD].unflatten(1, (len(ids), D)), ids, offsets, sizes, num_rows)
        return (d_trail, d_table, None, None) + (None,) * len(ids)


def embedding_row(table, ids, offsets, sizes, trail=None) -> torch.Tensor:
    return EmbeddingRow.apply(trail, table, tuple(offsets), tuple(sizes), *ids)
