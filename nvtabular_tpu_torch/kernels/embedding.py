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

``range_gather_columns`` and ``range_scatter_grad`` are kernel K15d, the
lookup and its gradient in the sharded DLRM train step
(``nvtabular_tpu/parallel/train.py:39-81``): a rank's rows of C row-sharded
tables in one concatenated shard (``RowShard``), ids with ``jnp.take``'s
semantics on each whole padded table. ``ShardedEmbeddingFeatures`` wraps them
and K15d's bag (``kernels/embedding_bag.py``) with the model group's sum, as
``EmbeddingFeatures`` wraps K13a and the multihot bag K13c. Their kernels
are ``csrc/sharded_embedding.cu`` too.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import LAUNCHES, check, check_range_table, ptr, raise_on_error, stream_ptr, use_kernel, vec_width
from .build import library
from .embedding_bag import bag_counts, embedding_bag_bwd, embedding_bag_fwd, range_bag, range_bag_grad

LAUNCH_COLUMNS = 64  # csrc/embedding.cu kMaxCols: the columns of one launch (a call of more launches in chunks)

# ids, offsets, sizes, C, table, D, B, rows a launch, out, out row stride, vec, launches, stream
_GATHER_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
]
# table, rows_local, start, D, ids, n, out, vec, stream
_RANGE_GATHER_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
]
# ids, offsets, sizes, C, grad, grad row stride, D, B, rows a launch, dtable, vec, launches, stream
_SCATTER_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
]
# ids, offsets, sizes, starts, padded, C, table, D, B, model_rank, out, out row stride, vec, launches, stream
_RANGE_COLUMNS_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
]
# ids, offsets, sizes, starts, padded, C, grad, grad row stride, D, B, dtable, rows_local, vec, launches, stream
_RANGE_SCATTER_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
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


def c_columns(ids, offsets, sizes):
    k = len(ids)
    return (
        (ctypes.c_void_p * k)(*[v.data_ptr() for v in ids]),
        (ctypes.c_int64 * k)(*[int(o) for o in offsets]),
        (ctypes.c_int64 * k)(*[int(s) for s in sizes]),
    )


def launch_rows(B: int, C: int, D: int, vec: int) -> int:
    """The rows of one K13a launch over [B, C, D] in vectors of ``vec``
    floats: all B unless the flat index over a chunk of LAUNCH_COLUMNS
    columns (rows x columns x vectors a row) would pass int32; the kernel
    launches once for each chunk of columns and of these rows (at least
    one)."""
    per_row = min(C, LAUNCH_COLUMNS) * (D // vec)
    return max(1, min(B, (2**31 - 1) // max(per_row, 1)))


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
    if B == 0:
        return out
    fn = library("embedding").nvt_embedding_gather
    if fn.argtypes is None:
        fn.argtypes = _GATHER_ARGTYPES
        fn.restype = ctypes.c_int
    c_ids, c_offs, c_sizes = c_columns(ids, offsets, sizes)
    vec = vec_width(D, table, out)
    launched = ctypes.c_int(0)
    rc = fn(c_ids, c_offs, c_sizes, C, ptr(table), D, B, launch_rows(B, C, D, vec), ptr(out), out.stride(0), vec,
            ctypes.byref(launched), stream_ptr(table.device))
    raise_on_error(rc, "embedding_gather")
    LAUNCHES["embedding_gather"] += launched.value
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
    dtable = torch.zeros((num_rows, D), dtype=torch.float32, device=dev)
    if B == 0:
        return dtable
    fn = library("embedding").nvt_embedding_scatter_grad
    if fn.argtypes is None:
        fn.argtypes = _SCATTER_ARGTYPES
        fn.restype = ctypes.c_int
    c_ids, c_offs, c_sizes = c_columns(ids, offsets, sizes)
    vec = vec_width(D, grad, dtable)
    launched = ctypes.c_int(0)
    rc = fn(c_ids, c_offs, c_sizes, C, ptr(grad), grad.stride(0), D, B, launch_rows(B, C, D, vec), ptr(dtable), vec,
            ctypes.byref(launched), stream_ptr(dev))
    raise_on_error(rc, "embedding_scatter_grad")
    LAUNCHES["embedding_scatter_grad"] += launched.value
    return dtable


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
    rc = fn(ptr(table), table.shape[0], start, D, ptr(ids), n, ptr(out), vec_width(D, table, out),
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


@dataclass(frozen=True)
class RowShard:
    """A rank's rows of C row-sharded tables, concatenated in column order,
    and of M multihot tables, one tensor each.

    Column ``c`` holds the global rows ``[starts[c], starts[c] + sizes[c])``
    of its table of ``padded[c]`` rows, from row ``offsets[c]`` of the
    shard; multihot table ``k`` its rows from ``bag_starts[k]`` of its
    ``bag_padded[k]``. ``reduce`` sums a tensor over the model group in
    place (the group's ``all_reduce``); ``model_rank`` is this rank's index
    in it."""

    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    starts: Tuple[int, ...]
    padded: Tuple[int, ...]
    model_rank: int
    reduce: Callable[[torch.Tensor], torch.Tensor]
    bag_starts: Tuple[int, ...] = ()
    bag_padded: Tuple[int, ...] = ()

    def columns(self):
        return self.offsets, self.sizes, self.starts, self.padded


def _check_range_columns(num_rows: int, ids, offsets, sizes, starts, padded, dev) -> int:
    """Validates a shard's columns and their ids; returns the batch size B."""
    if not (len(ids) == len(offsets) == len(sizes) == len(starts) == len(padded)):
        raise ValueError(f"{len(ids)} id columns for {len(offsets)} offsets, {len(sizes)} sizes, "
                         f"{len(starts)} starts and {len(padded)} padded sizes")
    if not ids:
        raise ValueError("at least one id column is required")
    B = ids[0].shape[0] if ids[0].dim() == 1 else -1
    for c, (v, off, size, start, vp) in enumerate(zip(ids, offsets, sizes, starts, padded)):
        check(v, f"ids[{c}]", torch.int32, dev, (B,))
        if off < 0 or size < 0 or off + size > num_rows:
            raise ValueError(f"column {c}: shard rows [{off}, {off + size}) outside the shard's {num_rows}")
        if start < 0 or start + size > vp:
            raise ValueError(f"column {c}: global rows [{start}, {start + size}) outside its table's {vp}")
    return B


def _c_range_columns(ids, offsets, sizes, starts, padded):
    c_ids, c_offs, c_sizes = c_columns(ids, offsets, sizes)
    k = len(ids)
    return (c_ids, c_offs, c_sizes, (ctypes.c_int64 * k)(*[int(s) for s in starts]),
            (ctypes.c_int64 * k)(*[int(p) for p in padded]))


def range_gather_columns(
    table: torch.Tensor,
    ids: Sequence[torch.Tensor],
    offsets: Sequence[int],
    sizes: Sequence[int],
    starts: Sequence[int],
    padded: Sequence[int],
    model_rank: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K15d forward: ``out[b, c] = table[offsets[c] + id - starts[c]]`` for
    the ids (wrapped by ``padded[c]`` when negative) this rank holds, zeros
    for another rank's, NaN on model rank 0 (zeros elsewhere) for ids no
    rank holds → float32 [B, C, D]. ``out`` may be a view into a wider
    buffer (rows strided, each row's [C, D] block contiguous); it is
    allocated contiguous when not given."""
    if table.dim() != 2:
        raise ValueError(f"table must be [rows_local, D], got shape {tuple(table.shape)}")
    check(table, "table", torch.float32, table.device)
    B = _check_range_columns(table.shape[0], ids, offsets, sizes, starts, padded, table.device)
    C, D = len(ids), table.shape[1]
    if out is None:
        out = torch.empty((B, C, D), dtype=torch.float32, device=table.device)
    check_view(out, "out", (B, C, D), table.device)
    if not use_kernel(table):
        out.copy_(range_gather_columns_plain(table, ids, offsets, sizes, starts, padded, model_rank))
        return out
    if B == 0 or D == 0:
        return out
    fn = library("sharded_embedding").nvt_range_gather_columns
    if fn.argtypes is None:
        fn.argtypes = _RANGE_COLUMNS_ARGTYPES
        fn.restype = ctypes.c_int
    launched = ctypes.c_int(0)
    rc = fn(*_c_range_columns(ids, offsets, sizes, starts, padded), C, ptr(table), D, B, int(model_rank), ptr(out),
            out.stride(0), vec_width(D, table, out), ctypes.byref(launched), stream_ptr(table.device))
    raise_on_error(rc, "range_gather_columns")
    LAUNCHES["range_gather_columns"] += launched.value
    return out


def range_scatter_grad(
    grad: torch.Tensor,
    ids: Sequence[torch.Tensor],
    offsets: Sequence[int],
    sizes: Sequence[int],
    starts: Sequence[int],
    padded: Sequence[int],
    num_rows: int,
) -> torch.Tensor:
    """K15d backward, the transpose of ``range_gather_columns``: the dense
    float32 [num_rows, D] gradient of the shard from the gradient [B, C, D]
    of the gathered rows (a view whose rows may be strided, as
    ``embedding_scatter_grad`` takes it); only the ids this rank holds add."""
    if grad.dim() != 3:
        raise ValueError(f"grad must be [B, C, D], got shape {tuple(grad.shape)}")
    B, C, D = grad.shape
    dev = grad.device
    if _check_range_columns(num_rows, ids, offsets, sizes, starts, padded, dev) != B or len(ids) != C:
        raise ValueError(f"grad [{B}, {C}, {D}] does not match {len(ids)} id columns of {ids[0].shape[0]} ids")
    check_view(grad, "grad", (B, C, D), dev)
    if not use_kernel(grad):
        return range_scatter_grad_plain(grad, ids, offsets, sizes, starts, padded, num_rows)
    dtable = torch.empty((num_rows, D), dtype=torch.float32, device=dev)
    if D == 0:
        return dtable
    fn = library("sharded_embedding").nvt_range_scatter_grad
    if fn.argtypes is None:
        fn.argtypes = _RANGE_SCATTER_ARGTYPES
        fn.restype = ctypes.c_int
    launched = ctypes.c_int(0)
    rc = fn(*_c_range_columns(ids, offsets, sizes, starts, padded), C, ptr(grad), grad.stride(0), D, B, ptr(dtable),
            num_rows, vec_width(D, grad, dtable), ctypes.byref(launched), stream_ptr(dev))
    raise_on_error(rc, "range_scatter_grad")
    LAUNCHES["range_scatter_grad"] += launched.value
    return dtable


def shard_rows(ids, offsets, sizes, starts, padded) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int64 [B, C] rows of the shard, the [B, C] mask of the ids this rank
    holds and the [B, C] mask of the ids no rank holds, after jnp.take's
    wrap of negatives by the padded size."""
    idx = torch.stack([v.long() for v in ids], dim=1)

    def col(values):
        return torch.tensor(list(values), dtype=torch.int64, device=idx.device)

    vp = col(padded)
    idx = torch.where(idx < 0, idx + vp, idx)
    valid = (idx >= 0) & (idx < vp)
    local = idx - col(starts)
    mine = valid & (local >= 0) & (local < col(sizes))
    return torch.where(mine, local + col(offsets), 0), mine, ~valid


def range_gather_columns_plain(table, ids, offsets, sizes, starts, padded, model_rank) -> torch.Tensor:
    rows, mine, no_rank = shard_rows(ids, offsets, sizes, starts, padded)
    out = torch.where(mine[..., None], table[rows], 0.0)
    if model_rank == 0:
        out = torch.where(no_rank[..., None], float("nan"), out)
    return out


def range_scatter_grad_plain(grad, ids, offsets, sizes, starts, padded, num_rows) -> torch.Tensor:
    rows, mine, _ = shard_rows(ids, offsets, sizes, starts, padded)
    dtable = torch.zeros((num_rows, grad.shape[2]), dtype=torch.float32, device=grad.device)
    return dtable.index_add_(0, rows[mine], grad[mine])


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
    """``[lead, table rows of column 0, ..., column C-1, bag 0, ..., bag
    M-1]`` → float32 [B, (lead is not None) + C + M, D]: the gathered rows
    (kernel K13a) and the multihot bags (kernel K13c, ``"mean"``) written
    straight into their slots after an optional leading [B, D] feature
    (DLRM's bottom-MLP output), as the JAX forward's ``jnp.stack`` of its
    features. The backward hands the lead its slot of the gradient, the
    concatenated table the dense scatter-add and each bag's table its bag
    gradient, each read in place from its slot."""

    @staticmethod
    def forward(ctx, lead, table, offsets, sizes, num_ids, *args):
        ids, bags = args[:num_ids], args[num_ids:]
        B, D, L, C, M = ids[0].shape[0], table.shape[1], int(lead is not None), len(ids), len(bags) // 3
        feats = torch.empty((B, L + C + M, D), dtype=torch.float32, device=table.device)
        if lead is not None:
            feats[:, 0].copy_(lead)
        embedding_gather(table, ids, offsets, sizes, out=feats[:, L : L + C])
        for k in range(M):
            embedding_bag_fwd(*bags[3 * k : 3 * k + 3], "mean", out=feats[:, L + C + k])
        ctx.save_for_backward(*ids, *bags[1::3], *bags[2::3])
        ctx.meta = (L, C, M, tuple(offsets), tuple(sizes), table.shape[0], tuple(t.shape[0] for t in bags[::3]))
        return feats

    @staticmethod
    def backward(ctx, grad):
        L, C, M, offsets, sizes, num_rows, bag_rows = ctx.meta
        saved = ctx.saved_tensors
        ids, values, masks = saved[:C], saved[C : C + M], saved[C + M :]
        grad = grad.contiguous()
        d_lead = grad[:, 0] if L and ctx.needs_input_grad[0] else None
        d_table = None
        if ctx.needs_input_grad[1]:
            d_table = embedding_scatter_grad(grad[:, L : L + C], ids, offsets, sizes, num_rows)
        d_bags = []
        for k in range(M):
            wanted = ctx.needs_input_grad[5 + C + 3 * k]
            d_bags += [embedding_bag_bwd(grad[:, L + C + k], values[k], masks[k], bag_rows[k], "mean")
                       if wanted else None, None, None]
        return (d_lead, d_table, None, None, None) + (None,) * C + tuple(d_bags)


def embedding_features(lead, table, ids, offsets, sizes, bags=()) -> torch.Tensor:
    """``bags``: (table [V, D], int32 values [B, L], float32 mask [B, L]) of
    each multihot column, in feature order."""
    return EmbeddingFeatures.apply(lead, table, tuple(offsets), tuple(sizes), len(ids), *ids,
                                   *[t for bag in bags for t in bag])


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


class ShardedEmbeddingFeatures(torch.autograd.Function):
    """``[lead, the model group's rows of column 0, ..., column C-1, bag 0,
    ..., bag M-1]`` → float32 [b, 1 + C + M, D]: ``EmbeddingFeatures`` over
    row-sharded tables. K15d gathers this rank's rows and K15d's bag sums
    this rank's share of each bag into one contiguous [b, C + M, D] buffer,
    the shard's ``reduce`` sums it over the model group in place (one
    ``all_reduce`` a step: exactly one rank holds each row; model rank 0
    alone writes the NaN rows and bags), each bag is then divided by its
    count, max(sum(mask), 1), and the result lands in slots 1.. after the
    lead, which stays out of the sum.

    Every rank of the model group holds the same sum, so the sum's
    transpose is the identity: the backward scatter-adds the features'
    gradient into this rank's rows (K15d's backward and its bag's) with no
    collective, and hands the lead its slot."""

    @staticmethod
    def forward(ctx, lead, table, shard, num_ids, *args):
        ids, bags = args[:num_ids], args[num_ids:]
        B, D, C, M = lead.shape[0], table.shape[1], len(ids), len(bags) // 3
        emb = torch.empty((B, C + M, D), dtype=torch.float32, device=table.device)
        range_gather_columns(table, ids, *shard.columns(), shard.model_rank, out=emb[:, :C])
        for k in range(M):
            range_bag(*bags[3 * k : 3 * k + 3], shard.bag_starts[k], shard.bag_padded[k], shard.model_rank,
                      out=emb[:, C + k])
        shard.reduce(emb)
        for k in range(M):  # the mean after the model group's sum
            emb[:, C + k].div_(bag_counts(bags[3 * k + 2])[:, None])
        feats = torch.empty((B, 1 + C + M, D), dtype=torch.float32, device=table.device)
        feats[:, 0].copy_(lead)
        feats[:, 1:].copy_(emb)
        ctx.save_for_backward(*ids, *bags[1::3], *bags[2::3])
        ctx.meta = (shard, C, M, table.shape[0], tuple(t.shape[0] for t in bags[::3]))
        return feats

    @staticmethod
    def backward(ctx, grad):
        shard, C, M, num_rows, bag_rows = ctx.meta
        saved = ctx.saved_tensors
        ids, values, masks = saved[:C], saved[C : C + M], saved[C + M :]
        grad = grad.contiguous()
        d_lead = grad[:, 0] if ctx.needs_input_grad[0] else None
        d_table = None
        if ctx.needs_input_grad[1]:
            d_table = range_scatter_grad(grad[:, 1 : 1 + C], ids, *shard.columns(), num_rows)
        d_bags = []
        for k in range(M):
            wanted = ctx.needs_input_grad[4 + C + 3 * k]
            d_bags += [range_bag_grad(grad[:, 1 + C + k], values[k], masks[k], shard.bag_starts[k], bag_rows[k],
                                      shard.bag_padded[k], "mean") if wanted else None, None, None]
        return (d_lead, d_table, None, None) + (None,) * C + tuple(d_bags)


def sharded_embedding_features(lead, table, ids, shard: RowShard, bags=()) -> torch.Tensor:
    """``bags``: (this rank's rows of the table, int32 values [b, L], float32
    mask [b, L]) of each multihot column, in feature order."""
    return ShardedEmbeddingFeatures.apply(lead, table, shard, len(ids), *ids, *[t for bag in bags for t in bag])
