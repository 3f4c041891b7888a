"""Row-sharded embedding lookups over the mesh.

Counterpart of ``nvtabular_tpu/parallel/embeddings.py:22-87``. Each rank of
the ``model`` axis holds a contiguous row range of a [V, D] table (model
shard ``m`` of ``M`` holds rows ``[m * V / M, (m + 1) * V / M)``; see
``convert.load_sharded_table``) and each rank of the ``data`` axis a shard of
the ids. Kernel K15b gathers (or bags) the local rows for every id, zeros
for the rows another rank holds, and one ``all_reduce`` over the model
axis's group assembles the embeddings: exactly one rank owns each row.

Both are differentiable in ``table``, the transpose of the JAX
``shard_map``: each rank scatter-adds the output's gradient of the ids it
holds into its rows (K15d's backward with one column; K15d's bag backward,
``range_bag_grad``, with the zero rule), and no collective runs, since the
summed output is the same on every rank of the model axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.embedding import embedding_range_gather, range_scatter_grad
from ..kernels.embedding_bag import COMBINERS, embedding_range_bag, range_bag_grad
from .mesh import all_reduce, mesh_device


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)


def _local(table, mesh, model_axis: str):
    device = table.device if isinstance(table, torch.Tensor) else mesh_device(mesh)
    table = _tensor(table, torch.float32, device)
    return table, mesh.get_local_rank(model_axis) * table.shape[0]


class _RangeLookup(torch.autograd.Function):
    """The lookup summed over the model group; the backward scatter-adds the
    gradient of the ids in ``[start, start + rows_local)`` into the rows."""

    @staticmethod
    def forward(ctx, table, ids, start, group):
        ctx.save_for_backward(ids)
        ctx.meta = (start, table.shape[0], group.size())
        return all_reduce(embedding_range_gather(table, ids, start), group)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        start, rows, model_size = ctx.meta
        padded = rows * model_size
        # the shard_map reads zeros for every id outside [0, V): no wrap of negatives
        ids = ids.masked_fill(ids < 0, padded)
        d_table = range_scatter_grad(grad.contiguous()[:, None], [ids], [0], [rows], [start], [padded], rows)
        return d_table, None, None, None


def sharded_embedding_lookup(table, indices, mesh, model_axis: str = "model", data_axis: str = "data"):
    """``table``: this rank's rows of the [V, D] table (its model shard);
    ``indices``: this rank's data shard of global row ids, int [b].
    → float32 [b, D], the same on every rank of the model axis; ids outside
    [0, V) read zeros. Differentiable in ``table`` (a tensor that requires
    grad): its gradient covers this rank's ids, so a data-parallel caller
    sums it over the data axis, as the JAX transpose does."""
    table, start = _local(table, mesh, model_axis)
    ids = _tensor(indices, torch.int32, table.device)
    return _RangeLookup.apply(table, ids, start, mesh.get_group(model_axis))


class _RangeBag(torch.autograd.Function):
    """The weighted sums over this rank's rows summed over the model group;
    the backward adds ``g[b] * mask[b, l]`` at each id in ``[start, start +
    rows_local)`` (no wrap of negatives: the shard_map reads zeros for every
    id outside its rows)."""

    @staticmethod
    def forward(ctx, table, values, mask, start, group):
        ctx.save_for_backward(values, mask)
        ctx.meta = (start, table.shape[0], group.size())
        return all_reduce(embedding_range_bag(table, values, mask, start), group)

    @staticmethod
    def backward(ctx, grad):
        values, mask = ctx.saved_tensors
        start, rows, model_size = ctx.meta
        d_table = range_bag_grad(grad.contiguous(), values, mask, start, rows, rows * model_size, "sum", wrap=False)
        return d_table, None, None, None, None


def sharded_embedding_bag(
    table, values, mask, mesh, model_axis: str = "model", data_axis: str = "data", combiner: str = "mean"
):
    """The multihot form: ``values`` int [b, L] and ``mask`` [b, L] (this
    rank's data shard) → pooled float32 [b, D]. ``mean`` divides the sum
    over the model axis by max(sum(mask), 1), after the sum. Differentiable
    in ``table``, as ``sharded_embedding_lookup``."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    table, start = _local(table, mesh, model_axis)
    vals = _tensor(values, torch.int32, table.device)
    m = _tensor(mask, torch.float32, table.device)
    pooled = _RangeBag.apply(table, vals, m, start, mesh.get_group(model_axis))
    if combiner == "sum":
        return pooled
    return pooled / torch.clamp(m.sum(dim=1), min=1.0)[:, None]
