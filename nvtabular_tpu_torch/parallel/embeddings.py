"""Row-sharded embedding lookups over the mesh, forward.

Counterpart of ``nvtabular_tpu/parallel/embeddings.py:22-87``. Each rank of
the ``model`` axis holds a contiguous row range of a [V, D] table (model
shard ``m`` of ``M`` holds rows ``[m * V / M, (m + 1) * V / M)``; see
``convert.load_sharded_table``) and each rank of the ``data`` axis a shard of
the ids. Kernel K15b gathers (or bags) the local rows for every id, zeros
for the rows another rank holds, and one ``all_reduce`` over the model
axis's group assembles the embeddings: exactly one rank owns each row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.embedding import embedding_range_gather
from ..kernels.embedding_bag import COMBINERS, embedding_range_bag
from .mesh import all_reduce, mesh_device


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)


def _local(table, mesh, model_axis: str):
    device = table.device if isinstance(table, torch.Tensor) else mesh_device(mesh)
    table = _tensor(table, torch.float32, device)
    return table, mesh.get_local_rank(model_axis) * table.shape[0]


def sharded_embedding_lookup(table, indices, mesh, model_axis: str = "model", data_axis: str = "data"):
    """``table``: this rank's rows of the [V, D] table (its model shard);
    ``indices``: this rank's data shard of global row ids, int [b].
    → float32 [b, D], the same on every rank of the model axis."""
    table, start = _local(table, mesh, model_axis)
    ids = _tensor(indices, torch.int32, table.device)
    return all_reduce(embedding_range_gather(table, ids, start), mesh.get_group(model_axis))


def sharded_embedding_bag(
    table, values, mask, mesh, model_axis: str = "model", data_axis: str = "data", combiner: str = "mean"
):
    """The multihot form: ``values`` int [b, L] and ``mask`` [b, L] (this
    rank's data shard) → pooled float32 [b, D]. ``mean`` divides the sum
    over the model axis by max(sum(mask), 1), after the sum."""
    if combiner not in COMBINERS:
        raise ValueError(f"combiner must be one of {COMBINERS}, got {combiner!r}")
    table, start = _local(table, mesh, model_axis)
    vals = _tensor(values, torch.int32, table.device)
    m = _tensor(mask, torch.float32, table.device)
    pooled = all_reduce(embedding_range_bag(table, vals, m, start), mesh.get_group(model_axis))
    if combiner == "sum":
        return pooled
    return pooled / torch.clamp(m.sum(dim=1), min=1.0)[:, None]
