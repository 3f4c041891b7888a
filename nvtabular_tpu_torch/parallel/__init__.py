"""Parallelism on ``torch.distributed``: process groups, device meshes, the
sharded vocabulary count, sharded moments, row-sharded embeddings and
training on row-sharded tables.

Counterpart of ``nvtabular_tpu/parallel/__init__.py``: one process a GPU
(NCCL; gloo on the CPU) in place of the JAX package's single-controller
mesh, rank ``r`` doing what device ``r`` does there.
"""

from .embeddings import sharded_embedding_bag, sharded_embedding_lookup
from .mesh import initialize_distributed, local_mesh, make_mesh
from .sharded_vocab import sharded_value_counts
from .stats import sharded_moments
from .train import make_eval_step, make_train_step, shard_batch, shard_params

__all__ = [
    "initialize_distributed",
    "local_mesh",
    "make_eval_step",
    "make_mesh",
    "make_train_step",
    "shard_batch",
    "shard_params",
    "sharded_embedding_bag",
    "sharded_embedding_lookup",
    "sharded_moments",
    "sharded_value_counts",
]
