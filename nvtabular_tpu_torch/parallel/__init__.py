"""Parallelism on ``torch.distributed``: process groups, device meshes, the
sharded vocabulary count, sharded moments and row-sharded embeddings.

Counterpart of ``nvtabular_tpu/parallel/__init__.py``: one process a GPU
(NCCL; gloo on the CPU) in place of the JAX package's single-controller
mesh, rank ``r`` doing what device ``r`` does there. Training on row-sharded
tables (``make_train_step``, ``shard_params``, ``shard_batch``) is not
ported yet.
"""

from .embeddings import sharded_embedding_bag, sharded_embedding_lookup
from .mesh import initialize_distributed, local_mesh, make_mesh
from .sharded_vocab import sharded_value_counts
from .stats import sharded_moments

UNSUPPORTED_TRAINING = (
    "{} is not ported yet: training on row-sharded tables waits for the gradient "
    "through the sharded lookup (ROADMAP.md queue 1 item 10: training)"
)


def make_train_step(*args, **kwargs):
    raise NotImplementedError(UNSUPPORTED_TRAINING.format("make_train_step"))


def shard_params(*args, **kwargs):
    raise NotImplementedError(UNSUPPORTED_TRAINING.format("shard_params"))


def shard_batch(*args, **kwargs):
    raise NotImplementedError(UNSUPPORTED_TRAINING.format("shard_batch"))


__all__ = [
    "initialize_distributed",
    "local_mesh",
    "make_mesh",
    "make_train_step",
    "shard_batch",
    "shard_params",
    "sharded_embedding_bag",
    "sharded_embedding_lookup",
    "sharded_moments",
    "sharded_value_counts",
]
