"""Training on row-sharded embedding tables over the mesh.

Counterpart of ``nvtabular_tpu/parallel/train.py:20-87``. The JAX package
jits one SPMD step and lets GSPMD place the collectives; here every rank runs
the step on its own shard and the collectives are written out. Rank ``(d,
m)`` of a (data, model) mesh holds model shard ``m`` of every table (rows
``[m * Vp / M, (m + 1) * Vp / M)``, ``dlrm_param_specs``' ``P("model",
None)``), a replica of the MLPs, and data shard ``d`` of each batch (rows
``[d * B / Dn, (d + 1) * B / Dn)``, ``batch_specs``' ``P("data")``).

A step:

1. the forward gathers this rank's rows (kernel K15d) and its share of each
   multihot bag (K15d's bag) into one buffer and sums it over the model
   group, then divides each bag by its count
   (``kernels.embedding.ShardedEmbeddingFeatures``);
2. the backward scatter-adds the features' gradient into this rank's rows
   (K15d's backward and its bag's) with no collective: every rank of a
   model group holds the same features, so their sum's transpose is the
   identity;
3. the gradients are averaged over the data group, the tables' in place and
   the MLPs' through one flat buffer, so the replicas stay bit-equal;
4. ``Adagrad`` updates in place: each rank its own rows and its replica.

The loss each step returns is the mean over the global batch, as the JAX
step's ``out_shardings=P()`` gives it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.training import Adagrad, LossFn, train_step
from .mesh import all_reduce, mesh_device


def _table_axis(specs) -> str:
    """The one mesh axis that ``specs`` row-shards every table over."""
    axes = {tuple(s) for s in (*specs["tables"].values(), *specs.get("mh_tables", {}).values())}
    if len(axes) != 1 or len(next(iter(axes))) != 2 or next(iter(axes))[1] is not None:
        raise ValueError(f"every table must be row-sharded over one axis, as (axis, None); got {sorted(axes)}")
    return next(iter(axes))[0]


def _replicated(specs, what: str) -> None:
    for layer in specs:
        for name, spec in layer.items():
            if tuple(spec) != ():
                raise ValueError(f"{what} {name}: only replicated MLP parameters (()) are supported, got {spec}")


def shard_params(model, specs: Dict[str, Any], mesh):
    """Place ``model`` (a ``DLRM``) on the mesh per ``specs``
    (``dlrm_param_specs``): this rank keeps its model shard of every table,
    single-hot and multihot, and looks its rows up through the sharded
    lookup and bag; the MLPs stay whole. The model moves to this rank's
    device. Returns the model. Make the optimizer afterwards, as optax's
    state is made from sharded params."""
    if sorted(specs["tables"]) != model.names or sorted(specs.get("mh_tables", {})) != model.mh_names:
        raise ValueError(f"table specs {sorted(specs['tables'])} and {sorted(specs.get('mh_tables', {}))} do not "
                         f"match the model's {model.names} and {model.mh_names}")
    axis = _table_axis(specs)
    _replicated(specs["bottom"], "bottom")
    _replicated(specs["top"], "top")
    group = mesh.get_group(axis)
    model.to(mesh_device(mesh))
    model.shard_tables(mesh.get_local_rank(axis), group.size(), functools.partial(all_reduce, group=group))
    return model


def _leading_axis(spec) -> Optional[str]:
    spec = tuple(spec)
    if any(a is not None for a in spec[1:]):
        raise ValueError(f"only the leading (batch) dimension may be split, got {spec}")
    return spec[0] if spec else None


def shard_batch(batch: Dict[str, Any], specs: Dict[str, Any], mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch (numpy arrays or tensors) on its
    device: for an input split over an axis (``batch_specs``), rows ``[r *
    B / n, (r + 1) * B / n)`` for rank ``r`` of that axis's ``n``; an input
    without a spec whole."""
    dev = mesh_device(mesh)
    out = {}
    for key, value in batch.items():
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))
        axis = _leading_axis(specs.get(key, ()))
        if axis is not None:
            n, r = mesh.get_group(axis).size(), mesh.get_local_rank(axis)
            if t.shape[0] % n:
                raise ValueError(f"{key}: {t.shape[0]} rows do not split over {n} ranks of axis {axis!r}")
            rows = t.shape[0] // n
            t = t[r * rows : (r + 1) * rows]
        out[key] = t.to(dev)
    return out


def _mean(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """``t`` averaged over ``group``'s ``n`` ranks in place (no division on one)."""
    all_reduce(t, group)
    return t.div_(n) if n > 1 else t


def _average(tensors, group, n: int) -> None:
    """Each tensor the mean over ``group`` of its ``n`` ranks', in place; all
    through one flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _mean(flat, group, n)
    start = 0
    for t in tensors:
        t.copy_(flat[start : start + t.numel()].view_as(t))
        start += t.numel()


def make_train_step(
    loss_fn: LossFn,
    optimizer: Optional[Adagrad] = None,
    mesh=None,
    param_specs: Optional[Dict[str, Any]] = None,
    batch_specs: Optional[Dict[str, Any]] = None,
    donate: bool = True,
) -> Callable[[torch.nn.Module, Adagrad, Dict[str, torch.Tensor]], torch.Tensor]:
    """``step(model, optimizer, batch) -> loss``: one optimizer step of
    ``loss_fn(model, batch)``, the parameters and the optimizer's state
    updated in place, the loss before it returned (0-d, on the model's
    device). The port's ``Adagrad`` holds its own state, so ``step`` takes it
    where JAX's step takes ``opt_state``; ``optimizer`` here and ``donate``
    are accepted for the JAX signature.

    Without a mesh this is ``models.train_step``. With one, ``model`` must
    have been placed by ``shard_params(model, param_specs, mesh)`` and
    ``batch`` by ``shard_batch(batch, batch_specs, mesh)``: the gradients are
    averaged over the data axis of ``batch_specs``, and so is the loss, the
    mean over the global batch."""
    if mesh is None:
        return functools.partial(train_step, loss_fn=loss_fn)
    if param_specs is None or batch_specs is None:
        raise ValueError("a sharded step needs param_specs and batch_specs")
    axes = {_leading_axis(s) for s in batch_specs.values()} - {None}
    if len(axes) != 1:
        raise ValueError(f"batch_specs must split every input over one axis, got {sorted(axes)}")
    data_axis = axes.pop()
    _table_axis(param_specs)
    group = mesh.get_group(data_axis)
    n = group.size()

    def step(model, opt: Adagrad, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if model.shard is None:
            raise ValueError("the model's tables are not sharded: call shard_params first")
        opt.zero_grad()
        loss = loss_fn(model, batch)
        loss.backward()
        tables = [model.table, *model.mh_tables]
        for t in tables:
            if t.grad is not None:
                _mean(t.grad, group, n)
        _average([p.grad for p in model.parameters() if all(p is not t for t in tables) and p.grad is not None],
                 group, n)
        opt.step()
        return _mean(loss.detach().clone(), group, n)

    return step


def make_eval_step(forward_fn: Callable, mesh=None) -> Callable:
    """``step(model, batch)``: ``forward_fn(model, batch)`` without
    gradients. On a mesh it gives this rank's rows of the output, the
    sharded lookup summing over the model group inside the forward."""

    @torch.no_grad()
    def step(model, batch):
        return forward_fn(model, batch)

    return step
