"""The tabular MLP: the counterpart of ``nvtabular_tpu/models/tabular_mlp.py``.

Per-column embeddings and multihot embedding bags, concatenated with the
continuous features, through a dense ReLU stack to ``num_classes`` logits.
The batch is the JAX model's: one int32 [B] code tensor per categorical
column, ``<col>__values`` [B, L] and ``<col>__mask`` [B, L] per multihot
column (``DeviceLoader`` with ``sparse_max``), and ``continuous`` [B, C]
float (the loader names it ``dense``: pass it as ``continuous``, as the
JAX model needs).

The MLP's input row is the reference's ``jnp.concatenate`` of features
(:53-71): the single-hot tables' rows in sorted column order, then the
bags in sorted order, then the continuous features. It is built in one
buffer: each table is one launch of kernel K13a gathering its rows
straight into its slot, each bag one launch of kernel K13c into its slot,
and the backward scatters the buffer's gradient back through the same
kernels. The buffer's row is padded to a multiple of 4 floats so the
kernels move float4s; the MLP reads the first ``input_dim`` columns.

``tabular_mlp_init`` / ``tabular_mlp_forward`` are the JAX package's
functional pair over its params tree ``{"tables", "mh_tables", "mlp"}``:
the init draws what ``TabularMLP(config, rng)`` draws, and the forward runs
the module's forward over the tree (its layout from the tables' widths and
``batch["continuous"]``, which it reads where the batch has it, as JAX's).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..kernels.embedding import embedding_gather, embedding_gather_plain, embedding_scatter_grad
from ..kernels.embedding_bag import embedding_bag_bwd, embedding_bag_fwd, embedding_bag_fwd_plain
from .layers import MLP, Rng, bce_with_logits, make_generator, mlp_apply
from .pytree import tree_map


@dataclass
class TabularMLPConfig:
    embedding_sizes: Dict[str, Tuple[int, int]]  # col → (cardinality, dim)
    num_continuous: int
    layer_sizes: Tuple[int, ...] = (512, 256)
    num_classes: int = 1
    multihot_embedding_sizes: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    @property
    def input_dim(self) -> int:
        emb = sum(d for _, d in self.embedding_sizes.values())
        emb += sum(d for _, d in self.multihot_embedding_sizes.values())
        return emb + self.num_continuous


@dataclass
class _Layout:
    tables: List[Tuple[str, int, int]]  # (column, dim, start)
    bags: List[Tuple[str, int, int]]
    cont_start: int
    num_continuous: int
    input_dim: int
    width: int  # input_dim padded to a multiple of 4


def _layout(tables: Sequence[Tuple[str, int]], bags: Sequence[Tuple[str, int]], num_continuous: int) -> _Layout:
    """The MLP input's slots: the tables' (column, dim) in order, then the
    bags', then the continuous features."""
    slots, col = ([], []), 0
    for slot, entries in zip(slots, (tables, bags)):
        for name, dim in entries:
            slot.append((name, dim, col))
            col += dim
    input_dim = col + num_continuous
    return _Layout(*slots, col, num_continuous, input_dim, -(-input_dim // 4) * 4)


class _MLPInput(torch.autograd.Function):
    """The MLP's input [B, width] from the tables, the bags and the
    continuous features; the backward hands each table its dense gradient
    and the continuous features their slice."""

    @staticmethod
    def forward(ctx, lay: _Layout, B: int, continuous, *args):
        G, M = len(lay.tables), len(lay.bags)
        tables, bag_tables = args[:G], args[G : G + M]
        ids, pads = args[G + M : len(args) - 2 * M], args[len(args) - 2 * M :]
        dev = (args or (continuous,))[0].device
        x = torch.empty((B, lay.width), dtype=torch.float32, device=dev)
        for (_, dim, start), table, v in zip(lay.tables, tables, ids):
            embedding_gather(table, [v], [0], [table.shape[0]], out=x[:, start : start + dim].unflatten(1, (1, dim)))
        for i, ((_, dim, start), table) in enumerate(zip(lay.bags, bag_tables)):
            embedding_bag_fwd(table, pads[2 * i], pads[2 * i + 1], "mean", out=x[:, start : start + dim])
        if lay.num_continuous:
            x[:, lay.cont_start : lay.input_dim].copy_(continuous)
        if lay.width > lay.input_dim:
            x[:, lay.input_dim :].zero_()
        ctx.save_for_backward(*ids, *pads)
        ctx.lay = lay
        ctx.rows = [t.shape[0] for t in tables + bag_tables]
        return x

    @staticmethod
    def backward(ctx, gx):
        lay = ctx.lay
        G, M = len(lay.tables), len(lay.bags)
        saved = ctx.saved_tensors
        ids, pads = saved[: len(saved) - 2 * M], saved[len(saved) - 2 * M :]
        gx = gx.contiguous()
        d_tables = []
        for j, (_, dim, start) in enumerate(lay.tables):
            d = None
            if ctx.needs_input_grad[3 + j]:
                grad = gx[:, start : start + dim].unflatten(1, (1, dim))
                d = embedding_scatter_grad(grad, [ids[j]], [0], [ctx.rows[j]], ctx.rows[j])
            d_tables.append(d)
        for i, (_, dim, start) in enumerate(lay.bags):
            d = None
            if ctx.needs_input_grad[3 + G + i]:
                d = embedding_bag_bwd(gx[:, start : start + dim], pads[2 * i], pads[2 * i + 1], ctx.rows[G + i], "mean")
            d_tables.append(d)
        d_cont = gx[:, lay.cont_start : lay.input_dim] if lay.num_continuous and ctx.needs_input_grad[2] else None
        return (None, None, d_cont, *d_tables) + (None,) * len(saved)


class TabularMLP(nn.Module):
    """``forward(batch)`` is ``tabular_mlp_forward``: logits [B, num_classes].
    Parameters are drawn on ``device`` (``cuda:0`` unless the caller passes
    another) from a ``torch.Generator`` seeded with ``seed``, with
    ``tabular_mlp_init``'s distributions: tables ``N(0, 1) / sqrt(dim)`` in
    sorted column order, then the multihot tables, then the MLP (He normal).
    The MLP computes in ``compute_dtype`` as ``mlp_apply`` does (bfloat16 by
    default)."""

    def __init__(self, config: TabularMLPConfig, seed: Rng = 0, device=None, compute_dtype=torch.bfloat16):
        super().__init__()
        gen = make_generator(seed, device)
        dev = gen.device
        self.config = config
        self.names = sorted(config.embedding_sizes)
        self.mh_names = sorted(config.multihot_embedding_sizes)
        self.tables, self.mh_tables = nn.ParameterList(), nn.ParameterList()
        for params, names, sizes in ((self.tables, self.names, config.embedding_sizes),
                                     (self.mh_tables, self.mh_names, config.multihot_embedding_sizes)):
            for name in names:
                card, dim = (int(v) for v in sizes[name])
                params.append(nn.Parameter(torch.randn((card, dim), generator=gen, device=dev).mul_(1.0 / math.sqrt(dim))))
        self.layout = _layout([(n, t.shape[1]) for n, t in zip(self.names, self.tables)],
                              [(n, t.shape[1]) for n, t in zip(self.mh_names, self.mh_tables)], config.num_continuous)
        self.mlp = MLP(
            [config.input_dim, *config.layer_sizes, config.num_classes],
            compute_dtype=compute_dtype, generator=gen, device=dev,
        )

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as ``tabular_mlp_init``'s tree."""
        return {
            "tables": dict(zip(self.names, self.tables)),
            "mh_tables": dict(zip(self.mh_names, self.mh_tables)),
            "mlp": self.mlp.layers(),
        }

    def _continuous(self, batch, B: int):
        nc = self.config.num_continuous
        if not nc:
            return None
        if "continuous" not in batch:
            raise ValueError(
                f"the tabular MLP reads its {nc} continuous features from batch['continuous'] (DeviceLoader "
                f"names them 'dense')"
            )
        cont = batch["continuous"]
        if tuple(cont.shape) != (B, nc):
            raise ValueError(f"batch['continuous'] has shape {tuple(cont.shape)}, expected {(B, nc)}")
        return cont.to(torch.float32)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        B = _batch_rows(self.names, self.mh_names, batch)
        return _logits(self.layout, self.tables, self.mh_tables, self.names, self.mh_names, self._continuous(batch, B),
                       B, self.mlp, batch)


def _batch_rows(names, mh_names, batch) -> int:
    first = batch[names[0]] if names else batch[f"{mh_names[0]}__values"] if mh_names else batch["continuous"]
    return first.shape[0]


def _logits(lay: _Layout, tables, mh_tables, names, mh_names, continuous: Optional[torch.Tensor], B: int, mlp,
            batch) -> torch.Tensor:
    """``tabular_mlp_forward``: the input row built by K13a and K13c in one
    buffer, then the MLP (``mlp``) over its first ``input_dim`` columns →
    logits [B, num_classes]."""
    ids = [batch[n] for n in names]
    pads = [t for n in mh_names for t in (batch[f"{n}__values"], batch[f"{n}__mask"])]
    x = _MLPInput.apply(lay, B, continuous, *tables, *mh_tables, *ids, *pads)
    return mlp(x[:, : lay.input_dim])


def tabular_mlp_init(rng: Rng, config: TabularMLPConfig, device=None) -> Dict[str, Any]:
    """The JAX package's ``tabular_mlp_init``: ``TabularMLP(config, rng,
    device)``'s parameters as its tree, detached (torch's draws, not
    ``jax.random``'s)."""
    return tree_map(torch.Tensor.detach, TabularMLP(config, rng, device).param_tree())


def tabular_mlp_forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``tabular_mlp_forward`` over a params tree →
    logits [B, num_classes]; ``batch["continuous"]`` joins the input where
    the batch has it."""
    names, mh_names = sorted(params["tables"]), sorted(params["mh_tables"])
    tables = [params["tables"][n] for n in names]
    mh_tables = [params["mh_tables"][n] for n in mh_names]
    cont = batch["continuous"].to(torch.float32) if "continuous" in batch else None
    lay = _layout([(n, t.shape[1]) for n, t in zip(names, tables)],
                  [(n, t.shape[1]) for n, t in zip(mh_names, mh_tables)], 0 if cont is None else cont.shape[1])
    return _logits(lay, tables, mh_tables, names, mh_names, cont, _batch_rows(names, mh_names, batch),
                   lambda x: mlp_apply(params["mlp"], x), batch)


def tabular_reference_forward(model: TabularMLP, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``model``'s forward through the plain versions of K13a, K13c and
    K19, with autograd through plain PyTorch operations, on any device: what
    the kernel path is held against on the card."""
    feats = []
    for name, table in zip(model.names, model.tables):
        feats.append(embedding_gather_plain(table, [batch[name]], [0], [table.shape[0]]).flatten(1))
    for name, table in zip(model.mh_names, model.mh_tables):
        feats.append(embedding_bag_fwd_plain(table, batch[f"{name}__values"], batch[f"{name}__mask"]))
    B = feats[0].shape[0] if feats else batch["continuous"].shape[0]
    cont = model._continuous(batch, B)
    if cont is not None:
        feats.append(cont)
    return model.mlp(torch.cat(feats, dim=1), plain=True)


def tabular_mlp_loss(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Binary cross-entropy of the logits against ``batch["label"]``, of a
    ``TabularMLP`` or of a params tree (``tabular_mlp_forward``)."""
    logits = model(batch) if isinstance(model, nn.Module) else tabular_mlp_forward(model, batch)
    return bce_with_logits(logits.reshape(-1), batch["label"])

