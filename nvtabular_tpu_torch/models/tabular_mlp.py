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
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..kernels.embedding import embedding_gather, embedding_gather_plain, embedding_scatter_grad
from ..kernels.embedding_bag import embedding_bag_bwd, embedding_bag_fwd, embedding_bag_fwd_plain
from ..workflow.workflow import resolve_device
from .layers import MLP, bce_with_logits


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

    def __init__(self, config: TabularMLPConfig, seed: int = 0, device=None, compute_dtype=torch.bfloat16):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.config = config
        self.names = sorted(config.embedding_sizes)
        self.mh_names = sorted(config.multihot_embedding_sizes)
        self.tables, self.mh_tables = nn.ParameterList(), nn.ParameterList()
        slots, col = ([], []), 0
        for params, slot, names, sizes in (
            (self.tables, slots[0], self.names, config.embedding_sizes),
            (self.mh_tables, slots[1], self.mh_names, config.multihot_embedding_sizes),
        ):
            for name in names:
                card, dim = (int(v) for v in sizes[name])
                table = torch.randn((card, dim), generator=gen, device=dev).mul_(1.0 / math.sqrt(dim))
                params.append(nn.Parameter(table))
                slot.append((name, dim, col))
                col += dim
        self.layout = _Layout(*slots, col, config.num_continuous, config.input_dim,
                              -(-config.input_dim // 4) * 4)
        self.mlp = MLP(
            [config.input_dim, *config.layer_sizes, config.num_classes],
            compute_dtype=compute_dtype, generator=gen, device=dev,
        )

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
        lay = self.layout
        ids = [batch[n] for n in self.names]
        pads = [t for n in self.mh_names for t in (batch[f"{n}__values"], batch[f"{n}__mask"])]
        B = (ids[0] if ids else pads[0] if pads else batch["continuous"]).shape[0]
        x = _MLPInput.apply(lay, B, self._continuous(batch, B), *self.tables, *self.mh_tables, *ids, *pads)
        return self.mlp(x[:, : lay.input_dim])


def tabular_reference_forward(model: TabularMLP, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``model``'s forward through the plain versions of K13a and K13c,
    with autograd through plain PyTorch operations, on any device: what the
    kernel path is held against on the card."""
    feats = []
    for name, table in zip(model.names, model.tables):
        feats.append(embedding_gather_plain(table, [batch[name]], [0], [table.shape[0]]).flatten(1))
    for name, table in zip(model.mh_names, model.mh_tables):
        feats.append(embedding_bag_fwd_plain(table, batch[f"{name}__values"], batch[f"{name}__mask"]))
    B = feats[0].shape[0] if feats else batch["continuous"].shape[0]
    cont = model._continuous(batch, B)
    if cont is not None:
        feats.append(cont)
    return model.mlp(torch.cat(feats, dim=1))


def tabular_mlp_loss(model: TabularMLP, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Binary cross-entropy of the logits against ``batch["label"]``."""
    return bce_with_logits(model(batch).reshape(-1), batch["label"])

