"""DLRM: the counterpart of ``nvtabular_tpu/models/dlrm.py``.

The model reads the training batches of ``loader.DeviceLoader``: ``dense``
float32 [B, num_dense], one int32 [B] code tensor per categorical column,
``<col>__values`` int32 [B, L] and ``<col>__mask`` float32 [B, L] per
multihot column (``DeviceLoader`` with ``sparse_max``) and ``label``. Its
single-hot embedding tables live in one concatenated float32 ``[sum V, D]``
parameter, the columns' tables in sorted name order, which the gather
kernel K13a indexes through per-column row offsets; each multihot table is
a parameter of its own (``mh_tables``, sorted by name), pooled by the bag
kernel K13c with the mean of ``multihot_embedding_lookup``. The features
are ``dlrm_forward``'s: the bottom MLP's output in slot 0, the gathered rows
in slots 1..C, the bags in slots C+1..C+M of one [B, 1 + C + M, D] buffer
that both kernels write in place, and the interaction kernel K13b writes
its pair dots after the bottom output in the top MLP's input. Each table
has ``padded_cardinality`` rows, as ``dlrm_init`` pads it
(``vocab_pad_multiple``). ``shard_tables`` keeps a rank's rows of every
table for training on row-sharded tables (``parallel.shard_params``); the
lookups then go through kernel K15d and its bag and the model group's sum,
and ``dlrm_param_specs`` / ``batch_specs`` give the JAX package's shardings
as axis tuples.

``dlrm_init`` / ``dlrm_forward`` are the JAX package's functional pair
over a params tree ``{"tables": {col: [V, D]}, "mh_tables": {col: [V, D]},
"bottom": [{"w", "b"}, ...], "top": [...]}``: the init draws what
``DLRM(config, rng)`` draws (its tables views of one concatenated tensor),
and the forward runs the module's forward (``_logits``) over the tree, its
tables concatenated for K13a on each call (one copy of them a forward).

``self_interaction=True`` is refused: the JAX ``dlrm_forward`` itself fails
for it (ROADMAP.md §3). The layer, ``dot_product_interaction(features,
self_interaction=True)``, is ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels.embedding import RowShard, embedding_features, embedding_gather_plain, sharded_embedding_features
from ..kernels.embedding_bag import embedding_bag_fwd_plain
from ..kernels.interaction import dot_interaction, dot_interaction_plain
from .layers import MLP, Rng, bce_with_logits, concatenate_tables, make_generator, mlp_apply
from .pytree import tree_map


@dataclass
class DLRMConfig:
    """Model shape. ``cardinalities`` maps categorical column → vocab size
    (the ``cardinality`` Categorify records in the schema's
    ``embedding_sizes`` property)."""

    cardinalities: Dict[str, int]
    num_dense: int
    embedding_dim: int = 64
    bottom_mlp: Tuple[int, ...] = (512, 256)
    top_mlp: Tuple[int, ...] = (512, 256)
    multihot_cardinalities: Dict[str, int] = field(default_factory=dict)
    multihot_max_len: int = 8
    self_interaction: bool = False
    vocab_pad_multiple: int = 1

    @property
    def num_features(self) -> int:
        return 1 + len(self.cardinalities) + len(self.multihot_cardinalities)

    def padded_cardinality(self, n: int) -> int:
        m = self.vocab_pad_multiple
        return ((n + m - 1) // m) * m

    @property
    def interaction_dim(self) -> int:
        f = self.num_features
        return f * (f + 1) // 2 if self.self_interaction else f * (f - 1) // 2

    @classmethod
    def from_schema(cls, schema, num_dense: Optional[int] = None, **kwargs) -> "DLRMConfig":
        """Columns with ``embedding_sizes`` properties become embedding
        tables; the remaining scalar float columns are dense features."""
        cards: Dict[str, int] = {}
        mh_cards: Dict[str, int] = {}
        n_dense = 0
        for cs in schema:
            emb = cs.properties.get("embedding_sizes")
            if emb is not None:
                if cs.is_list:
                    mh_cards[cs.name] = int(emb["cardinality"])
                else:
                    cards[cs.name] = int(emb["cardinality"])
            elif cs.dtype.is_float and not cs.is_list:
                n_dense += 1
        return cls(
            cardinalities=cards,
            num_dense=num_dense if num_dense is not None else n_dense,
            multihot_cardinalities=mh_cards,
            **kwargs,
        )


SELF_INTERACTION_REFUSED = (
    "DLRM with self_interaction=True is refused: the reference's own dlrm_forward fails for it "
    "(nvtabular_tpu/models/dlrm.py:61-63 and :108 size the top MLP for F(F+1)/2 pairs, :134 computes "
    "dot_product_interaction(stacked) without the flag, F(F-1)/2 pairs); a recorded difference, ROADMAP.md §3. "
    "dot_product_interaction(features, self_interaction=True) is ported"
)


class DLRM(nn.Module):
    """``forward(batch)`` is ``dlrm_forward``: logits [B]. Parameters are
    drawn on ``device`` (``cuda:0`` unless the caller passes another) from a
    ``torch.Generator`` seeded with ``seed`` (or ``seed`` itself where it is
    a generator), with ``dlrm_init``'s distributions: tables ``N(0, 1) /
    sqrt(D)``, MLPs He normal. The MLPs compute in ``compute_dtype`` as
    ``mlp_apply`` does (bfloat16 by default). Each table, single-hot or
    multihot, has ``config.padded_cardinality(V)`` rows."""

    def __init__(self, config: DLRMConfig, seed: Rng = 0, device=None, compute_dtype=torch.bfloat16):
        super().__init__()
        if config.self_interaction:
            raise ValueError(SELF_INTERACTION_REFUSED)
        gen = make_generator(seed, device)
        dev = gen.device
        d = config.embedding_dim
        self.config = config
        self.names = sorted(config.cardinalities)
        self.sizes = [config.padded_cardinality(int(config.cardinalities[n])) for n in self.names]
        self.mh_names = sorted(config.multihot_cardinalities)
        self.shard: Optional[RowShard] = None
        self.offsets = [int(o) for o in np.concatenate([[0], np.cumsum(self.sizes)[:-1]])] if self.sizes else []
        rows = sum(self.sizes)
        self.table = nn.Parameter(torch.randn((rows, d), generator=gen, device=dev).mul_(1.0 / math.sqrt(d)))
        self.mh_tables = nn.ParameterList([
            nn.Parameter(torch.randn((config.padded_cardinality(int(config.multihot_cardinalities[n])), d),
                                     generator=gen, device=dev).mul_(1.0 / math.sqrt(d)))
            for n in self.mh_names
        ])
        self.bottom = MLP(
            [config.num_dense, *config.bottom_mlp, d], final_activation=True,
            compute_dtype=compute_dtype, generator=gen, device=dev,
        )
        self.top = MLP(
            [d + config.interaction_dim, *config.top_mlp, 1],
            compute_dtype=compute_dtype, generator=gen, device=dev,
        )

    def table_rows(self, name: str) -> torch.Tensor:
        """The rows of column ``name``'s table this model holds (a rank's
        rows once sharded): a view of ``self.table``, or the multihot
        column's table."""
        if name in self.mh_names:
            return self.mh_tables[self.mh_names.index(name)]
        i = self.names.index(name)
        return self.table[self.offsets[i] : self.offsets[i] + self.sizes[i]]

    def shard_tables(self, model_rank: int, model_size: int, reduce: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """Keep model shard ``model_rank`` of ``model_size`` of every table,
        rows ``[m * Vp / M, (m + 1) * Vp / M)`` as ``P("model", None)``
        splits it: the single-hot tables' concatenated in column order into
        a new ``self.table`` (``offsets`` and ``sizes`` become the shard's),
        each multihot table's in place of the table. ``shard`` keeps each
        table's global start and padded size. ``reduce`` sums a tensor over
        the model group in place. Make the optimizer afterwards."""
        if self.shard is not None:
            raise ValueError("the tables are sharded already")
        if not 0 <= model_rank < model_size:
            raise ValueError(f"model_rank must be in [0, {model_size}), got {model_rank}")
        mh_padded = [t.shape[0] for t in self.mh_tables]
        bad = [n for n, v in zip(self.names + self.mh_names, self.sizes + mh_padded) if v % model_size]
        if bad:
            raise ValueError(
                f"tables {bad} have padded sizes not divisible by the model axis's {model_size} ranks: "
                "set vocab_pad_multiple to a multiple of it"
            )
        sizes = [v // model_size for v in self.sizes]
        starts = [model_rank * s for s in sizes]
        bag_starts = [model_rank * (v // model_size) for v in mh_padded]
        with torch.no_grad():
            local = torch.cat([self.table[o + st : o + st + s] for o, st, s in zip(self.offsets, starts, sizes)])
            for k, (st, vp) in enumerate(zip(bag_starts, mh_padded)):
                self.mh_tables[k] = nn.Parameter(self.mh_tables[k][st : st + vp // model_size].clone())
        offsets = [int(o) for o in np.concatenate([[0], np.cumsum(sizes)[:-1]])] if sizes else []
        self.shard = RowShard(tuple(offsets), tuple(sizes), tuple(starts), tuple(self.sizes), model_rank, reduce,
                              tuple(bag_starts), tuple(mh_padded))
        self.offsets, self.sizes = offsets, sizes
        self.table = nn.Parameter(local.contiguous())

    def _bags(self, batch):
        return _bags(self.mh_names, self.mh_tables, batch)

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as ``dlrm_init``'s tree: each table a view of
        ``self.table`` (the rank's rows where the tables are row-sharded),
        the MLPs' layers as ``mlp_init``'s."""
        return {
            "tables": {n: self.table_rows(n) for n in self.names},
            "mh_tables": dict(zip(self.mh_names, self.mh_tables)),
            "bottom": self.bottom.layers(),
            "top": self.top.layers(),
        }

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _logits(self.bottom, self.top, self.table, self.offsets, self.sizes, self.shard,
                       [batch[name] for name in self.names], self._bags(batch), batch["dense"])


def _bags(names, tables, batch):
    return [(t, batch[f"{n}__values"], batch[f"{n}__mask"]) for n, t in zip(names, tables)]


def _logits(bottom, top, table, offsets, sizes, shard: Optional[RowShard], ids, bags, dense) -> torch.Tensor:
    """``dlrm_forward``: the bottom MLP (``bottom``) into slot 0 of the
    features, the lookups (K13a, or K15d where ``shard`` is given) and bags
    beside it, the interaction (K13b) after the bottom output, the top MLP
    (``top``) → logits [B]."""
    bottom_out = bottom(dense)  # [B, D]
    if shard is None:
        feats = embedding_features(bottom_out, table, ids, offsets, sizes, bags)
    else:
        feats = sharded_embedding_features(bottom_out, table, ids, shard, bags)
    top_in = dot_interaction(feats, bottom_out)  # [B, D + F(F-1)/2]
    return top(top_in).reshape(-1)


def dlrm_init(rng: Rng, config: DLRMConfig, device=None) -> Dict[str, Any]:
    """The JAX package's ``dlrm_init``: ``DLRM(config, rng, device)``'s
    parameters as its tree (``param_tree``), detached. ``rng`` is a
    ``torch.Generator`` or a seed; the values are torch's draws, not
    ``jax.random``'s."""
    return tree_map(torch.Tensor.detach, DLRM(config, rng, device).param_tree())


def dlrm_forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``dlrm_forward`` over a params tree: ``DLRM``'s
    forward, the tree's tables concatenated in sorted column order for
    K13a (one copy of them a call) → logits [B]."""
    names, table, offsets, sizes = concatenate_tables(params["tables"])
    mh_names = sorted(params["mh_tables"])
    return _logits(lambda x: mlp_apply(params["bottom"], x, final_activation=True),
                   lambda x: mlp_apply(params["top"], x), table, offsets, sizes, None,
                   [batch[name] for name in names], _bags(mh_names, [params["mh_tables"][n] for n in mh_names], batch),
                   batch["dense"])


def reference_forward(model: DLRM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``model``'s forward through the plain versions of K13a, K13c, K13b
    and K19, on any device: what the kernel path is held against on the card.
    The lookups' gradients are autograd's through plain PyTorch operations;
    the interaction's are ``interaction_bwd_plain`` (``PlainInteraction``).
    The interaction takes K13b's fmaf steps in K13b's order, so that a
    bfloat16 cast after it sees the kernel path's float32 values (the
    plain versions are held against JAX's ``dot_general`` on the CPU). Not
    for sharded tables."""
    if model.shard is not None:
        raise ValueError("reference_forward takes a model whose tables are not sharded")
    bottom_out = model.bottom(batch["dense"], plain=True)
    ids = [batch[name] for name in model.names]
    feats = [bottom_out[:, None], embedding_gather_plain(model.table, ids, model.offsets, model.sizes)]
    feats += [embedding_bag_fwd_plain(t, v, m)[:, None] for t, v, m in model._bags(batch)]
    feats = torch.cat(feats, dim=1)
    top_in = torch.cat([bottom_out, dot_interaction_plain(feats)], dim=1)
    return model.top(top_in, plain=True).reshape(-1)


def dlrm_loss(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Binary cross-entropy of the logits against ``batch["label"]``, of a
    ``DLRM`` or of a params tree (``dlrm_forward``)."""
    logits = model(batch) if isinstance(model, nn.Module) else dlrm_forward(model, batch)
    return bce_with_logits(logits, batch["label"])


def dlrm_param_specs(model: DLRM, model_axis: str = "model") -> Dict[str, object]:
    """The JAX package's ``dlrm_param_specs`` as axis tuples, in the shape of
    its parameter pytree: each table row-sharded over ``model_axis``
    (``(model_axis, None)``), the MLPs replicated (``()``)."""

    def mlp(m):
        return [{"w": (), "b": ()} for _ in m.weights]

    return {
        "tables": {n: (model_axis, None) for n in model.names},
        "mh_tables": {n: (model_axis, None) for n in model.mh_names},
        "bottom": mlp(model.bottom),
        "top": mlp(model.top),
    }


def batch_specs(config: DLRMConfig, data_axis: str = "data") -> Dict[str, Tuple]:
    """The JAX package's ``batch_specs`` as axis tuples: every input split
    on its leading (batch) dimension over ``data_axis``."""
    specs: Dict[str, Tuple] = {"dense": (data_axis, None), "label": (data_axis,)}
    for name in config.cardinalities:
        specs[name] = (data_axis,)
    for name in config.multihot_cardinalities:
        specs[f"{name}__values"] = (data_axis, None)
        specs[f"{name}__mask"] = (data_axis, None)
    return specs


def make_synthetic_batch(config: DLRMConfig, batch_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Host-side synthetic batch matching the model's input contract."""
    rng = np.random.default_rng(seed)
    batch: Dict[str, np.ndarray] = {
        "dense": rng.normal(size=(batch_size, config.num_dense)).astype(np.float32),
        "label": rng.integers(0, 2, batch_size).astype(np.float32),
    }
    for name, card in config.cardinalities.items():
        batch[name] = rng.integers(0, card, batch_size).astype(np.int32)
    for name, card in config.multihot_cardinalities.items():
        L = config.multihot_max_len
        batch[f"{name}__values"] = rng.integers(0, card, (batch_size, L)).astype(np.int32)
        lengths = rng.integers(1, L + 1, batch_size)
        batch[f"{name}__mask"] = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    return batch
