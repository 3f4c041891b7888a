"""DLRM: the counterpart of ``nvtabular_tpu/models/dlrm.py``.

The model reads the training batches of ``loader.DeviceLoader``: ``dense``
float32 [B, num_dense], one int32 [B] code tensor per categorical column and
``label``. Its embedding tables live in one concatenated float32
``[sum V, D]`` parameter, the columns' tables in sorted name order (the
feature order of ``dlrm_forward``), which the gather kernel K13a indexes
through per-column row offsets; the gathered rows land in slots 1..C of the
[B, 1 + C, D] features after the bottom MLP's output, and the interaction
kernel K13b writes its pair dots after the bottom output in the top MLP's
input. Multihot tables and ``vocab_pad_multiple > 1`` (row sharding) are not
ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels.embedding import embedding_features, embedding_gather_plain
from ..kernels.interaction import dot_interaction, interaction_fwd_plain
from ..workflow.workflow import resolve_device
from .layers import MLP, bce_with_logits


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


class DLRM(nn.Module):
    """``forward(batch)`` is ``dlrm_forward``: logits [B]. Parameters are
    drawn on ``device`` (``cuda:0`` unless the caller passes another) from a
    ``torch.Generator`` seeded with ``seed``, with ``dlrm_init``'s
    distributions: tables ``N(0, 1) / sqrt(D)``, MLPs He normal. The MLPs
    compute in ``compute_dtype`` as ``mlp_apply`` does (bfloat16 by default)."""

    def __init__(self, config: DLRMConfig, seed: int = 0, device=None, compute_dtype=torch.bfloat16):
        super().__init__()
        if config.multihot_cardinalities:
            raise NotImplementedError(
                "DLRM with multihot tables is not ported yet "
                "(ROADMAP.md queue 1 item 9: DLRM multihot tables through K13c)"
            )
        if config.vocab_pad_multiple != 1:
            raise NotImplementedError(
                "DLRM with vocab_pad_multiple > 1 (row-sharded tables) is not ported yet "
                "(ROADMAP.md queue 1 item 10)"
            )
        if config.self_interaction:
            raise NotImplementedError(
                "DLRM with self_interaction=True is not ported yet (ROADMAP.md queue 1 item 9)"
            )
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        d = config.embedding_dim
        self.config = config
        self.names = sorted(config.cardinalities)
        self.sizes = [int(config.cardinalities[n]) for n in self.names]
        self.offsets = [int(o) for o in np.concatenate([[0], np.cumsum(self.sizes)[:-1]])] if self.sizes else []
        rows = sum(self.sizes)
        self.table = nn.Parameter(torch.randn((rows, d), generator=gen, device=dev).mul_(1.0 / math.sqrt(d)))
        self.bottom = MLP(
            [config.num_dense, *config.bottom_mlp, d], final_activation=True,
            compute_dtype=compute_dtype, generator=gen, device=dev,
        )
        self.top = MLP(
            [d + config.interaction_dim, *config.top_mlp, 1],
            compute_dtype=compute_dtype, generator=gen, device=dev,
        )

    def table_rows(self, name: str) -> torch.Tensor:
        """The rows of column ``name``'s table: a view of ``self.table``."""
        i = self.names.index(name)
        return self.table[self.offsets[i] : self.offsets[i] + self.sizes[i]]

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        bottom_out = self.bottom(batch["dense"])  # [B, D]
        ids = [batch[name] for name in self.names]
        feats = embedding_features(bottom_out, self.table, ids, self.offsets, self.sizes)  # [B, F, D]
        top_in = dot_interaction(feats, bottom_out)  # [B, D + F(F-1)/2]
        return self.top(top_in).reshape(-1)


def reference_forward(model: DLRM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``model``'s forward through the plain versions of K13a and K13b, with
    autograd through plain PyTorch operations, on any device: what the
    kernel path is held against on the card."""
    bottom_out = model.bottom(batch["dense"])
    ids = [batch[name] for name in model.names]
    emb = embedding_gather_plain(model.table, ids, model.offsets, model.sizes)
    feats = torch.cat([bottom_out[:, None], emb], dim=1)
    top_in = torch.cat([bottom_out, interaction_fwd_plain(feats)], dim=1)
    return model.top(top_in).reshape(-1)


def dlrm_loss(model: DLRM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return bce_with_logits(model(batch), batch["label"])


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
