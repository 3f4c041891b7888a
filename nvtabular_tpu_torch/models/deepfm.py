"""DeepFM and DCN-v2: the counterpart of ``nvtabular_tpu/models/deepfm.py``.

Both read DLRM's batch (``dense`` float32 [B, num_dense], one int32 [B]
code tensor per categorical column, ``label``) and keep their embedding
tables in one concatenated float32 ``[sum V, D]`` parameter in sorted
column order, as ``DLRM`` does. Their features are one [B, F*D + num_dense]
row: kernel K13a gathers the F tables straight into its first F*D columns
and the dense features fill the rest (``embedding_row``), the JAX forwards'
``jnp.concatenate``.

* ``DeepFM`` (Guo et al. 2017): that row is the deep tower's input; its
  [B, F, D] view and dense block are the input of kernel K16, the FM's
  first- and second-order terms (``kernels/fm.py``), whose first-order
  weights of every table live in one [sum V] parameter ``linear``.
* ``DCN`` (DCN-v2, Wang et al. 2021): the row is x0; each cross layer is
  ``x0 * (bf16(x) @ bf16(W) + b) + x``, the product a plain ``torch.matmul``
  of bfloat16-rounded float32 values (``MLP``'s numerics: x and W rounded in
  one K19 ``round_group`` launch) and the rest kernel K17
  (``kernels/cross.py``); the deep tower reads x0, and the output layer the
  cross output and the tower's side by side.

``compute_dtype`` (bfloat16 by default, as the JAX code) covers the MLPs
and the cross products. Each table (and each ``linear`` block) has
``padded_cardinality`` rows, as ``deepfm_init`` and ``dcn_init`` pad them;
the JAX package shards neither family's tables, and neither does the port.

``deepfm_init`` / ``deepfm_forward`` and ``dcn_init`` / ``dcn_forward`` are
the JAX package's functional pairs over its params trees: each init draws
what the module draws (the tables, and DeepFM's ``linear`` blocks, views of
one concatenated tensor), and each forward runs the module's forward over
the tree, its tables concatenated for K13a on each call (one copy).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels.cross import cross_fwd_plain, cross_layer
from ..kernels.embedding import embedding_gather_plain, embedding_row
from ..kernels.fm import fm_fwd_plain, fm_terms
from ..kernels.mlp_epilogue import round_tensors
from .layers import MLP, Rng, bce_with_logits, concatenate_tables, make_generator, mlp_apply
from .pytree import tree_map


class _TableConfig:
    """What both configs share: the padded vocabulary size and the width
    of the feature row (the gathered fields, then the dense features)."""

    def padded_cardinality(self, n: int) -> int:
        m = self.vocab_pad_multiple
        return ((n + m - 1) // m) * m

    @property
    def input_dim(self) -> int:
        return len(self.cardinalities) * self.embedding_dim + self.num_dense


@dataclass
class DeepFMConfig(_TableConfig):
    cardinalities: Dict[str, int]
    num_dense: int
    embedding_dim: int = 16
    deep_mlp: Tuple[int, ...] = (256, 128)
    vocab_pad_multiple: int = 1


@dataclass
class DCNConfig(_TableConfig):
    cardinalities: Dict[str, int]
    num_dense: int
    embedding_dim: int = 16
    num_cross_layers: int = 3
    deep_mlp: Tuple[int, ...] = (256, 128)
    vocab_pad_multiple: int = 1


def _feature_row(table, ids, offsets, sizes, batch) -> torch.Tensor:
    """[B, F*D + num_dense]: the gathered fields (K13a), then the dense features."""
    return embedding_row(table, ids, offsets, sizes, batch["dense"].to(torch.float32))


class _Tables(nn.Module):
    """The concatenated embedding tables and the feature row of a batch."""

    def _init_tables(self, config, seed: Rng, device) -> torch.Generator:
        gen = make_generator(seed, device)
        dev = gen.device
        d = config.embedding_dim
        self.config = config
        self.names = sorted(config.cardinalities)
        self.sizes = [config.padded_cardinality(int(config.cardinalities[n])) for n in self.names]
        self.offsets = [int(o) for o in np.concatenate([[0], np.cumsum(self.sizes)[:-1]])] if self.sizes else []
        rows = sum(self.sizes)
        self.table = nn.Parameter(torch.randn((rows, d), generator=gen, device=dev).mul_(1.0 / math.sqrt(d)))
        return gen

    def table_rows(self, name: str) -> torch.Tensor:
        """The rows of column ``name``'s table: a view of ``self.table``."""
        i = self.names.index(name)
        return self.table[self.offsets[i] : self.offsets[i] + self.sizes[i]]

    def ids(self, batch):
        return [batch[name] for name in self.names]

    def features(self, batch) -> torch.Tensor:
        """[B, F*D + num_dense]: the gathered fields, then the dense features."""
        return _feature_row(self.table, self.ids(batch), self.offsets, self.sizes, batch)

    def reference_features(self, batch) -> torch.Tensor:
        """The same row through K13a's plain version and ``torch.cat``."""
        emb = embedding_gather_plain(self.table, self.ids(batch), self.offsets, self.sizes)
        return torch.cat([emb.flatten(1), batch["dense"].to(torch.float32)], dim=1)


class DeepFM(_Tables):
    """``forward(batch)`` is ``deepfm_forward``: logits [B]. Parameters are
    drawn on ``device`` (``cuda:0`` unless the caller passes another) from a
    ``torch.Generator`` seeded with ``seed`` (or ``seed`` itself where it is
    a generator), with ``deepfm_init``'s distributions: tables ``N(0, 1) /
    sqrt(D)``, ``linear`` zeros, ``dense_w`` ``N(0, 1) * 0.01``, the deep
    tower He normal, ``bias`` 0."""

    def __init__(self, config: DeepFMConfig, seed: Rng = 0, device=None, compute_dtype=torch.bfloat16):
        super().__init__()
        gen = self._init_tables(config, seed, device)
        dev = self.table.device
        self.linear = nn.Parameter(torch.zeros(self.table.shape[0], device=dev))
        self.dense_w = nn.Parameter(torch.randn(config.num_dense, generator=gen, device=dev).mul_(0.01))
        self.deep = MLP(
            [config.input_dim, *config.deep_mlp, 1], compute_dtype=compute_dtype, generator=gen, device=dev,
        )
        self.bias = nn.Parameter(torch.zeros((), device=dev))

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as ``deepfm_init``'s tree: each table and each
        ``linear`` block a view of the concatenated parameter."""
        return {
            "tables": {n: self.table_rows(n) for n in self.names},
            "linear": {n: self.linear[o : o + s] for n, o, s in zip(self.names, self.offsets, self.sizes)},
            "dense_w": self.dense_w,
            "deep": self.deep.layers(),
            "bias": self.bias,
        }

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _deepfm_logits(self.table, self.linear, self.dense_w, self.deep, self.bias, self.ids(batch),
                              self.offsets, self.sizes, batch)


def _deepfm_logits(table, linear, dense_w, deep, bias, ids, offsets, sizes, batch) -> torch.Tensor:
    """``deepfm_forward``: the feature row, K16's FM terms over it, the deep
    tower (``deep``) and the bias → logits [B]."""
    x = _feature_row(table, ids, offsets, sizes, batch)
    fm = fm_terms(x, linear, dense_w, ids, offsets, sizes, table.shape[1])
    return fm + deep(x).reshape(-1) + bias


def deepfm_init(rng: Rng, config: DeepFMConfig, device=None) -> Dict[str, Any]:
    """The JAX package's ``deepfm_init``: ``DeepFM(config, rng, device)``'s
    parameters as its tree, detached (torch's draws, not ``jax.random``'s)."""
    return tree_map(torch.Tensor.detach, DeepFM(config, rng, device).param_tree())


def deepfm_forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``deepfm_forward`` over a params tree: ``DeepFM``'s
    forward → logits [B]."""
    names, table, offsets, sizes = concatenate_tables(params["tables"])
    linear = torch.cat([params["linear"][n] for n in names])
    return _deepfm_logits(table, linear, params["dense_w"], lambda x: mlp_apply(params["deep"], x), params["bias"],
                          [batch[n] for n in names], offsets, sizes, batch)


def deepfm_reference_forward(model: DeepFM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``model``'s forward through the plain versions of K13a, K16 and K19,
    with autograd through plain PyTorch operations, on any device: what the
    kernel path is held against on the card."""
    x = model.reference_features(batch)
    FD = len(model.names) * model.config.embedding_dim
    v, dense = x[:, :FD].unflatten(1, (len(model.names), model.config.embedding_dim)), x[:, FD:]
    fm = fm_fwd_plain(v, dense, model.ids(batch), model.offsets, model.sizes, model.linear, model.dense_w)
    return fm + model.deep(x, plain=True).reshape(-1) + model.bias


def deepfm_loss(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Binary cross-entropy of the logits, of a ``DeepFM`` or a params tree."""
    logits = model(batch) if isinstance(model, nn.Module) else deepfm_forward(model, batch)
    return bce_with_logits(logits, batch["label"])


def cross_apply(layers, x0: torch.Tensor, compute_dtype=torch.bfloat16, plain: bool = False) -> torch.Tensor:
    """The DCN-v2 cross stack over ``[{"w": [N, N], "b": [N]}, ...]``: each
    layer ``x0 * (round(x) @ round(W) + b) + x``, as ``CrossNetwork`` says."""
    epilogue = cross_fwd_plain if plain else cross_layer
    x = x0
    for layer in layers:
        xr, wr = round_tensors([x, layer["w"]], compute_dtype, plain)
        x = epilogue(xr @ wr, layer["b"], x0, x)
    return x


class CrossNetwork(nn.Module):
    """The DCN-v2 cross stack: ``num_layers`` layers of W [N, N] (init
    ``N(0, 1) / sqrt(N)``) and b [N] (zeros). Each product multiplies the
    ``compute_dtype``-rounded x and W as float32 tensors (TF32 off), as
    ``MLP`` does, giving JAX's ``preferred_element_type=float32`` result;
    the rounds' transposes round the gradients where JAX's transposes round.
    ``plain=True`` runs the plain versions of K19's round and of K17."""

    def __init__(self, dim: int, num_layers: int, compute_dtype=torch.bfloat16, generator=None, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weights = nn.ParameterList(
            nn.Parameter(torch.randn((dim, dim), generator=generator, device=device).mul_(1.0 / math.sqrt(dim)))
            for _ in range(num_layers)
        )
        self.biases = nn.ParameterList(nn.Parameter(torch.zeros(dim, device=device)) for _ in range(num_layers))

    def layers(self):
        return [{"w": w, "b": b} for w, b in zip(self.weights, self.biases)]

    def forward(self, x0: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return cross_apply(self.layers(), x0, self.compute_dtype, plain)


class DCN(_Tables):
    """``forward(batch)`` is ``dcn_forward``: logits [B]. Parameters are
    drawn as in ``DeepFM`` with ``dcn_init``'s distributions: tables
    ``N(0, 1) / sqrt(D)``, the cross layers as ``CrossNetwork`` says, the
    deep tower and the output layer He normal."""

    def __init__(self, config: DCNConfig, seed: Rng = 0, device=None, compute_dtype=torch.bfloat16):
        super().__init__()
        gen = self._init_tables(config, seed, device)
        dev = self.table.device
        dim = config.input_dim
        self.cross = CrossNetwork(dim, config.num_cross_layers, compute_dtype, generator=gen, device=dev)
        self.deep = MLP(
            [dim, *config.deep_mlp], final_activation=True, compute_dtype=compute_dtype, generator=gen, device=dev,
        )
        out_in = dim + (config.deep_mlp[-1] if config.deep_mlp else 0)
        self.out = MLP([out_in, 1], compute_dtype=compute_dtype, generator=gen, device=dev)

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as ``dcn_init``'s tree: each table a view of
        ``self.table``."""
        return {
            "tables": {n: self.table_rows(n) for n in self.names},
            "cross": self.cross.layers(),
            "deep": self.deep.layers(),
            "out": self.out.layers(),
        }

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x0 = self.features(batch)
        return self._head(x0, self.cross(x0))

    def _head(self, x0: torch.Tensor, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return _dcn_head(x0, x, lambda v: self.deep(v, plain), lambda v: self.out(v, plain))


def _dcn_head(x0, x, deep, out) -> torch.Tensor:
    """``dcn_forward``'s head: the output layer (``out``) over the cross
    output ``x`` and the deep tower's (``deep``) of ``x0`` → logits [B]."""
    return out(torch.cat([x, deep(x0)], dim=1)).reshape(-1)


def dcn_init(rng: Rng, config: DCNConfig, device=None) -> Dict[str, Any]:
    """The JAX package's ``dcn_init``: ``DCN(config, rng, device)``'s
    parameters as its tree, detached (torch's draws, not ``jax.random``'s)."""
    return tree_map(torch.Tensor.detach, DCN(config, rng, device).param_tree())


def dcn_forward(params: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``dcn_forward`` over a params tree: ``DCN``'s
    forward → logits [B]."""
    names, table, offsets, sizes = concatenate_tables(params["tables"])
    x0 = _feature_row(table, [batch[n] for n in names], offsets, sizes, batch)
    return _dcn_head(x0, cross_apply(params["cross"], x0), lambda v: mlp_apply(params["deep"], v, True),
                     lambda v: mlp_apply(params["out"], v))


def dcn_reference_forward(model: DCN, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``model``'s forward through the plain versions of K13a, K17 and K19,
    with autograd through plain PyTorch operations, on any device."""
    x0 = model.reference_features(batch)
    return model._head(x0, model.cross(x0, plain=True), plain=True)


def dcn_loss(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Binary cross-entropy of the logits, of a ``DCN`` or a params tree."""
    logits = model(batch) if isinstance(model, nn.Module) else dcn_forward(model, batch)
    return bce_with_logits(logits, batch["label"])
