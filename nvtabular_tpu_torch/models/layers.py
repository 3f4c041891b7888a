"""Model layers: the counterpart of ``nvtabular_tpu/models/layers.py``.

* ``mlp_init`` / ``mlp_apply`` (:30-67) over a list of ``{"w", "b"}``
  layers, the weights in JAX's ``[in, out]`` layout (``h @ w + b``), so
  parameters carry across without transposes; ``MLP`` is the same stack as
  an ``nn.Module`` whose forward is ``mlp_apply`` of its own layers. The
  rounds and layer epilogues are kernel K19 (``kernels/mlp_epilogue.py``).
  ``rng`` is a ``torch.Generator`` or a seed (``make_generator``): the
  values are torch's, not ``jax.random``'s.
* ``embedding_lookup``, ``multihot_embedding_lookup``,
  ``dot_product_interaction`` and ``xdeepfm_outer_product`` over the
  hand-written kernels K13a, K13c, K13b and K13d (``kernels/embedding.py``,
  ``kernels/embedding_bag.py``, ``kernels/interaction.py``,
  ``kernels/cin.py``).
* ``bce_with_logits`` with the same stable expression (:144-150), kernel
  K20 (``kernels/bce.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from ..kernels.bce import BCEWithLogits
from ..kernels.cin import cin
from ..kernels.embedding import embedding_features
from ..kernels.embedding_bag import embedding_bag
from ..kernels.interaction import dot_interaction
from ..kernels.mlp_epilogue import mlp_epilogue, round_tensors
from ..workflow.workflow import resolve_device

Rng = Union[torch.Generator, int]


def make_generator(rng: Rng, device=None) -> torch.Generator:
    """``rng`` itself if it is a ``torch.Generator`` (the draws follow its
    device), else a generator seeded with it on ``device`` (``cuda:0``
    unless the caller passes another)."""
    if isinstance(rng, torch.Generator):
        if device is not None and torch.device(device) != rng.device:
            raise ValueError(f"the generator lives on {rng.device}, not on {device}")
        return rng
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(rng))
    return gen


def _he_normal(layer_sizes: Sequence[int], generator: Optional[torch.Generator], device,
               dtype: torch.dtype = torch.float32) -> List[Dict[str, torch.Tensor]]:
    """``w ~ N(0, 2 / fan_in)`` [in, out] and ``b = 0`` for each layer, drawn
    from ``generator`` (torch's default one for ``device`` where None)."""
    return [
        {"w": torch.randn((fan_in, fan_out), generator=generator, device=device, dtype=dtype) * math.sqrt(2.0 / fan_in),
         "b": torch.zeros(fan_out, device=device, dtype=dtype)}
        for fan_in, fan_out in zip(layer_sizes[:-1], layer_sizes[1:])
    ]


def mlp_init(rng: Rng, layer_sizes: Sequence[int], dtype: torch.dtype = torch.float32,
             device=None) -> List[Dict[str, torch.Tensor]]:
    """He-initialized dense stack, ``layer_sizes = [in, h1, ..., out]``: a
    list of ``{"w": [in, out], "b": [out]}``."""
    gen = make_generator(rng, device)
    return _he_normal(layer_sizes, gen, gen.device, dtype)


def mlp_apply(params: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor, final_activation: bool = False,
              compute_dtype: torch.dtype = torch.bfloat16, plain: bool = False) -> torch.Tensor:
    """The stack with ReLU between layers, numerics as ``MLP`` describes;
    ``plain=True`` runs K19's plain versions."""
    out_dtype = x.dtype
    h, *ws = round_tensors([x.float(), *(layer["w"] for layer in params)], compute_dtype, plain)
    n = len(ws)
    for i, (w, layer) in enumerate(zip(ws, params)):
        hidden = i < n - 1
        h = mlp_epilogue(torch.matmul(h, w), layer["b"], relu=hidden or final_activation,
                         round_dtype=compute_dtype if hidden and compute_dtype != torch.float32 else None,
                         plain=plain)
    return h.to(out_dtype)


def concatenate_tables(tables: Dict[str, torch.Tensor]):
    """A params tree's ``{column: [V, D]}`` tables as the modules keep them:
    (the columns sorted, their tables concatenated in that order [sum V, D]
    (one copy, a table alone none), each table's row offset, its rows)."""
    names = sorted(tables)
    parts = [tables[n] for n in names]
    sizes = [int(t.shape[0]) for t in parts]
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    return names, parts[0] if len(parts) == 1 else torch.cat(parts), offsets, sizes


class MLP(nn.Module):
    """Dense stack with ReLU between layers: ``layer_sizes = [in, h1, ..., out]``.

    ``mlp_apply``'s numerics: inputs and weights are rounded to
    ``compute_dtype`` (bfloat16 by default), each product accumulates in and
    returns float32, the bias is added in float32, then ReLU, and the result
    is rounded to ``compute_dtype`` between layers; the output is float32.
    The rounded values are multiplied as float32 tensors, so every product
    of two bfloat16 values is exact and only the float32 sums round: this
    needs float32 matrix products in full float32, which is PyTorch's default
    on CUDA (``torch.backends.cuda.matmul.allow_tf32`` False). A bfloat16
    ``torch.matmul`` would round its output to bfloat16 before the bias.
    Gradients round where JAX's transposes round: the transpose of each
    cast rounds the gradient that flows back through it. ReLU follows
    ``jax.nn.relu``: +0.0 for -0.0, NaN for NaN, and its gradient
    ``where(z > 0, g, 0)``.

    The input and every weight are rounded in one ``round_group`` launch,
    each product is ``torch.matmul`` and each layer's bias, ReLU and round
    one ``mlp_epilogue_fwd`` launch (kernel K19; their gradients one
    ``mlp_epilogue_bwd`` a layer and one ``round_group``). ``plain=True``
    runs K19's plain versions instead, on any device: the reference
    forwards that the kernels are held against.

    Init is ``mlp_init``'s from ``generator``; ``forward`` is ``mlp_apply``
    of ``layers()``.
    """

    def __init__(
        self,
        layer_sizes: Sequence[int],
        final_activation: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.final_activation = final_activation
        self.compute_dtype = compute_dtype
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for layer in _he_normal(layer_sizes, generator, device):
            self.weights.append(nn.Parameter(layer["w"]))
            self.biases.append(nn.Parameter(layer["b"]))

    def layers(self) -> List[Dict[str, torch.Tensor]]:
        """The parameters as ``mlp_init``'s list of ``{"w", "b"}``."""
        return [{"w": w, "b": b} for w, b in zip(self.weights, self.biases)]

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return mlp_apply(self.layers(), x, self.final_activation, self.compute_dtype, plain)


def embedding_lookup(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table [V, D], int32 indices [B] → [B, D], with ``jnp.take``'s
    out-of-range rules (a negative id wraps once; an id still out of range
    gives a NaN row and no gradient). Through kernel K13a."""
    feats = embedding_features(None, table, [indices], [0], [table.shape[0]])
    return feats[:, 0]


def dot_product_interaction(features: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    """features [B, F, D] float32 → [B, F*(F-1)/2]: the dot products of the
    distinct feature pairs in ``np.tril_indices(F, -1)`` order; with
    ``self_interaction`` → [B, F*(F+1)/2], the pairs of
    ``np.tril_indices(F, 0)``, each feature's dot with itself included.
    Through kernel K13b."""
    return dot_interaction(features, self_interaction=self_interaction)


def multihot_embedding_lookup(table: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                              combiner: str = "mean") -> torch.Tensor:
    """EmbeddingBag over padded multihot values: table [V, D], int32 values
    [B, L] and float32 mask [B, L] (1 = a real value) → [B, D], the masked
    sum of the rows divided by ``max(sum(mask), 1)`` for ``"mean"``, with
    ``jnp.take``'s out-of-range rules. Through kernel K13c."""
    return embedding_bag(table, values, mask, combiner)


def xdeepfm_outer_product(x_k: torch.Tensor, x_0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xDeepFM's Compressed Interaction Network layer: x_k [B, H_k, D] (the
    current layer), x_0 [B, F, D] (the raw embeddings; may be x_k itself)
    and w [H_k * F, H_next] → [B, H_next, D], ``sum_{i, j} w[i * F + j, h] *
    x_k[b, i, d] * x_0[b, j, d]``. x_k and x_0 in one of float32, bfloat16
    and float16 (the output's dtype), w in theirs or float32; 16 bits round
    where the reference's casts round (``kernels/cin.py``). Through kernel
    K13d."""
    return cin(x_k, x_0, w)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable), with
    ``jax.grad``'s gradient: a tie of ``maximum`` at 0 splits it, and
    ``abs``'s is +1 at 0. Through kernel K20; ``plain=True`` runs its plain
    versions on any device (the reference side of a parity check)."""
    return BCEWithLogits.apply(logits.reshape(-1).float(), labels.reshape(-1).float(), plain)
