"""Model layers: the counterpart of ``nvtabular_tpu/models/layers.py``.

* ``MLP`` — ``mlp_init`` / ``mlp_apply`` (:30-67) as an ``nn.Module`` whose
  weights keep JAX's ``[in, out]`` layout (``h @ w + b``), so parameters
  carry across without transposes; its rounds and layer epilogues are
  kernel K19 (``kernels/mlp_epilogue.py``).
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
from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels.bce import BCEWithLogits
from ..kernels.cin import cin
from ..kernels.embedding import embedding_features
from ..kernels.embedding_bag import embedding_bag
from ..kernels.interaction import dot_interaction
from ..kernels.mlp_epilogue import mlp_epilogue, round_tensors


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

    Init is He normal (``w ~ N(0, 2 / fan_in)``, ``b = 0``) from
    ``generator``.
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
        for fan_in, fan_out in zip(layer_sizes[:-1], layer_sizes[1:]):
            w = torch.randn((fan_in, fan_out), generator=generator, device=device) * math.sqrt(2.0 / fan_in)
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(torch.zeros(fan_out, device=device)))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        out_dtype = x.dtype
        cdt = self.compute_dtype
        h, *ws = round_tensors([x.float(), *self.weights], cdt, plain)
        n = len(ws)
        for i, (w, b) in enumerate(zip(ws, self.biases)):
            hidden = i < n - 1
            h = mlp_epilogue(torch.matmul(h, w), b, relu=hidden or self.final_activation,
                             round_dtype=cdt if hidden and cdt != torch.float32 else None, plain=plain)
        return h.to(out_dtype)


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
    x_k[b, i, d] * x_0[b, j, d]``. float32; other dtypes raise
    NotImplementedError. Through kernel K13d."""
    return cin(x_k, x_0, w)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable), with
    ``jax.grad``'s gradient: a tie of ``maximum`` at 0 splits it, and
    ``abs``'s is +1 at 0. Through kernel K20; ``plain=True`` runs its plain
    versions on any device (the reference side of a parity check)."""
    return BCEWithLogits.apply(logits.reshape(-1).float(), labels.reshape(-1).float(), plain)
