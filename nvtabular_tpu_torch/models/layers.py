"""Model layers: the counterpart of ``nvtabular_tpu/models/layers.py``.

* ``MLP`` — ``mlp_init`` / ``mlp_apply`` (:30-67) as an ``nn.Module`` whose
  weights keep JAX's ``[in, out]`` layout (``h @ w + b``), so parameters
  carry across without transposes.
* ``embedding_lookup``, ``multihot_embedding_lookup`` and
  ``dot_product_interaction`` over the hand-written kernels K13a, K13c and
  K13b (``kernels/embedding.py``, ``kernels/embedding_bag.py``,
  ``kernels/interaction.py``).
* ``bce_with_logits`` with the same stable expression (:144-150).

``xdeepfm_outer_product`` (K13d) is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels.embedding import embedding_features
from ..kernels.embedding_bag import embedding_bag
from ..kernels.interaction import dot_interaction


def _round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and held as float32."""
    return t if dtype == torch.float32 else t.to(dtype).to(torch.float32)


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
    Gradients round where JAX's transposes round: autograd of each cast
    rounds the gradient that flows back through it.

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = x.dtype
        h = _round_to(x.float(), self.compute_dtype)
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = h @ _round_to(w, self.compute_dtype) + b
            if i < n - 1 or self.final_activation:
                h = torch.relu(h)
            if i < n - 1:
                h = _round_to(h, self.compute_dtype)
        return h.to(out_dtype)


def embedding_lookup(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table [V, D], int32 indices [B] → [B, D], with ``jnp.take``'s
    out-of-range rules (a negative id wraps once; an id still out of range
    gives a NaN row and no gradient). Through kernel K13a."""
    feats = embedding_features(None, table, [indices], [0], [table.shape[0]])
    return feats[:, 0]


def dot_product_interaction(features: torch.Tensor, self_interaction: bool = False) -> torch.Tensor:
    """features [B, F, D] float32 → [B, F*(F-1)/2]: the dot products of the
    distinct feature pairs in ``np.tril_indices(F, -1)`` order. Through
    kernel K13b."""
    if self_interaction:
        raise NotImplementedError(
            "dot_product_interaction(self_interaction=True) is not ported yet: kernel K13b "
            "computes the strict lower triangle (ROADMAP.md queue 1 item 9)"
        )
    return dot_interaction(features)


def multihot_embedding_lookup(table: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                              combiner: str = "mean") -> torch.Tensor:
    """EmbeddingBag over padded multihot values: table [V, D], int32 values
    [B, L] and float32 mask [B, L] (1 = a real value) → [B, D], the masked
    sum of the rows divided by ``max(sum(mask), 1)`` for ``"mean"``, with
    ``jnp.take``'s out-of-range rules. Through kernel K13c."""
    return embedding_bag(table, values, mask, combiner)


def xdeepfm_outer_product(x_k, x_0, w):
    raise NotImplementedError("xdeepfm_outer_product is not ported yet (ROADMAP.md queue 2, K13d)")


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable)."""
    logits = logits.reshape(-1).float()
    labels = labels.reshape(-1).float()
    # torch.maximum, like jnp.maximum, splits the gradient of a tie
    zero = torch.zeros_like(logits)
    return torch.mean(torch.maximum(logits, zero) - logits * labels + torch.log1p(torch.exp(-logits.abs())))
