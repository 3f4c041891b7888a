"""Carry fitted state and model parameters across as plain numpy arrays.

The counterpart of carrying weights across: with identical fitted state,
two transforms must agree. The state is a dict

    {"categorify": {vocab_key: {"values_by_code": ndarray,
                                "num_buckets": int, "offset": int}},
     "normalize": {column: {"mean": float, "std": float}}}

which a caller can extract from the JAX package's fitted ops (the tests do)
or from this package's own (``fitted_state``).

DLRM parameters travel as the JAX package's pytree of numpy arrays,

    {"tables": {col: [V, D]}, "bottom": [{"w": [in, out], "b": [out]}, ...],
     "top": [...]}

(``load_dlrm_params`` / ``dlrm_params``). Nothing here imports the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .ops.categorify import Categorify, _Vocab
from .ops.normalize import Normalize


def load_fitted_state(workflow, state: Dict[str, Dict[str, Any]]) -> None:
    """Set every Categorify and Normalize op of ``workflow`` to ``state``;
    each op counts as freshly fitted (its device tables are rebuilt)."""
    cats = state.get("categorify", {})
    norms = state.get("normalize", {})
    for node in workflow.graph.nodes:
        op = node.op
        if isinstance(op, Categorify):
            op.clear()
            for key, _ in op._groups(node.selector):
                entry = cats[key]
                vocab = _Vocab(
                    np.asarray(entry["values_by_code"]),
                    np.zeros(len(entry["values_by_code"]), dtype=np.int64),
                    int(entry.get("num_buckets", 1)),
                )
                vocab.offset = int(entry.get("offset", 0))
                op.vocabs[key] = vocab
            op.mark_fitted()
        elif isinstance(op, Normalize):
            op.clear()
            for name in node.selector.names:
                op.means[name] = float(norms[name]["mean"])
                op.stds[name] = float(norms[name]["std"])
            op.mark_fitted()


def fitted_state(workflow) -> Dict[str, Dict[str, Any]]:
    """The fitted state of this package's ``workflow`` in the format above."""
    state: Dict[str, Dict[str, Any]] = {"categorify": {}, "normalize": {}}
    for node in workflow.graph.nodes:
        op = node.op
        if isinstance(op, Categorify):
            for key, vocab in op.vocabs.items():
                state["categorify"][key] = {
                    "values_by_code": vocab.values_by_code,
                    "num_buckets": vocab.num_buckets,
                    "offset": vocab.offset,
                }
        elif isinstance(op, Normalize):
            for name in op.means:
                state["normalize"][name] = {"mean": op.means[name], "std": op.stds[name]}
    return state


def _dlrm_tensors(model, tree):
    """(parameter, numpy value) pairs of ``model`` for a pytree in the
    format above; the tables are concatenated in sorted column order."""
    tables = tree["tables"]
    if sorted(tables) != model.names:
        raise ValueError(f"tables {sorted(tables)} do not match the model's {model.names}")
    if tree.get("mh_tables"):
        raise NotImplementedError("multihot tables are not ported yet (ROADMAP.md queue 2, K13c)")
    pairs = [(model.table, np.concatenate([np.asarray(tables[n]) for n in model.names]))]
    for mlp, layers in ((model.bottom, tree["bottom"]), (model.top, tree["top"])):
        if len(layers) != len(mlp.weights):
            raise ValueError(f"{len(layers)} layers given, the model has {len(mlp.weights)}")
        for w, b, layer in zip(mlp.weights, mlp.biases, layers):
            pairs += [(w, np.asarray(layer["w"])), (b, np.asarray(layer["b"]))]
    return pairs


@torch.no_grad()
def load_dlrm_params(model, params: Dict[str, Any], optimizer=None,
                     sum_of_squares: Optional[Dict[str, Any]] = None) -> None:
    """Set the port's ``DLRM`` to the JAX parameter pytree ``params`` (numpy
    arrays) and, when given, ``optimizer``'s accumulators to optax's
    ``sum_of_squares`` pytree of the same structure."""
    for p, value in _dlrm_tensors(model, params):
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"shape {tuple(value.shape)} does not match the parameter's {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    if sum_of_squares is not None:
        for p, value in _dlrm_tensors(model, sum_of_squares):
            optimizer.accumulator(p).copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def dlrm_params(model) -> Dict[str, Any]:
    """The port's ``DLRM`` parameters as the JAX pytree of numpy arrays."""

    def host(t):
        return t.detach().cpu().numpy()

    return {
        "tables": {n: host(model.table_rows(n)) for n in model.names},
        "mh_tables": {},
        "bottom": [{"w": host(w), "b": host(b)} for w, b in zip(model.bottom.weights, model.bottom.biases)],
        "top": [{"w": host(w), "b": host(b)} for w, b in zip(model.top.weights, model.top.biases)],
    }
