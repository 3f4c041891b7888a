"""Carry fitted state across workflows as plain numpy arrays and floats.

The counterpart of carrying weights across: with identical fitted state,
two transforms must agree. The state is a dict

    {"categorify": {vocab_key: {"values_by_code": ndarray,
                                "num_buckets": int, "offset": int}},
     "normalize": {column: {"mean": float, "std": float}}}

which a caller can extract from the JAX package's fitted ops (the tests do)
or from this package's own (``fitted_state``). Nothing here imports the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

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
