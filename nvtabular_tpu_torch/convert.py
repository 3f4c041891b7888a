"""Carry fitted state and model parameters across as plain numpy arrays.

The counterpart of carrying weights across: with identical fitted state,
two transforms must agree. The state is a dict

    {"categorify": {vocab_key: {"values_by_code": ndarray,
                                "num_buckets": int, "offset": int}},
     "normalize": {column: {"mean": float, "std": float}},
     "target_encoding": {group_tag: {"means": {target: float},
                                     "fold_stats": keyed, "overall_stats": keyed}},
     "join_groupby": {group_name: keyed}}

with ``keyed = {"key_cols": [...], "key_arrays": {column: ndarray},
"stats": {name: ndarray}}`` — a fitted ``KeyedStats`` (a multi-column group
has one key array a column). A combo group's ``values_by_code`` are its
member tuples, int [V, k], in code order; the JAX package's, the members
joined by "_" as strings (``categorify.py:1827-1840``), are parsed into
that form. Group stats are keyed
by group, as the reference names its stat files (``te_stats.{tag}``,
``cat_stats.{name}``). A caller can extract the state from the JAX package's
fitted ops (the tests do) or from this package's own (``fitted_state``),
e.g. to carry a workflow fitted on the card to one on the CPU.

DLRM parameters travel as the JAX package's pytree of numpy arrays,

    {"tables": {col: [V, D]}, "bottom": [{"w": [in, out], "b": [out]}, ...],
     "top": [...]}

(``load_dlrm_params`` / ``dlrm_params``), and tabular MLP parameters as

    {"tables": {col: [V, D]}, "mh_tables": {col: [V, D]},
     "mlp": [{"w": [in, out], "b": [out]}, ...]}

(``load_tabular_mlp_params`` / ``tabular_mlp_params``). Nothing here
imports the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .ops.categorify import Categorify, _Vocab
from .ops.groupby_stats import KeyedStats, key_groups
from .ops.join_groupby import JoinGroupby
from .ops.normalize import Normalize
from .ops.target_encoding import TargetEncoding


def _keyed(entry: Dict[str, Any]) -> KeyedStats:
    return KeyedStats(
        list(entry["key_cols"]),
        {k: np.asarray(v) for k, v in entry["stats"].items()},
        {k: np.asarray(v) for k, v in entry["key_arrays"].items()},
    )


def _keyed_state(keyed: KeyedStats) -> Dict[str, Any]:
    return {"key_cols": list(keyed.key_cols), "key_arrays": dict(keyed.key_arrays), "stats": dict(keyed.stats)}


def _combo_tuples(values: np.ndarray, width: int) -> np.ndarray:
    """A combo vocabulary as int64 [V, width] tuples: kept if it is one,
    parsed from "_"-joined strings otherwise."""
    if values.ndim == 2:
        return values.astype(np.int64)
    parts = [str(v).split("_") for v in values]
    if any(len(p) != width for p in parts):
        raise ValueError(f"combo values {values[:3]!r} are not {width} '_'-joined integers")
    return np.array(parts, dtype=np.int64).reshape(len(parts), width)


def load_fitted_state(workflow, state: Dict[str, Dict[str, Any]]) -> None:
    """Set every Categorify, Normalize, TargetEncoding and JoinGroupby op of
    ``workflow`` to ``state``; each op counts as freshly fitted (its device
    tables are rebuilt)."""
    cats = state.get("categorify", {})
    norms = state.get("normalize", {})
    tes = state.get("target_encoding", {})
    joins = state.get("join_groupby", {})
    for node in workflow.graph.nodes:
        op = node.op
        if isinstance(op, Categorify):
            op.clear()
            for key, members in op._groups(node.selector):
                entry = cats[key]
                values = np.asarray(entry["values_by_code"])
                if op._is_combo(members):
                    values = _combo_tuples(values, len(members))
                vocab = _Vocab(
                    values,
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
        elif isinstance(op, TargetEncoding):
            op.clear()
            for group in key_groups(node.selector):
                entry = tes[op._group_tag(group)]
                op.means.update({t: float(m) for t, m in entry["means"].items()})
                op.fold_stats[op._group_tag(group)] = _keyed(entry["fold_stats"])
                op.overall_stats[op._group_tag(group)] = _keyed(entry["overall_stats"])
            op.mark_fitted()
        elif isinstance(op, JoinGroupby):
            op.clear()
            for group in key_groups(node.selector):
                op.keyed[op._group_name(group)] = _keyed(joins[op._group_name(group)])
            op.mark_fitted()


def fitted_state(workflow) -> Dict[str, Dict[str, Any]]:
    """The fitted state of this package's ``workflow`` in the format above."""
    state: Dict[str, Dict[str, Any]] = {"categorify": {}, "normalize": {}, "target_encoding": {}, "join_groupby": {}}
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
        elif isinstance(op, TargetEncoding):
            for tag, overall in op.overall_stats.items():
                state["target_encoding"][tag] = {
                    "means": dict(op.means),
                    "fold_stats": _keyed_state(op.fold_stats[tag]),
                    "overall_stats": _keyed_state(overall),
                }
        elif isinstance(op, JoinGroupby):
            for name, keyed in op.keyed.items():
                state["join_groupby"][name] = _keyed_state(keyed)
    return state


def _dlrm_tensors(model, tree):
    """(parameter, numpy value) pairs of ``model`` for a pytree in the
    format above; the tables are concatenated in sorted column order."""
    if tree.get("mh_tables"):
        raise NotImplementedError(
            "DLRM multihot tables are not ported yet (ROADMAP.md queue 1 item 9: DLRM multihot tables through K13c)"
        )
    tables = tree["tables"]
    if sorted(tables) != model.names:
        raise ValueError(f"tables {sorted(tables)} do not match the model's {model.names}")
    pairs = [(model.table, np.concatenate([np.asarray(tables[n]) for n in model.names]))]
    for mlp, layers in ((model.bottom, tree["bottom"]), (model.top, tree["top"])):
        pairs += _mlp_tensors(mlp, layers)
    return pairs


def _mlp_tensors(mlp, layers):
    if len(layers) != len(mlp.weights):
        raise ValueError(f"{len(layers)} layers given, the model has {len(mlp.weights)}")
    pairs = []
    for w, b, layer in zip(mlp.weights, mlp.biases, layers):
        pairs += [(w, np.asarray(layer["w"])), (b, np.asarray(layer["b"]))]
    return pairs


def _tabular_tensors(model, tree):
    """(parameter, numpy value) pairs of a ``TabularMLP`` for a pytree in the
    format above: one parameter a table, in sorted column order."""
    tables, mh = tree["tables"], tree.get("mh_tables", {})
    if sorted(tables) != model.names or sorted(mh) != model.mh_names:
        raise ValueError(
            f"tables {sorted(tables)} and {sorted(mh)} do not match the model's {model.names} and {model.mh_names}"
        )
    pairs = [(p, np.asarray(tables[n])) for p, n in zip(model.tables, model.names)]
    pairs += [(p, np.asarray(mh[n])) for p, n in zip(model.mh_tables, model.mh_names)]
    return pairs + _mlp_tensors(model.mlp, tree["mlp"])


@torch.no_grad()
def _load(pairs, optimizer, sos_pairs) -> None:
    for p, value in pairs:
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"shape {tuple(value.shape)} does not match the parameter's {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    for p, value in sos_pairs:
        optimizer.accumulator(p).copy_(torch.from_numpy(np.array(value, dtype=np.float32)))


def load_dlrm_params(model, params: Dict[str, Any], optimizer=None,
                     sum_of_squares: Optional[Dict[str, Any]] = None) -> None:
    """Set the port's ``DLRM`` to the JAX parameter pytree ``params`` (numpy
    arrays) and, when given, ``optimizer``'s accumulators to optax's
    ``sum_of_squares`` pytree of the same structure."""
    sos = [] if sum_of_squares is None else _dlrm_tensors(model, sum_of_squares)
    _load(_dlrm_tensors(model, params), optimizer, sos)


def load_tabular_mlp_params(model, params: Dict[str, Any], optimizer=None,
                            sum_of_squares: Optional[Dict[str, Any]] = None) -> None:
    """Set the port's ``TabularMLP`` to the JAX parameter pytree ``params``
    (numpy arrays) and, when given, ``optimizer``'s accumulators to optax's
    ``sum_of_squares`` pytree of the same structure."""
    sos = [] if sum_of_squares is None else _tabular_tensors(model, sum_of_squares)
    _load(_tabular_tensors(model, params), optimizer, sos)


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


def tabular_mlp_params(model) -> Dict[str, Any]:
    """The port's ``TabularMLP`` parameters as the JAX pytree of numpy arrays."""

    def host(t):
        return t.detach().cpu().numpy()

    return {
        "tables": {n: host(p) for n, p in zip(model.names, model.tables)},
        "mh_tables": {n: host(p) for n, p in zip(model.mh_names, model.mh_tables)},
        "mlp": [{"w": host(w), "b": host(b)} for w, b in zip(model.mlp.weights, model.mlp.biases)],
    }
