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

(``load_dlrm_params`` / ``dlrm_params``; on a DLRM whose tables are
row-sharded, ``shard_params``, each table loads and reads as the rank's rows
of it), and tabular MLP parameters as

    {"tables": {col: [V, D]}, "mh_tables": {col: [V, D]},
     "mlp": [{"w": [in, out], "b": [out]}, ...]}

(``load_tabular_mlp_params`` / ``tabular_mlp_params``), DeepFM parameters as

    {"tables": {col: [V, D]}, "linear": {col: [V]}, "dense_w": [num_dense],
     "deep": [{"w", "b"}, ...], "bias": []}

(``load_deepfm_params`` / ``deepfm_params``) and DCN-v2 parameters as

    {"tables": {col: [V, D]}, "cross": [{"w": [N, N], "b": [N]}, ...],
     "deep": [...], "out": [...]}

(``load_dcn_params`` / ``dcn_params``); the port concatenates each of
``tables`` and ``linear`` into one parameter in sorted column order. Nothing
here imports the JAX package.

A vocabulary fitted by the JAX package's multi-process or mesh fit is an
ordinary fitted vocabulary and loads through ``load_fitted_state``. A table
that the JAX package shards by rows over its mesh's ``model`` axis
(``parallel/embeddings.py``) loads one rank's row range at a time
(``load_sharded_table``).
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


def load_sharded_table(table: np.ndarray, model_rank: int, model_size: int, device=None) -> torch.Tensor:
    """Rows ``[model_rank * V / model_size, (model_rank + 1) * V / model_size)``
    of a [V, D] table as a float32 tensor: model shard ``model_rank``, as
    the JAX package's ``P(model_axis, None)`` splits it (V divisible by
    ``model_size``). On ``cuda:0`` unless ``device`` says otherwise."""
    table = np.asarray(table)
    if table.ndim != 2 or table.shape[0] % model_size:
        raise ValueError(f"a [V, D] table with V divisible by {model_size} is needed, got {table.shape}")
    if not 0 <= model_rank < model_size:
        raise ValueError(f"model_rank must be in [0, {model_size}), got {model_rank}")
    rows = table.shape[0] // model_size
    local = np.ascontiguousarray(table[model_rank * rows: (model_rank + 1) * rows], dtype=np.float32)
    return torch.from_numpy(local).to(torch.device("cuda:0") if device is None else torch.device(device))


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


def _held_rows(model, i: int, value: np.ndarray) -> np.ndarray:
    """The rows of column ``i``'s whole table that ``model`` holds: all of
    them, or the rank's rows where the tables are row-sharded."""
    shard = getattr(model, "shard", None)
    if shard is None:
        return value
    if value.shape[0] != shard.padded[i]:
        raise ValueError(f"{model.names[i]}: {value.shape[0]} rows given, its padded table has {shard.padded[i]}")
    return value[shard.starts[i] : shard.starts[i] + shard.sizes[i]]


def _concatenated(model, param, per_column, what="tables"):
    """(param, the per-column arrays, or the rank's rows of each, concatenated
    in the model's column order)."""
    if sorted(per_column) != model.names:
        raise ValueError(f"{what} {sorted(per_column)} do not match the model's {model.names}")
    return [(param, np.concatenate([_held_rows(model, i, np.asarray(per_column[n])) for i, n in enumerate(model.names)]))]


def _held_bag_rows(model, k: int, value: np.ndarray) -> np.ndarray:
    """The rows of multihot table ``k``'s whole table that ``model`` holds."""
    shard = model.shard
    if shard is None:
        return value
    if value.shape[0] != shard.bag_padded[k]:
        raise ValueError(f"{model.mh_names[k]}: {value.shape[0]} rows given, its padded table has {shard.bag_padded[k]}")
    return value[shard.bag_starts[k] : shard.bag_starts[k] + model.mh_tables[k].shape[0]]


def _dlrm_tensors(model, tree):
    """(parameter, numpy value) pairs of ``model`` for a pytree in the
    format above; the tables are concatenated in sorted column order, each
    multihot table its own parameter (a rank's rows of each where the model
    is row-sharded)."""
    mh = tree.get("mh_tables", {})
    if sorted(mh) != model.mh_names:
        raise ValueError(f"mh_tables {sorted(mh)} do not match the model's {model.mh_names}")
    pairs = _concatenated(model, model.table, tree["tables"])
    pairs += [(p, _held_bag_rows(model, k, np.asarray(mh[n]))) for k, (p, n) in enumerate(zip(model.mh_tables,
                                                                                            model.mh_names))]
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


def _deepfm_tensors(model, tree):
    pairs = _concatenated(model, model.table, tree["tables"]) + _concatenated(model, model.linear, tree["linear"], "linear")
    pairs += [(model.dense_w, np.asarray(tree["dense_w"])), (model.bias, np.asarray(tree["bias"]))]
    return pairs + _mlp_tensors(model.deep, tree["deep"])


def _dcn_tensors(model, tree):
    if len(tree["cross"]) != len(model.cross.weights):
        raise ValueError(f"{len(tree['cross'])} cross layers given, the model has {len(model.cross.weights)}")
    pairs = _concatenated(model, model.table, tree["tables"])
    for w, b, layer in zip(model.cross.weights, model.cross.biases, tree["cross"]):
        pairs += [(w, np.asarray(layer["w"])), (b, np.asarray(layer["b"]))]
    return pairs + _mlp_tensors(model.deep, tree["deep"]) + _mlp_tensors(model.out, tree["out"])


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
    ``sum_of_squares`` pytree of the same structure. A row-sharded model
    takes the rank's rows of each whole table (``load_sharded_table``'s
    split), and its accumulators likewise."""
    sos = [] if sum_of_squares is None else _dlrm_tensors(model, sum_of_squares)
    _load(_dlrm_tensors(model, params), optimizer, sos)


def load_tabular_mlp_params(model, params: Dict[str, Any], optimizer=None,
                            sum_of_squares: Optional[Dict[str, Any]] = None) -> None:
    """Set the port's ``TabularMLP`` to the JAX parameter pytree ``params``
    (numpy arrays) and, when given, ``optimizer``'s accumulators to optax's
    ``sum_of_squares`` pytree of the same structure."""
    sos = [] if sum_of_squares is None else _tabular_tensors(model, sum_of_squares)
    _load(_tabular_tensors(model, params), optimizer, sos)


def load_deepfm_params(model, params: Dict[str, Any], optimizer=None,
                       sum_of_squares: Optional[Dict[str, Any]] = None) -> None:
    """Set the port's ``DeepFM`` to the JAX parameter pytree ``params``
    (numpy arrays) and, when given, ``optimizer``'s accumulators to optax's
    ``sum_of_squares`` pytree of the same structure."""
    sos = [] if sum_of_squares is None else _deepfm_tensors(model, sum_of_squares)
    _load(_deepfm_tensors(model, params), optimizer, sos)


def load_dcn_params(model, params: Dict[str, Any], optimizer=None,
                    sum_of_squares: Optional[Dict[str, Any]] = None) -> None:
    """Set the port's ``DCN`` to the JAX parameter pytree ``params`` (numpy
    arrays) and, when given, ``optimizer``'s accumulators to optax's
    ``sum_of_squares`` pytree of the same structure."""
    sos = [] if sum_of_squares is None else _dcn_tensors(model, sum_of_squares)
    _load(_dcn_tensors(model, params), optimizer, sos)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _mlp_params(mlp):
    return [{"w": _host(w), "b": _host(b)} for w, b in zip(mlp.weights, mlp.biases)]


def deepfm_params(model) -> Dict[str, Any]:
    """The port's ``DeepFM`` parameters as the JAX pytree of numpy arrays."""
    return {
        "tables": {n: _host(model.table_rows(n)) for n in model.names},
        "linear": {n: _host(model.linear[o : o + s]) for n, o, s in zip(model.names, model.offsets, model.sizes)},
        "dense_w": _host(model.dense_w),
        "deep": _mlp_params(model.deep),
        "bias": _host(model.bias),
    }


def dcn_params(model) -> Dict[str, Any]:
    """The port's ``DCN`` parameters as the JAX pytree of numpy arrays."""
    return {
        "tables": {n: _host(model.table_rows(n)) for n in model.names},
        "cross": [{"w": _host(w), "b": _host(b)} for w, b in zip(model.cross.weights, model.cross.biases)],
        "deep": _mlp_params(model.deep),
        "out": _mlp_params(model.out),
    }


def dlrm_params(model) -> Dict[str, Any]:
    """The port's ``DLRM`` parameters as the JAX pytree of numpy arrays;
    for a row-sharded model each table, single-hot or multihot, is the
    rank's rows (stack the ranks' in model-rank order for the whole
    table)."""
    return {
        "tables": {n: _host(model.table_rows(n)) for n in model.names},
        "mh_tables": {n: _host(t) for n, t in zip(model.mh_names, model.mh_tables)},
        "bottom": _mlp_params(model.bottom),
        "top": _mlp_params(model.top),
    }


def tabular_mlp_params(model) -> Dict[str, Any]:
    """The port's ``TabularMLP`` parameters as the JAX pytree of numpy arrays."""
    return {
        "tables": {n: _host(p) for n, p in zip(model.names, model.tables)},
        "mh_tables": {n: _host(p) for n, p in zip(model.mh_names, model.mh_tables)},
        "mlp": _mlp_params(model.mlp),
    }
