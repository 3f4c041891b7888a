"""Executors: op-by-op evaluation, the device executor, the fit engine.

Counterpart of ``nvtabular_tpu/dag/executor.py``:

* ``LocalExecutor`` — evaluates the DAG op by op on whatever device the
  batch's tensors live on. An op that runs user code (``runs_on_host``, the
  UDF / LambdaOp) gets its columns on the host and its result goes back to
  the batch's device, as the reference's hybrid executor runs host ops
  (executor.py:205-257); ``host_handoffs`` and ``host_handoff_seconds``
  count those round trips.
* ``TorchExecutor`` — counterpart of ``JitExecutor`` (executor.py:103-331,
  689-764): runs the whole DAG per batch on its device. It stacks host
  tensors of one dtype and length into pinned buffers for one host-to-device
  copy per group (``_stack_batch``, executor.py:777-796), fuses continuous chains into
  one cont_chain launch (dag/device_fuse.py), and keeps the schema's column
  order for its outputs. PyTorch has no compile cache to bound, so there is
  no power-of-two row padding.
* ``FitEngine`` — the phased statistics scan (executor.py:903-1104): one
  pass over the dataset per phase feeds every stat op of it. In a process
  group of several ranks each rank scans its round-robin shard of the
  partitions and the ops' states are reduced across ranks; with a mesh,
  Categorify counts its single integer columns on the mesh (kernel K15a).

Both executors cache each op's device tables keyed on that op's
``fit_generation``, so a refit can never serve stale tables (the round-2
refit-staleness rule of the JAX package).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..schema import Schema
from ..table import Column, TableBatch, concat_columns
from .device_fuse import ChainSpec, extract_chain
from .graph import Graph, postorder_iter_nodes
from .node import Node
from .ops import ConcatColumns


_FIELDS = ("values", "offsets", "validity")  # Column's tensors, in its constructor's order


class LocalExecutor:
    """Op-by-op DAG evaluation on the batch's own device."""

    def __init__(self):
        # id(op) → (op, (fit_generation, device), tables): holding the op
        # keeps its id from being recycled into a false cache hit
        self._state_cache: Dict[int, Tuple[Any, Tuple, Any]] = {}
        self.host_handoffs = 0
        self.host_handoff_seconds = 0.0

    def transform_batch(self, batch: TableBatch, output_node: Node) -> TableBatch:
        return self._eval(output_node, batch, {})

    def _eval(self, node: Node, root_batch: TableBatch, memo: Dict[int, TableBatch]) -> TableBatch:
        if id(node) in memo:
            return memo[id(node)]
        if isinstance(node.op, ConcatColumns):
            out = concat_columns(
                [self._eval(p, root_batch, memo) for p in node.parents_with_dependencies]
            )
        elif not node.parents_with_dependencies:
            out = self._apply(node, root_batch)
        else:
            out = self._apply(node, self.compute_node_input(node, root_batch, memo))
        if node.output_schema is not None:
            out = conform_to_schema(out, node.output_schema, node)
        if out.num_rows == root_batch.num_rows:  # a row-changing op keeps its own (the reference's :89)
            out.row_offset = root_batch.row_offset
        memo[id(node)] = out
        return out

    def compute_node_input(self, node: Node, root_batch: TableBatch, memo) -> TableBatch:
        """Evaluate everything upstream of `node` and return its input batch.

        Where an op upstream changed the row count (Dropna, Filter, Groupby),
        a dependency evaluated on the root batch no longer lines up with the
        parents' rows: its columns are then taken from the parents, which
        must hold them. (The reference concatenates them anyway, so a
        Groupby after a Filter groups misaligned rows; ROADMAP.md queue 3.)"""
        if not node.parents_with_dependencies:
            return root_batch
        parents = [self._eval(p, root_batch, memo) for p in node.parents]
        rows = parents[0].num_rows if parents else None
        inputs = list(parents)
        for d in node.dependencies:
            dep = self._eval(d, root_batch, memo)
            if rows is not None and dep.num_rows != rows:
                missing = [c for c in dep.column_names if not any(c in p for p in parents)]
                if missing:
                    raise ValueError(
                        f"{node.op.label}: dependency columns {missing} have {dep.num_rows} rows, its input "
                        f"{rows}: an op upstream changed the row count"
                    )
                continue
            inputs.append(dep)
        return concat_columns(inputs)

    def _apply(self, node: Node, batch: TableBatch) -> TableBatch:
        op = node.op
        if op.runs_on_host and batch.device.type != "cpu":
            return self._apply_on_host(node, batch)
        if op.has_device_state:
            return op.transform(node.selector, batch, state=self.op_state(op, batch.device))
        return op.transform(node.selector, batch)

    def _apply_on_host(self, node: Node, batch: TableBatch) -> TableBatch:
        """Run a host op on the host copy of its columns; its result goes back
        to the batch's device. The time covers both copies and the op, not
        the device work queued before it."""
        if batch.device.type == "cuda":
            torch.cuda.synchronize(batch.device)
        t0 = time.perf_counter()
        host = batch.select(node.op.host_inputs(node.selector, batch)).to("cpu")
        out = node.op.transform(node.selector, host).to(batch.device)
        self.host_handoffs += 1
        self.host_handoff_seconds += time.perf_counter() - t0
        return out

    def op_state(self, op, device):
        """The op's device tables on ``device``, rebuilt after every refit."""
        key = (op.fit_generation, torch.device(device))
        entry = self._state_cache.get(id(op))
        if entry is None or entry[0] is not op or entry[1] != key:
            entry = (op, key, op.device_state(device))
            self._state_cache[id(op)] = entry
        return entry[2]


class TorchExecutor(LocalExecutor):
    """Whole-DAG transform per batch on one device (cuda:N, or cpu). With a
    ``mesh`` (``parallel.make_mesh``) the fit counts vocabularies over its
    ``data`` axis (``FitEngine``)."""

    def __init__(self, device="cuda:0", mesh=None):
        super().__init__()
        self.device = torch.device(device)
        self.mesh = mesh
        self.data_axis = "data"
        # id(node) → (node, fit generations, ChainSpec or None)
        self._chains: Dict[int, Tuple[Node, tuple, Optional[ChainSpec]]] = {}
        # (dtype, shape) → [pinned buffer, event of its last copy] × 2, used in turn
        self._pinned: Dict[Tuple, List[List]] = {}
        self._turn = 0

    def transform_batch(self, batch: TableBatch, output_node: Node) -> TableBatch:
        return self._eval(output_node, self.stage(batch), {})

    # --- host → device --------------------------------------------------------
    def stage(self, batch: TableBatch) -> TableBatch:
        """The batch on this executor's device. From the host, the tensors of
        one dtype and length — the columns' values and validity masks, a list
        column's flat values and its offsets — go in ONE copy per (dtype,
        length) through a pinned staging buffer."""
        if all(c.device == self.device for c in batch.columns.values()):
            return batch
        if self.device.type != "cuda":
            return batch.to(self.device)
        groups: Dict[Tuple[torch.dtype, int], List[Tuple[str, str]]] = {}
        for name, col in batch.columns.items():
            for field in _FIELDS:
                t = getattr(col, field)
                if t is not None:
                    groups.setdefault((t.dtype, t.shape[0]), []).append((name, field))
        placed: Dict[Tuple[str, str], torch.Tensor] = {}
        self._turn ^= 1
        for (dtype, length), keys in groups.items():
            parts = [getattr(batch[name], field) for name, field in keys]
            dev = self._copy_stacked(parts, dtype, length, tuple(keys))
            for i, key in enumerate(keys):
                placed[key] = dev[i]
        out = TableBatch()
        out.row_offset = batch.row_offset
        for name in batch.column_names:
            out.columns[name] = Column(*(placed.get((name, field)) for field in _FIELDS))
        return out

    def _copy_stacked(self, parts: List[torch.Tensor], dtype: torch.dtype, length: int, keys: tuple) -> torch.Tensor:
        """``parts`` stacked into [len(parts), length] on the device. Each
        group of tensors (``keys``) keeps two pinned buffers, used in turn,
        that grow to the longest batch seen (a list column's flat length
        changes from batch to batch)."""
        ring = self._pinned.get(keys)
        if ring is None:
            ring = self._pinned[keys] = [[None, None], [None, None]]
        slot = ring[self._turn]
        numel = len(parts) * length
        if slot[1] is not None:
            slot[1].synchronize()  # the copy from this buffer two batches ago is done
        if slot[0] is None or slot[0].dtype != dtype or slot[0].numel() < numel:
            slot[0] = torch.empty(numel, dtype=dtype, pin_memory=True)
            slot[1] = torch.cuda.Event()
        host = slot[0][:numel].view(len(parts), length)
        torch.stack([p.cpu() for p in parts], out=host)
        dev = host.to(self.device, non_blocking=True)
        slot[1].record(torch.cuda.current_stream(self.device))
        return dev

    # --- fused continuous chains ------------------------------------------------
    def _eval(self, node: Node, root_batch: TableBatch, memo: Dict[int, TableBatch]) -> TableBatch:
        if id(node) in memo:
            return memo[id(node)]
        spec = self._chain(node)
        if spec is not None:
            out = self._run_chain(spec, node, root_batch, memo)
            if out is not None:
                if out.num_rows == root_batch.num_rows:
                    out.row_offset = root_batch.row_offset
                memo[id(node)] = out
                return out
        return super()._eval(node, root_batch, memo)

    def _chain(self, node: Node) -> Optional[ChainSpec]:
        # keyed on fit generations: the spec snapshots fitted means/stds
        gens = fit_generations(node)
        entry = self._chains.get(id(node))
        if entry is None or entry[0] is not node or entry[1] != gens:
            entry = (node, gens, extract_chain(node))
            self._chains[id(node)] = entry
        return entry[2]

    def _run_chain(self, spec: ChainSpec, node: Node, root_batch, memo) -> Optional[TableBatch]:
        inp = self._eval(spec.head_parent, root_batch, memo)
        cols = [inp.columns.get(n) for n in spec.names]
        if any(
            c is None or c.is_list or c.values.dtype != torch.float32 or c.device != self.device
            for c in cols
        ):
            return None  # outside the kernel's contract: op by op
        from ..kernels.cont_chain import cont_chain

        x = torch.stack([c.values for c in cols])
        validity = None
        if any(c.validity is not None for c in cols):
            validity = torch.stack(
                [c.validity if c.validity is not None else torch.ones_like(c.values, dtype=torch.bool)
                 for c in cols]
            )
        params, flags = spec.kernel_args(self.device)
        y = cont_chain(x, validity, params, flags, spec.out_dtype, spec.mask)
        y, mask = y if spec.mask else (y, None)
        out = TableBatch()
        for i, (name, col) in enumerate(zip(spec.names, cols)):
            out.columns[name] = Column(y[i], None, None if spec.has_fill else col.validity)
            if mask is not None:
                out.columns[f"{name}_filled"] = Column(mask[i])
        if node.output_schema is not None:
            out = conform_to_schema(out, node.output_schema, node)
        return out


def fit_generations(output_node: Node) -> tuple:
    return tuple(n.op.fit_generation for n in postorder_iter_nodes(output_node))


class FitEngine:
    """Phased streaming statistics pass over a Dataset. Each batch goes to
    the executor's device first; stat-op inputs evaluate op by op there.

    Multi-process (executor.py:933-1080): in a process group of several ranks
    each rank streams its round-robin shard of the partitions, then each op's
    state is reduced across ranks — through the op's
    ``fit_reduce_multihost`` where it has one (an all_to_all of large keyed
    tables), else ``fit_merge`` of every rank's state — so every rank ends
    with the same fitted state. With a mesh on the executor, an op with a
    ``fit_mesh_plan`` (Categorify's single integer columns) keeps its
    columns' values during the scan and counts them on the mesh in
    ``fit_mesh``; ``NVT_MESH_FIT=0`` turns that off."""

    def __init__(self, executor: LocalExecutor):
        self.executor = executor
        self._input_executor = LocalExecutor()
        self.last_fit_stats: Dict[str, float] = {}

    def fit(self, dataset, graph: Graph, shard=None) -> None:
        from ..parallel.multihost import allgather_pyobj, process_count, process_index

        if graph.output_schema is None:
            graph.construct_schema(dataset.schema)
        world = process_count()
        if shard is None and world > 1:
            shard = (process_index(), world)
        stats = {"scan_seconds": 0.0, "finalize_seconds": 0.0, "reduce_seconds": 0.0, "rows_scanned": 0}
        self.last_fit_stats = stats
        stage = getattr(self.executor, "stage", lambda b: b)
        mesh = getattr(self.executor, "mesh", None)
        mesh_axis = getattr(self.executor, "data_axis", "data")
        for phase_idx, phase_nodes in enumerate(graph.stat_phases()):
            nodes = [n for n in phase_nodes if not n.op.fitted]
            if not nodes:
                continue
            mesh_plans: Dict[int, List[str]] = {}
            if mesh is not None and os.environ.get("NVT_MESH_FIT", "1") != "0":
                for n in nodes:
                    plan_fn = getattr(n.op, "fit_mesh_plan", None)
                    plan = plan_fn(n.selector, n.input_schema) if plan_fn is not None else None
                    if plan:
                        mesh_plans[id(n)] = plan
            buffers = {nid: {c: [] for c in cols} for nid, cols in mesh_plans.items()}
            states = {id(n): n.op.fit_init(n.selector, n.input_schema) for n in nodes if id(n) not in mesh_plans}
            scan_start = time.perf_counter()
            for batch in dataset.to_batches(columns=self._phase_columns(nodes), shard=shard):
                dev_batch = stage(batch)
                memo: Dict[int, TableBatch] = {}
                for n in nodes:
                    inp = self._input_executor.compute_node_input(n, dev_batch, memo)
                    if id(n) in mesh_plans:
                        for name in mesh_plans[id(n)]:
                            col = inp[name]  # a list counts its flat values
                            buffers[id(n)][name].append((col.values, None if col.is_list else col.validity))
                        continue
                    states[id(n)] = n.op.fit_batch(n.selector, inp, states[id(n)])
                if phase_idx == 0:
                    stats["rows_scanned"] += batch.num_rows
            for n in nodes:
                if id(n) in mesh_plans:
                    states[id(n)] = n.op.fit_mesh(buffers.pop(id(n)), mesh, mesh_axis)
            stats["scan_seconds"] += time.perf_counter() - scan_start
            for n in nodes:
                state = states[id(n)]
                if shard is not None and world > 1:
                    reduce_start = time.perf_counter()
                    reducer = getattr(n.op, "fit_reduce_multihost", None)
                    state = reducer(state) if reducer is not None else n.op.fit_merge(allgather_pyobj(state))
                    stats["reduce_seconds"] += time.perf_counter() - reduce_start
                finalize_start = time.perf_counter()
                n.op.fit_finalize(state)
                n.op.mark_fitted()
                stats["finalize_seconds"] += time.perf_counter() - finalize_start
        # final schema pass: downstream schemas see fitted properties
        graph.construct_schema(dataset.schema)

    @staticmethod
    def _phase_columns(nodes: List[Node]) -> Optional[List[str]]:
        """Union of root columns needed by the upstream closure of the phase."""
        needed = set()
        stack, seen = list(nodes), set()
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            if not n.parents_with_dependencies and n.selector is not None:
                needed.update(n.selector.names)
            stack.extend(n.parents_with_dependencies)
        return sorted(needed) if needed else None


def conform_to_schema(batch: TableBatch, schema: Schema, node: Node) -> TableBatch:
    """Order columns per schema."""
    out = TableBatch()
    out.row_offset = batch.row_offset
    for cs in schema:
        if cs.name not in batch:
            raise RuntimeError(
                f"Operator {node.op.label} promised column {cs.name!r} "
                f"but produced {batch.column_names}"
            )
        out.columns[cs.name] = batch[cs.name]
    return out


def enforce_dtypes(batch: TableBatch, output_dtypes: Dict[str, Any]) -> TableBatch:
    """Cast columns to their schema dtypes (executor.py:1168)."""
    from ..table import to_torch_dtype

    out = batch.copy()
    for name, dtype in output_dtypes.items():
        if name in out:
            want = to_torch_dtype(dtype)
            if out[name].values.dtype != want:
                out.columns[name] = out[name].astype(want)
    return out
