"""Workflow: fit/transform facade over a Graph, on one device.

Counterpart of ``nvtabular_tpu/workflow/workflow.py``. ``Workflow(node)``
runs on ``cuda:0``; with no CUDA device it raises rather than move to the
CPU. ``Workflow(node, device="cpu")`` runs every kernel's plain PyTorch
version instead. Save, load and the rest of the reference's facade raise
NotImplementedError (ROADMAP.md queue 1 item 2). A transformed dataset
writes parquet in the reference's two-phase form: transform on the device,
then the host writer (``io/writer.py``).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..dag import Graph, Node
from ..dag.base_operator import StatOperator
from ..dag.executor import FitEngine, TorchExecutor, enforce_dtypes
from ..io.dataset import Dataset
from ..schema import Schema
from ..table import TableBatch, concat_rows
from ..unported import message

UNSUPPORTED_FACADE = "Workflow.{} is not ported yet (ROADMAP.md queue 1 item 2: save/load and the Workflow facade)"


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nvtabular_tpu_torch runs on cuda:0 by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda:0")
    return torch.device(device)


class Workflow:
    def __init__(self, output_node: Node, device=None, executor: Optional[TorchExecutor] = None):
        """``executor`` (the JAX package's keyword, workflow.py:33) fixes the
        device, and a ``TorchExecutor(device, mesh=...)`` fits on a mesh;
        ``device`` must then be None or the executor's."""
        if executor is None:
            executor = TorchExecutor(resolve_device(device))
        elif device is not None and torch.device(device) != executor.device:
            raise ValueError(f"device {device} differs from the executor's {executor.device}")
        self.device = executor.device
        self.graph = Graph(output_node)
        self.executor = executor
        self._fit_engine = FitEngine(self.executor)

    # --- fitting ---------------------------------------------------------------
    def fit(self, dataset) -> "Workflow":
        """Fit every stat op; a refit replaces the stats of earlier fits but
        keeps state supplied at construction (``Categorify(vocabs=...)``,
        fitted with ``fit_generation`` 0), as the reference does
        (workflow.py:177-195). In a process group of several ranks each rank
        fits on its round-robin shard of the partitions and every rank ends
        with the same state."""
        for node in self.graph.nodes:
            if isinstance(node.op, StatOperator) and node.op.fit_generation > 0:
                node.op.clear()
        self._fit_engine.fit(_as_dataset(dataset), self.graph)
        return self

    @property
    def last_fit_stats(self) -> dict:
        return dict(self._fit_engine.last_fit_stats)

    def fit_transform(self, dataset) -> "TransformedDataset":
        self.fit(dataset)
        return self.transform(dataset)

    # --- transforming ----------------------------------------------------------
    def transform(self, data) -> Union[TableBatch, "TransformedDataset"]:
        """A TableBatch transforms now and stays on the workflow's device;
        anything else is a Dataset, transformed lazily batch by batch."""
        if isinstance(data, TableBatch):
            return self._transform_batch(data)
        dataset = _as_dataset(data)
        if self.graph.output_schema is None:
            self.graph.construct_schema(dataset.schema)
        self._check_fitted()
        self._check_input_columns(dataset.schema.column_names)
        return TransformedDataset(dataset, self)

    def _transform_batch(self, batch: TableBatch) -> TableBatch:
        if self.graph.output_schema is None:
            self.graph.construct_schema(batch.infer_schema())
        self._check_fitted()
        self._check_input_columns(batch.column_names)
        out = self.executor.transform_batch(batch, self.graph.output_node)
        return enforce_dtypes(out, self.output_dtypes)

    def _check_input_columns(self, available):
        missing = [c for c in self._input_columns if c not in set(available)]
        if missing:
            raise ValueError(
                f"Data to transform is missing input columns {missing}; "
                f"the fitted workflow requires {self._input_columns}."
            )

    def _check_fitted(self):
        unfitted = [
            n.op.label
            for n in self.graph.nodes
            if isinstance(n.op, StatOperator) and not n.op.fitted
        ]
        if unfitted:
            raise RuntimeError(f"Workflow has unfitted stat operators: {unfitted}. Call fit() first.")

    @property
    def _input_columns(self) -> List[str]:
        cols: List[str] = []
        for node in self.graph.leaf_nodes:
            for name in node.selector.names if node.selector is not None else []:
                if name not in cols:
                    cols.append(name)
        return cols

    # --- schema ----------------------------------------------------------------
    @property
    def output_schema(self) -> Optional[Schema]:
        return self.graph.output_schema

    @property
    def output_dtypes(self):
        return self.graph.output_dtypes

    @property
    def input_dtypes(self):
        return self.graph.input_dtypes

    @property
    def output_node(self) -> Node:
        return self.graph.output_node

    # --- the reference's facade, not ported yet ------------------------------------
    @property
    def input_schema(self):
        raise NotImplementedError(UNSUPPORTED_FACADE.format("input_schema"))

    def fit_schema(self, input_schema):
        raise NotImplementedError(UNSUPPORTED_FACADE.format("fit_schema"))

    def remove_inputs(self, input_cols):
        raise NotImplementedError(UNSUPPORTED_FACADE.format("remove_inputs"))

    def get_subworkflow(self, name):
        raise NotImplementedError(UNSUPPORTED_FACADE.format("get_subworkflow"))

    def clear_stats(self):
        raise NotImplementedError(UNSUPPORTED_FACADE.format("clear_stats"))

    def save(self, path):
        raise NotImplementedError(UNSUPPORTED_FACADE.format("save"))

    @classmethod
    def load(cls, path, client=None):
        raise NotImplementedError(UNSUPPORTED_FACADE.format("load"))


class TransformedDataset:
    """Lazy transform plan: batches stream through the workflow's executor."""

    def __init__(self, base: Dataset, workflow: Workflow):
        self._base = base
        self._workflow = workflow

    @property
    def schema(self) -> Optional[Schema]:
        """The workflow's output schema (what a loader selects columns by)."""
        return self._workflow.output_schema

    def infer_schema(self) -> Optional[Schema]:
        return self._workflow.output_schema

    def to_batches(self, columns=None, prefetch: int = 2, shard=None, host: bool = True, hetero=None):
        """Transformed batches (JAX workflow.py:258-283), moved to the CPU
        unless ``host=False``: ``columns`` selects output columns, ``shard=
        (rank, world)`` streams that rank's partitions of the base dataset.
        ``prefetch`` loads file partitions of the base dataset ahead on a thread."""
        if hetero:
            raise NotImplementedError(message("TransformedDataset.to_batches(hetero=...)", 11))
        wf = self._workflow
        for batch in self._base.to_batches(columns=wf._input_columns or None, prefetch=prefetch, shard=shard):
            out = wf._transform_batch(batch)
            if columns:
                out = out.select([c for c in columns if c in out])
            yield out.to("cpu") if host else out

    @property
    def num_rows(self) -> int:
        return self._base.num_rows

    @property
    def npartitions(self) -> int:
        return self._base.npartitions

    def to_table(self, columns=None) -> TableBatch:
        """Every transformed batch, on the host, as one batch."""
        batches = list(self.to_batches(columns=columns))
        return concat_rows(batches) if batches else TableBatch()

    def to_parquet(self, output_path: str, shuffle=None, out_files_per_proc=None, output_files=None,
                   row_group_size=None, compression=None, **kwargs):
        """The transformed stream written to parquet in the reference's
        two-phase form (workflow.py:291-352 with ``NVT_FUSED_WRITE=0``): each
        batch transforms on the workflow's device, goes to the host, and the
        file workers shuffle and encode it (``Dataset.to_parquet``)."""
        Dataset.to_parquet(self, output_path, shuffle=shuffle, out_files_per_proc=out_files_per_proc,
                           output_files=output_files, row_group_size=row_group_size, compression=compression)


def _as_dataset(data) -> Dataset:
    return data if isinstance(data, Dataset) else Dataset(data)
