"""Workflow: fit/transform facade over a Graph, on one device.

Counterpart of ``nvtabular_tpu/workflow/workflow.py``. ``Workflow(node)``
runs on ``cuda:0``; with no CUDA device it raises rather than move to the
CPU. ``Workflow(node, device="cpu")`` runs every kernel's plain PyTorch
version instead. Save and load are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..dag import Graph, Node
from ..dag.base_operator import StatOperator
from ..dag.executor import FitEngine, TorchExecutor, enforce_dtypes
from ..io.dataset import Dataset
from ..schema import Schema
from ..table import TableBatch


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
    def __init__(self, output_node: Node, device=None):
        self.device = resolve_device(device)
        self.graph = Graph(output_node)
        self.executor = TorchExecutor(self.device)
        self._fit_engine = FitEngine(self.executor)

    # --- fitting ---------------------------------------------------------------
    def fit(self, dataset) -> "Workflow":
        """Fit every stat op from scratch (a refit replaces earlier stats)."""
        for node in self.graph.nodes:
            if isinstance(node.op, StatOperator) and node.op.fitted:
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


class TransformedDataset:
    """Lazy transform plan: batches stream through the workflow's executor."""

    def __init__(self, base: Dataset, workflow: Workflow):
        self._base = base
        self._workflow = workflow

    @property
    def schema(self) -> Optional[Schema]:
        """The workflow's output schema (what a loader selects columns by)."""
        return self._workflow.output_schema

    def to_batches(self, host: bool = True):
        """Transformed batches, moved to the CPU unless ``host=False``."""
        wf = self._workflow
        for batch in self._base.to_batches(columns=wf._input_columns or None):
            out = wf._transform_batch(batch)
            yield out.to("cpu") if host else out


def _as_dataset(data) -> Dataset:
    return data if isinstance(data, Dataset) else Dataset(data)
