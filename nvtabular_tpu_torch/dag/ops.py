"""Built-in structural operators: selection, concat, subset, UDF.

Counterpart of ``nvtabular_tpu/dag/ops.py`` (without Subgraph).
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional

import numpy as np

from ..selector import ColumnSelector
from ..table import TableBatch, as_column, concat_columns
from .base_operator import BaseOperator


class SelectionOp(BaseOperator):
    """Pass through the selected columns."""

    def __init__(self, selector: Optional[ColumnSelector] = None):
        self.selector = selector if isinstance(selector, ColumnSelector) else ColumnSelector(selector)
        super().__init__()

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        selector = col_selector or self.selector
        return batch.select([n for n in selector.names if n in batch])

    def compute_selector(self, input_schema, selector, parents_selector=None, dependencies_selector=None):
        base = self.selector if self.selector else (selector or ColumnSelector())
        return base.resolve(input_schema)

    def compute_input_schema(self, root_schema, parents_schema, deps_schema, selector):
        upstream = parents_schema + deps_schema
        return upstream if len(upstream) else root_schema

    def compute_output_schema(self, input_schema, col_selector, prev_output_schema=None):
        return input_schema.apply(col_selector or self.selector)

    def __repr__(self):
        return f"<SelectionOp {self.selector!r}>"


class ConcatColumns(BaseOperator):
    """Join the column sets of multiple parent branches (the `+` operator)."""

    def compute_selector(self, input_schema, selector, parents_selector=None, dependencies_selector=None):
        return (parents_selector or ColumnSelector()) + (dependencies_selector or ColumnSelector())

    def compute_input_schema(self, root_schema, parents_schema, deps_schema, selector):
        return parents_schema + deps_schema

    def compute_output_schema(self, input_schema, col_selector, prev_output_schema=None):
        return input_schema

    def transform(self, col_selector: ColumnSelector, batches: List[TableBatch]) -> TableBatch:
        if isinstance(batches, TableBatch):
            return batches
        return concat_columns(batches)


class SubsetColumns(BaseOperator):
    """Remove a set of columns (the `-` operator)."""

    def __init__(self, to_remove=None):
        if isinstance(to_remove, ColumnSelector):
            self.to_remove = to_remove
        else:
            self.to_remove = ColumnSelector(to_remove) if to_remove is not None else ColumnSelector()
        super().__init__()

    def _removed_names(self) -> List[str]:
        from .node import Node

        if isinstance(self.to_remove, Node):
            return self.to_remove.output_columns
        return self.to_remove.names

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        return batch.drop([n for n in self._removed_names() if n in batch])

    def compute_output_schema(self, input_schema, col_selector, prev_output_schema=None):
        return input_schema.excluding_by_name(self._removed_names())


class UDF(BaseOperator):
    """Apply a python function column-wise (the reference's LambdaOp / UDF,
    nvtabular_tpu/dag/ops.py:107-206).

    ``f`` receives a host Column (numpy reads it through ``__array__``) and
    optionally the whole host TableBatch, and returns array-like or a
    Column. User code runs on the host, as in the reference's hybrid
    executor: the executors move the selected columns to the host and the
    result back to the batch's device, and count each handoff."""

    runs_on_host = True

    def __init__(self, f: Callable, dtype=None, tags=None, properties=None, label=None):
        if not callable(f):
            raise ValueError("UDF requires a callable")
        self.f = f
        self._dtype = dtype
        self._tags = tags or []
        self._properties = properties or {}
        self._label = label
        super().__init__()

    def _n_params(self) -> int:
        if isinstance(self.f, np.ufunc):
            return 1
        try:
            params = inspect.signature(self.f).parameters.values()
        except (ValueError, TypeError):  # builtins without signatures
            return 1
        required = [p for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) and p.default is p.empty]
        return len(required) or 1

    def host_inputs(self, col_selector: ColumnSelector, batch: TableBatch) -> List[str]:
        """The columns a host copy of ``batch`` needs: the selected ones, or
        every column for an ``f(col, batch)``."""
        if self._n_params() >= 2 or not col_selector:
            return batch.column_names
        return [n for n in col_selector.names if n in batch]

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        two = self._n_params() >= 2
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            out[name] = as_column(self.f(col, batch) if two else self.f(col))
        return out

    @property
    def output_dtype(self):
        return self._dtype

    @property
    def output_tags(self):
        return self._tags

    def _compute_properties(self, col_schema, input_schema):
        return col_schema.with_properties(self._properties) if self._properties else col_schema

    @property
    def label(self) -> str:
        if self._label:
            return self._label
        name = getattr(self.f, "__name__", "")
        return "UDF" if name in ("", "<lambda>") else f"UDF({name})"
