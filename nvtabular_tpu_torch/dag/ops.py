"""Built-in structural operators: selection, concat, subset.

Counterpart of ``nvtabular_tpu/dag/ops.py`` (without UDF and Subgraph).
"""

from __future__ import annotations

from typing import List, Optional

from ..selector import ColumnSelector
from ..table import TableBatch, concat_columns
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
