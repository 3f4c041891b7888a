"""Operator base classes and the schema-propagation contract.

Counterpart of ``nvtabular_tpu/dag/base_operator.py``. Stat operators expose
the same streaming accumulator protocol:

    state = op.fit_init(col_selector, input_schema)
    state = op.fit_batch(col_selector, batch, state)   # once per batch
    op.fit_finalize(state)                              # stores the statistics

Ops with fitted device tables (Categorify) set ``has_device_state`` and take
those tables through ``transform(..., state=...)``; the executor builds them
with ``device_state(device)`` and caches them per ``fit_generation``.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

from .. import dtypes as md
from ..schema import ColumnSchema, Schema
from ..selector import ColumnSelector
from ..table import TableBatch


class Supports(enum.Flag):
    """Data formats an operator can accept (nvtabular_tpu/dag/base_operator.py:33)."""

    CPU_DATAFRAME = 1
    GPU_DATAFRAME = 2
    CPU_DICT_ARRAY = 4
    GPU_DICT_ARRAY = 8


class BaseOperator:
    # True for ops whose transform takes executor-cached device tables
    has_device_state: bool = False
    # True for ops that run user code on the host (UDF): the executors hand
    # them host columns and put the result back on the batch's device
    runs_on_host: bool = False
    # bumped by every fit (FitEngine, convert.load_fitted_state): keys the
    # executor's device-table cache so a refit never serves stale tables
    fit_generation: int = 0

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        """Per-batch transform. Default: identity."""
        return batch

    def device_state(self, device) -> Optional[Dict[str, Any]]:
        """Fitted tables placed on ``device`` (ops with has_device_state)."""
        return None

    # --- selector / schema propagation ------------------------------------
    def compute_selector(
        self,
        input_schema: Schema,
        selector: Optional[ColumnSelector],
        parents_selector: Optional[ColumnSelector] = None,
        dependencies_selector: Optional[ColumnSelector] = None,
    ) -> ColumnSelector:
        if selector is None or not selector:
            selector = ColumnSelector(input_schema.column_names)
        return selector.resolve(input_schema)

    def compute_input_schema(
        self,
        root_schema: Schema,
        parents_schema: Schema,
        deps_schema: Schema,
        selector: Optional[ColumnSelector],
    ) -> Schema:
        return parents_schema + deps_schema

    def compute_output_schema(
        self,
        input_schema: Schema,
        col_selector: ColumnSelector,
        prev_output_schema: Optional[Schema] = None,
    ) -> Schema:
        if not col_selector or (not col_selector.names and not col_selector.tags):
            col_selector = ColumnSelector(input_schema.column_names)
        if col_selector.tags:
            col_selector = col_selector.resolve(input_schema)
        output_schema = Schema()
        for output_name, input_names in self.column_mapping(col_selector).items():
            col_schema = self.compute_column_schema(
                output_name, input_schema.select_by_name(input_names) or input_schema
            )
            output_schema = output_schema + Schema([col_schema])
        return output_schema

    def column_mapping(self, col_selector: ColumnSelector) -> Dict[str, List[str]]:
        """output column name -> contributing input column names."""
        return {name: [name] for name in col_selector.names}

    def compute_column_schema(self, col_name: str, input_schema: Schema) -> ColumnSchema:
        if len(input_schema):
            source = next(iter(input_schema))
            col_schema = ColumnSchema(
                col_name,
                tags=source.tags,
                properties=dict(source.properties),
                dtype=source.dtype,
                is_list=source.is_list,
                is_ragged=source.is_ragged,
                shape=source.shape,
            )
        else:
            col_schema = ColumnSchema(col_name)
        col_schema = self._compute_dtype(col_schema, input_schema)
        col_schema = self._compute_tags(col_schema, input_schema)
        col_schema = self._compute_properties(col_schema, input_schema)
        return self._compute_shape(col_schema, input_schema)

    def _compute_dtype(self, col_schema: ColumnSchema, input_schema: Schema) -> ColumnSchema:
        if self.output_dtype is not None:
            return col_schema.with_dtype(md.normalize(self.output_dtype))
        return col_schema

    def _compute_tags(self, col_schema: ColumnSchema, input_schema: Schema) -> ColumnSchema:
        if self.output_tags:
            # a declared side of a mutually-exclusive tag pair replaces the
            # other side inherited from upstream
            from ..tags import _CONFLICTS, TagSet

            declared = set(TagSet(self.output_tags))
            for conflict in _CONFLICTS:
                overlap = declared & conflict
                if overlap:
                    col_schema = col_schema.without_tags(list(conflict - overlap))
            return col_schema.with_tags(self.output_tags)
        return col_schema

    def _compute_properties(self, col_schema: ColumnSchema, input_schema: Schema) -> ColumnSchema:
        return col_schema

    def _compute_shape(self, col_schema: ColumnSchema, input_schema: Schema) -> ColumnSchema:
        return col_schema

    @property
    def output_dtype(self):
        return None

    @property
    def output_tags(self):
        return None

    @property
    def dependencies(self) -> Optional[List]:
        return None

    @property
    def label(self) -> str:
        return self.__class__.__name__

    def create_node(self, selector: ColumnSelector):
        from .node import Node

        return Node(selector)

    def __rrshift__(self, other):
        """Support `[cols] >> op` without an explicit ColumnSelector."""
        from .node import Node

        return Node(ColumnSelector(other)) >> self

    def __repr__(self):
        return f"<{self.label}>"


class StatOperator(BaseOperator):
    """Operator requiring a statistics pass before transform."""

    def __init__(self):
        super().__init__()
        self.fitted = False

    def fit_init(self, col_selector: ColumnSelector, input_schema: Schema):
        raise NotImplementedError

    def fit_batch(self, col_selector: ColumnSelector, batch: TableBatch, state):
        raise NotImplementedError

    def fit_finalize(self, state) -> None:
        raise NotImplementedError

    def fit_merge(self, states):
        """One state from every rank's (a multi-process fit)."""
        raise NotImplementedError(f"{self.label} cannot merge the fit states of several processes")

    def mark_fitted(self) -> None:
        self.fitted = True
        self.fit_generation += 1

    def clear(self) -> None:
        self.fitted = False
