"""DropLowCardinality (counterpart of nvtabular_tpu/ops/drop_low_cardinality.py):
a categorical column whose fitted domain has ``max < min_cardinality`` is
dropped when the selector is resolved; the transform passes the rest
through."""

from __future__ import annotations

from ..selector import ColumnSelector
from ..table import TableBatch
from ..tags import Tags
from .operator import Operator


class DropLowCardinality(Operator):
    def __init__(self, min_cardinality: int = 4):
        super().__init__()
        self.min_cardinality = min_cardinality

    def compute_selector(self, input_schema, selector, parents_selector=None, dependencies_selector=None):
        base = super().compute_selector(input_schema, selector, parents_selector, dependencies_selector)
        keep = []
        for name in base.names:
            cs = input_schema.get(name)
            if cs is None:
                continue
            domain = cs.properties.get("domain") if Tags.CATEGORICAL in cs.tags else None
            # the reference keeps a column with domain max >= min_cardinality (:29-33)
            if domain is not None and domain.get("max", 0) < self.min_cardinality:
                continue
            keep.append(name)
        return ColumnSelector(keep)

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        return batch.select([n for n in col_selector.names if n in batch])
