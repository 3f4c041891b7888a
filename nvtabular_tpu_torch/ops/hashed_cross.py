"""HashedCross — one crossed categorical feature from hashed columns.

Counterpart of ``nvtabular_tpu/ops/hashed_cross.py``: the output
``a_X_b`` (the column names sorted) is ``h = h * 31 ^ hash(col)`` over the
sorted columns, ``% num_buckets``, as int32, in one launch of kernel K7
(``kernels.hash.hashed_cross``).
"""

from __future__ import annotations

from typing import Dict, Union

from .. import dtypes as md
from ..kernels.hash import hashed_cross
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from ..tags import Tags
from .operator import Operator


class HashedCross(Operator):
    def __init__(self, num_buckets: Union[int, Dict[str, int]]):
        if not isinstance(num_buckets, (int, dict)):
            raise TypeError("num_buckets must be int or dict")
        super().__init__()
        self.num_buckets = num_buckets

    def _output_name(self, col_selector: ColumnSelector) -> str:
        return "_X_".join(sorted(col_selector.names))

    def _buckets(self, name: str):
        return self.num_buckets if isinstance(self.num_buckets, int) else self.num_buckets.get(name)

    def column_mapping(self, col_selector: ColumnSelector):
        return {self._output_name(col_selector): list(col_selector.names)}

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        name = self._output_name(col_selector)
        nb = self.num_buckets if isinstance(self.num_buckets, int) else self.num_buckets[name]
        out = TableBatch()
        out[name] = Column(hashed_cross([batch[c].values for c in sorted(col_selector.names)], nb))
        return out

    @property
    def output_dtype(self):
        return md.int32

    @property
    def output_tags(self):
        return [Tags.CATEGORICAL]

    def _compute_properties(self, col_schema, input_schema):
        nb = self._buckets(col_schema.name)
        if nb:
            return col_schema.with_properties({"domain": {"min": 0, "max": nb - 1, "name": col_schema.name}})
        return col_schema
