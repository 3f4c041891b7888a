"""HashBucket — the hashing trick in place of a vocabulary.

Counterpart of ``nvtabular_tpu/ops/hash_bucket.py:22-86``: each column's
codes are ``hash_array(col) % num_buckets`` as int32, one launch of kernel
K7 a column (``kernels.hash.hashed_cross`` of the column alone, seed 0). A
list column hashes its flat values and keeps its offsets. Like the
reference, the codes carry no validity: a null row hashes its raw value.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

from .. import dtypes as md
from ..kernels.hash import hashed_cross
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from ..tags import Tags
from .categorify import _emb_sz_rule
from .operator import Operator


class HashBucket(Operator):
    def __init__(self, num_buckets: Union[int, Dict[str, int]]):
        if not isinstance(num_buckets, (int, dict)):
            raise TypeError("num_buckets must be int or dict of column->int")
        super().__init__()
        self.num_buckets = num_buckets

    def _nb(self, name: str) -> int:
        return self.num_buckets[name] if isinstance(self.num_buckets, dict) else self.num_buckets

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            out[name] = Column(hashed_cross([col.values], self._nb(name)), col.offsets)
        return out

    @property
    def output_dtype(self):
        return md.int32

    @property
    def output_tags(self):
        return [Tags.CATEGORICAL]

    def _compute_properties(self, col_schema, input_schema):
        nb = self._nb(col_schema.name)
        return col_schema.with_properties(
            {
                "domain": {"min": 0, "max": nb - 1, "name": col_schema.name},
                "embedding_sizes": {"cardinality": nb, "dimension": _emb_sz_rule(nb)[1]},
            }
        )

    def get_embedding_sizes(self, columns) -> Dict[str, Tuple[int, int]]:
        return {name: _emb_sz_rule(self._nb(name)) for name in columns}
