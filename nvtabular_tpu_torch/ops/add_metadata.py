"""Schema-only tag and property annotation ops (counterpart of
nvtabular_tpu/ops/add_metadata.py): the transform passes the selected
columns through; the output schema gains the tags or properties."""

from __future__ import annotations

from ..selector import ColumnSelector
from ..table import TableBatch
from ..tags import Tags
from .operator import Operator


class AddMetadata(Operator):
    """Identity transform that adds tags and properties to the output schema."""

    def __init__(self, tags=None, properties=None):
        super().__init__()
        self.tags = tags or []
        self.properties = properties or {}

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        return batch.select([n for n in col_selector.names if n in batch])

    @property
    def output_tags(self):
        return self.tags

    @property
    def output_properties(self):
        return self.properties

    def _compute_properties(self, col_schema, input_schema):
        return col_schema.with_properties(self.properties) if self.properties else col_schema


class AddTags(AddMetadata):
    def __init__(self, tags=None):
        super().__init__(tags=tags)


class AddProperties(AddMetadata):
    def __init__(self, properties=None):
        super().__init__(properties=properties)


class TagAsUserID(AddTags):
    def __init__(self, tags=None):
        super().__init__(tags=tags or [Tags.USER_ID, Tags.CATEGORICAL, Tags.ID])


class TagAsItemID(AddTags):
    def __init__(self, tags=None):
        super().__init__(tags=tags or [Tags.ITEM_ID, Tags.CATEGORICAL, Tags.ID])


class TagAsUserFeatures(AddTags):
    def __init__(self, tags=None):
        super().__init__(tags=tags or [Tags.USER])


class TagAsItemFeatures(AddTags):
    def __init__(self, tags=None):
        super().__init__(tags=tags or [Tags.ITEM])
