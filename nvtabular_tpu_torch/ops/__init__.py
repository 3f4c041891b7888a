"""The operator library (counterpart of nvtabular_tpu/ops/__init__.py): every
name the reference exports."""

from ..selector import ColumnSelector
from .add_metadata import (
    AddMetadata,
    AddProperties,
    AddTags,
    TagAsItemFeatures,
    TagAsItemID,
    TagAsUserFeatures,
    TagAsUserID,
)
from .bucketize import Bucketize
from .categorify import Categorify, get_embedding_sizes
from .clip import Clip
from .column_similarity import ColumnSimilarity
from .data_stats import DataStats
from .difference_lag import DifferenceLag
from .drop_low_cardinality import DropLowCardinality
from .dropna import Dropna
from .fill import FillMedian, FillMissing
from .filter import Filter
from .groupby import Groupby
from .hash_bucket import HashBucket
from .hashed_cross import HashedCross
from .join_external import JoinExternal
from .join_groupby import JoinGroupby
from .lambdaop import LambdaOp
from .list_slice import ListSlice
from .logop import LogOp
from .normalize import Normalize, NormalizeMinMax
from .operator import Operator
from .reduce_dtype_size import ReduceDtypeSize
from .rename import Rename
from .stat_operator import StatOperator
from .target_encoding import TargetEncoding
from .value_counts import ValueCount

__all__ = [
    "AddMetadata",
    "AddProperties",
    "AddTags",
    "Bucketize",
    "Categorify",
    "Clip",
    "ColumnSelector",
    "ColumnSimilarity",
    "DataStats",
    "DifferenceLag",
    "DropLowCardinality",
    "Dropna",
    "FillMedian",
    "FillMissing",
    "Filter",
    "Groupby",
    "HashBucket",
    "HashedCross",
    "JoinExternal",
    "JoinGroupby",
    "LambdaOp",
    "ListSlice",
    "LogOp",
    "Normalize",
    "NormalizeMinMax",
    "Operator",
    "ReduceDtypeSize",
    "Rename",
    "StatOperator",
    "TagAsItemFeatures",
    "TagAsItemID",
    "TagAsUserFeatures",
    "TagAsUserID",
    "TargetEncoding",
    "ValueCount",
    "get_embedding_sizes",
]
