"""Operators ported so far (counterpart of nvtabular_tpu/ops/__init__.py)."""

from ..selector import ColumnSelector
from .bucketize import Bucketize
from .categorify import Categorify, get_embedding_sizes
from .clip import Clip
from .difference_lag import DifferenceLag
from .fill import FillMissing
from .hash_bucket import HashBucket
from .hashed_cross import HashedCross
from .join_groupby import JoinGroupby
from .lambdaop import LambdaOp
from .list_slice import ListSlice
from .logop import LogOp
from .normalize import Normalize
from .operator import Operator
from .stat_operator import StatOperator
from .target_encoding import TargetEncoding

__all__ = [
    "Bucketize",
    "Categorify",
    "Clip",
    "ColumnSelector",
    "DifferenceLag",
    "FillMissing",
    "HashBucket",
    "HashedCross",
    "JoinGroupby",
    "LambdaOp",
    "ListSlice",
    "LogOp",
    "Normalize",
    "Operator",
    "StatOperator",
    "TargetEncoding",
    "get_embedding_sizes",
]
