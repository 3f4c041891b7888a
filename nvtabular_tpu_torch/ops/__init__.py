"""Operators ported so far (counterpart of nvtabular_tpu/ops/__init__.py)."""

from ..selector import ColumnSelector
from .categorify import Categorify
from .clip import Clip
from .fill import FillMissing
from .logop import LogOp
from .normalize import Normalize
from .operator import Operator
from .stat_operator import StatOperator

__all__ = [
    "Categorify",
    "Clip",
    "ColumnSelector",
    "FillMissing",
    "LogOp",
    "Normalize",
    "Operator",
    "StatOperator",
]
