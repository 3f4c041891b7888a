"""Public Operator base class (counterpart of nvtabular_tpu/ops/operator.py)."""

from __future__ import annotations

from ..dag.base_operator import BaseOperator, Supports
from ..selector import ColumnSelector

__all__ = ["Operator", "ColumnSelector", "Supports"]


class Operator(BaseOperator):
    pass
