"""Public StatOperator re-export (counterpart of nvtabular_tpu/ops/stat_operator.py)."""

from ..dag.base_operator import StatOperator

__all__ = ["StatOperator"]
