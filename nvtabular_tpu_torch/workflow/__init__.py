"""Workflow facade (counterpart of nvtabular_tpu/workflow/)."""

from ..dag.node import Node as WorkflowNode
from .workflow import TransformedDataset, Workflow

__all__ = ["TransformedDataset", "Workflow", "WorkflowNode"]
