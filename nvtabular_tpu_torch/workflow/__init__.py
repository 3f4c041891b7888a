"""Workflow facade (counterpart of nvtabular_tpu/workflow/)."""

from .workflow import TransformedDataset, Workflow

__all__ = ["TransformedDataset", "Workflow"]
