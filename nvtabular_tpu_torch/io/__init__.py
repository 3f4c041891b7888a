"""In-memory datasets (counterpart of nvtabular_tpu/io/)."""

from .dataset import Dataset

__all__ = ["Dataset"]
