"""Datasets and parquet I/O (counterpart of nvtabular_tpu/io/)."""

from .dataset import Dataset
from .shuffle import Shuffle
from .writer import ParquetWriter

__all__ = ["Dataset", "Shuffle", "ParquetWriter"]
