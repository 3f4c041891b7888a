"""In-memory datasets (counterpart of nvtabular_tpu/io/)."""

from ..unported import stubs
from .dataset import Dataset
from .shuffle import Shuffle

__all__ = ["Dataset", "Shuffle"]
__getattr__ = stubs(__name__, {"ParquetWriter": 1})
