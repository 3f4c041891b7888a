"""nvtabular_tpu_torch — the PyTorch and CUDA port of nvtabular_tpu.

Fits and transforms tabular feature-engineering workflows on an NVIDIA GPU
(Hopper, sm_90a), and feeds the transformed data through ``loader.DeviceLoader``
into DLRM, DeepFM, DCN-v2 and tabular-MLP training (``models``): the device
transform's lookup, continuous-chain, hash, hash-pair, group-stat,
bucketize, shift and ragged kernels, the loader's row permutation, and the
models' embedding gathers, bags, dot interaction, FM terms and cross-layer
epilogue (forward and backward) are hand-written
CUDA (``csrc/``), each beside a plain PyTorch version that the CPU runs. Entry
points run on ``cuda:0`` unless the caller passes ``device="cpu"``. The JAX package ``nvtabular_tpu`` is the reference this
port is held against; nothing here imports it or JAX.
"""

__version__ = "0.1.0"

from . import dtypes, ops
from .convert import (
    dcn_params,
    deepfm_params,
    dlrm_params,
    fitted_state,
    load_dcn_params,
    load_deepfm_params,
    load_dlrm_params,
    load_fitted_state,
    load_sharded_table,
    load_tabular_mlp_params,
    tabular_mlp_params,
)
from .dag import ColumnSelector, Graph, Node
from .io import Dataset, Shuffle
from .schema import ColumnSchema, Schema
from .table import Column, TableBatch
from .tags import Tags, TagSet
from .workflow import Workflow, WorkflowNode

__all__ = [
    "Column",
    "ColumnSchema",
    "ColumnSelector",
    "Dataset",
    "Graph",
    "Node",
    "Schema",
    "Shuffle",
    "TableBatch",
    "TagSet",
    "Tags",
    "Workflow",
    "WorkflowNode",
    "dcn_params",
    "deepfm_params",
    "dlrm_params",
    "dtypes",
    "fitted_state",
    "load_dcn_params",
    "load_deepfm_params",
    "load_dlrm_params",
    "load_fitted_state",
    "load_sharded_table",
    "load_tabular_mlp_params",
    "ops",
    "tabular_mlp_params",
]
