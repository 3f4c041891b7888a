"""DAG engine: graph DSL, schema propagation, executors
(counterpart of nvtabular_tpu/dag/)."""

from ..selector import ColumnSelector
from ..unported import stubs
from .base_operator import BaseOperator, StatOperator, Supports
from .graph import Graph, iter_nodes, postorder_iter_nodes
from .node import Node
from .ops import UDF, ConcatColumns, SelectionOp, SubsetColumns

__all__ = [
    "BaseOperator",
    "ColumnSelector",
    "ConcatColumns",
    "Graph",
    "Node",
    "SelectionOp",
    "StatOperator",
    "SubsetColumns",
    "Supports",
    "UDF",
    "iter_nodes",
    "postorder_iter_nodes",
]
__getattr__ = stubs(__name__, {"Subgraph": 2})
