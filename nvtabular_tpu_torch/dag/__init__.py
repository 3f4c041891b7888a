"""DAG engine: graph DSL, schema propagation, executors
(counterpart of nvtabular_tpu/dag/)."""

from ..selector import ColumnSelector
from .base_operator import BaseOperator, StatOperator
from .graph import Graph, postorder_iter_nodes
from .node import Node
from .ops import ConcatColumns, SelectionOp, SubsetColumns

__all__ = [
    "BaseOperator",
    "ColumnSelector",
    "ConcatColumns",
    "Graph",
    "Node",
    "SelectionOp",
    "StatOperator",
    "SubsetColumns",
    "postorder_iter_nodes",
]
