"""Graph: DAG container + schema propagation pass.

Counterpart of ``nvtabular_tpu/dag/graph.py`` (``construct_schema`` at its
line 59, ``stat_phases`` at line 112), without subgraphs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..schema import Schema
from ..selector import ColumnSelector
from .node import Node


def iter_nodes(nodes: List[Node]):
    """Breadth first over ``nodes`` and everything upstream of them."""
    queue = list(nodes)
    seen: Set[int] = set()
    while queue:
        node = queue.pop(0)
        if id(node) in seen:
            continue
        seen.add(id(node))
        yield node
        queue.extend(node.parents_with_dependencies)


def postorder_iter_nodes(output_node: Node) -> List[Node]:
    """Topological order: every node after all of its inputs."""
    order: List[Node] = []
    visited: Set[int] = set()

    def visit(node: Node):
        if id(node) in visited:
            return
        visited.add(id(node))
        for parent in node.parents_with_dependencies:
            visit(parent)
        order.append(node)

    visit(output_node)
    return order


class Graph:
    def __init__(self, output_node: Node):
        if not isinstance(output_node, Node):
            output_node = Node(ColumnSelector(output_node))
        self.output_node = output_node

    def construct_schema(self, root_schema: Schema) -> "Graph":
        for node in postorder_iter_nodes(self.output_node):
            node.compute_schemas(root_schema)
        return self

    @property
    def input_schema(self) -> Optional[Schema]:
        leaves = self.leaf_nodes
        if not leaves or any(n.input_schema is None for n in leaves):
            return None
        out = Schema()
        for n in leaves:
            out = out + n.input_schema
        return out

    @property
    def input_dtypes(self):
        schema = self.input_schema
        return {cs.name: cs.dtype for cs in schema} if schema else {}

    @property
    def output_schema(self) -> Optional[Schema]:
        return self.output_node.output_schema

    @property
    def output_dtypes(self):
        schema = self.output_schema
        return {cs.name: cs.dtype for cs in schema} if schema else {}

    @property
    def nodes(self) -> List[Node]:
        return postorder_iter_nodes(self.output_node)

    @property
    def leaf_nodes(self) -> List[Node]:
        return [n for n in self.nodes if not n.parents_with_dependencies]

    def stat_phases(self) -> List[List[Node]]:
        """Group StatOperator nodes into phases: a stat op whose upstream
        holds another unfitted stat op waits for the earlier phase."""
        from .base_operator import StatOperator

        depth: Dict[int, int] = {}
        phases: Dict[int, List[Node]] = {}
        for node in self.nodes:  # topo order
            d = 0
            for parent in node.parents_with_dependencies:
                d = max(d, depth.get(id(parent), 0))
            if isinstance(node.op, StatOperator):
                phases.setdefault(d, []).append(node)
                d += 1
            depth[id(node)] = d
        return [phases[k] for k in sorted(phases)]

    def __repr__(self):
        return f"<Graph nodes={len(self.nodes)} output={self.output_node.label}>"
