"""Graph node and the ``>>`` / ``+`` / ``-`` construction DSL.

A copy of ``nvtabular_tpu/dag/node.py`` (the ``>>`` and ``+`` DSL at its
lines 63-79).
"""

from __future__ import annotations

from typing import List, Optional, Union

from ..schema import Schema
from ..selector import ColumnSelector
from .base_operator import BaseOperator


class Node:
    def __init__(self, selector: Optional[ColumnSelector] = None, op: Optional[BaseOperator] = None):
        self.parents: List[Node] = []
        self.children: List[Node] = []
        self.dependencies: List[Node] = []

        from .ops import SelectionOp

        if op is not None:
            self.op = op
        elif selector is not None:
            self.op = SelectionOp(selector)
        else:
            self.op = SelectionOp(ColumnSelector())

        self.selector: Optional[ColumnSelector] = _as_selector(selector)
        self.input_schema: Optional[Schema] = None
        self.output_schema: Optional[Schema] = None

    # --- wiring ------------------------------------------------------------
    def add_parent(self, parent: Union["Node", List["Node"]]):
        parents = parent if isinstance(parent, list) else [parent]
        for p in parents:
            p.children.append(self)
        self.parents.extend(parents)

    def add_child(self, child: Union["Node", List["Node"]]):
        children = child if isinstance(child, list) else [child]
        for c in children:
            c.parents.append(self)
        self.children.extend(children)

    def add_dependency(self, dep):
        dep_node = _nodify(dep)
        dep_node.children.append(self)
        self.dependencies.append(dep_node)

    @property
    def parents_with_dependencies(self) -> List["Node"]:
        return list(self.parents) + list(self.dependencies)

    @property
    def grouped_parents_with_dependencies(self) -> List["Node"]:
        return self.parents_with_dependencies

    # --- DSL ------------------------------------------------------------
    def __rshift__(self, op) -> "Node":
        if isinstance(op, type) and issubclass(op, BaseOperator):
            op = op()
        if not isinstance(op, BaseOperator):
            raise TypeError(f"Expected an operator, got {type(op)}")
        child = op.create_node(self.selector)
        child.op = op
        child.add_parent(self)
        deps = op.dependencies
        if deps is not None:
            if not isinstance(deps, list):
                deps = [deps]
            for dep in deps:
                child.add_dependency(dep)
        return child

    def __add__(self, other) -> "Node":
        from .ops import ConcatColumns

        other_node = _nodify(other)
        if isinstance(self.op, ConcatColumns):
            # flatten chained additions into one concat node
            self.add_parent(other_node)
            return self
        node = Node(op=ConcatColumns())
        node.add_parent(self)
        node.add_parent(other_node)
        return node

    def __radd__(self, other):
        if other == 0 or other is None:
            return self
        return _nodify(other) + self

    def __sub__(self, other) -> "Node":
        from .ops import SubsetColumns

        if isinstance(other, Node):
            to_remove = other
        else:
            to_remove = ColumnSelector(other)
        node = Node(op=SubsetColumns(to_remove))
        node.add_parent(self)
        if isinstance(to_remove, Node):
            node.add_dependency(to_remove)
        return node

    def __getitem__(self, columns) -> "Node":
        from .ops import SelectionOp

        if isinstance(columns, str):
            columns = [columns]
        selector = ColumnSelector(list(columns))
        node = Node(selector, op=SelectionOp(selector))
        node.selector = selector
        node.add_parent(self)
        return node

    # --- schema propagation -------------------------------------------------
    def compute_schemas(self, root_schema: Schema, preserve_dtypes: bool = False):
        parents_schema = _sum_schemas([p.output_schema for p in self.parents])
        deps_schema = _sum_schemas([d.output_schema for d in self.dependencies])

        parents_selector = _sum_selectors(
            [_schema_selector(p) for p in self.parents]
        )
        deps_selector = _sum_selectors([_schema_selector(d) for d in self.dependencies])

        self.selector = self.op.compute_selector(
            parents_schema if self.parents else root_schema,
            self.selector,
            parents_selector,
            deps_selector,
        )
        self.input_schema = self.op.compute_input_schema(
            root_schema, parents_schema, deps_schema, self.selector
        )
        prev_output = self.output_schema if preserve_dtypes else None
        self.output_schema = self.op.compute_output_schema(
            self.input_schema, self.selector, prev_output
        )

    # --- misc ------------------------------------------------------------
    @property
    def graph(self):
        from .graph import Graph

        return Graph(self)

    @property
    def label(self) -> str:
        return self.op.label if self.op else "selection"

    @property
    def output_columns(self) -> List[str]:
        if self.output_schema is not None:
            return self.output_schema.column_names
        return []

    def remove_child(self, child: "Node"):
        if child in self.children:
            self.children.remove(child)

    def __repr__(self):
        sel = self.selector.names if self.selector else None
        return f"<Node {self.label} selector={sel}>"


def _as_selector(selector) -> Optional[ColumnSelector]:
    if selector is None or isinstance(selector, ColumnSelector):
        return selector
    return ColumnSelector(selector)


def _nodify(thing) -> Node:
    if isinstance(thing, Node):
        return thing
    if isinstance(thing, BaseOperator):
        raise TypeError("Cannot add an operator directly; use `selector >> op`")
    selector = thing if isinstance(thing, ColumnSelector) else ColumnSelector(thing)
    return Node(selector)


def _sum_schemas(schemas) -> Schema:
    out = Schema()
    for s in schemas:
        if s is not None:
            out = out + s
    return out


def _sum_selectors(selectors) -> ColumnSelector:
    out = ColumnSelector()
    for s in selectors:
        if s is not None:
            out = out + s
    return out


def _schema_selector(node: Node) -> ColumnSelector:
    if node.output_schema is not None:
        return ColumnSelector(node.output_schema.column_names)
    return node.selector or ColumnSelector()
