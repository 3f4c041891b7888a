"""Column and dataset schemas.

A copy of ``nvtabular_tpu/schema.py``: ``Schema``/``ColumnSchema`` with tags,
properties, dtype and is_list/is_ragged.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterable, List, Optional, Union

from . import dtypes as md
from .tags import TagLike, Tags, TagSet


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    tags: TagSet = field(default_factory=TagSet)
    properties: Dict[str, Any] = field(default_factory=dict)
    dtype: md.DType = md.unknown
    is_list: bool = False
    is_ragged: bool = False
    shape: Optional[md.Shape] = None

    def __post_init__(self):
        # normalize loosely-typed constructor args
        if not isinstance(self.tags, TagSet):
            object.__setattr__(self, "tags", TagSet(self.tags or ()))
        if not isinstance(self.dtype, md.DType):
            object.__setattr__(self, "dtype", md.normalize(self.dtype))
        shape = self.shape
        if shape is None:
            if self.is_list:
                vc = self.properties.get("value_count", {})
                shape = md.Shape.list(vc.get("min", 0), vc.get("max"))
            else:
                shape = md.Shape.scalar()
            object.__setattr__(self, "shape", shape)
        if shape.is_list and not self.is_list:
            object.__setattr__(self, "is_list", True)
        if self.is_list:
            object.__setattr__(self, "is_ragged", shape.is_ragged)
        # keep value_count property in sync with a bounded list shape
        if self.is_list and shape.dims and shape.dims[1].is_bounded:
            props = dict(self.properties)
            props.setdefault(
                "value_count", {"min": shape.dims[1].min, "max": shape.dims[1].max}
            )
            object.__setattr__(self, "properties", props)

    # --- builders -------------------------------------------------------
    def with_name(self, name: str) -> "ColumnSchema":
        return replace(self, name=name)

    def with_dtype(self, dtype, is_list=None, is_ragged=None) -> "ColumnSchema":
        out = replace(self, dtype=md.normalize(dtype))
        if is_list is not None:
            shape = md.Shape.list() if is_list else md.Shape.scalar()
            out = replace(out, is_list=is_list, shape=shape)
        if is_ragged is not None and out.is_list:
            if not is_ragged and out.shape.dims and out.shape.dims[1].is_bounded:
                pass  # fixed already captured by shape
            object.__setattr__(out, "is_ragged", is_ragged)
        return out

    def with_tags(self, tags: Union[TagLike, Iterable[TagLike]]) -> "ColumnSchema":
        return replace(self, tags=self.tags.union(TagSet(tags)))

    def without_tags(self, tags: Union[TagLike, Iterable[TagLike]]) -> "ColumnSchema":
        drop = set(TagSet(tags))
        return replace(self, tags=TagSet([t for t in self.tags if t not in drop]))

    def with_properties(self, properties: Dict[str, Any]) -> "ColumnSchema":
        props = dict(self.properties)
        props.update(properties)
        new = replace(self, properties=props)
        vc = props.get("value_count")
        if vc:
            shape = md.Shape.list(vc.get("min", 0), vc.get("max"))
            new = replace(new, shape=shape, is_list=True, is_ragged=shape.is_ragged)
        return new

    def with_shape(self, shape: md.Shape) -> "ColumnSchema":
        return replace(
            self, shape=shape, is_list=shape.is_list, is_ragged=shape.is_ragged
        )

    # --- info -----------------------------------------------------------
    @property
    def int_domain(self) -> Optional[Dict[str, int]]:
        return self.properties.get("domain")

    @property
    def value_count(self) -> Optional[Dict[str, int]]:
        return self.properties.get("value_count")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "tags": self.tags.to_list(),
            "properties": _jsonify(self.properties),
            "dtype": self.dtype.name,
            "is_list": self.is_list,
            "is_ragged": self.is_ragged,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ColumnSchema":
        return cls(
            name=data["name"],
            tags=TagSet(data.get("tags", ())),
            properties=data.get("properties", {}) or {},
            dtype=md.normalize(data.get("dtype")),
            is_list=data.get("is_list", False),
            is_ragged=data.get("is_ragged", False),
        )


def _jsonify(obj):
    import numpy as np

    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class Schema:
    """Ordered mapping of column name -> ColumnSchema."""

    def __init__(self, column_schemas: Union[Iterable, Dict, None] = None):
        self.column_schemas: Dict[str, ColumnSchema] = {}
        if column_schemas is None:
            column_schemas = []
        if isinstance(column_schemas, dict):
            column_schemas = list(column_schemas.values())
        for cs in column_schemas:
            if isinstance(cs, str):
                cs = ColumnSchema(cs)
            self.column_schemas[cs.name] = cs

    # --- container protocol ----------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return list(self.column_schemas.keys())

    def __len__(self):
        return len(self.column_schemas)

    def __iter__(self):
        return iter(self.column_schemas.values())

    def __contains__(self, name) -> bool:
        return name in self.column_schemas

    def __getitem__(self, key) -> Union[ColumnSchema, "Schema"]:
        if isinstance(key, str):
            return self.column_schemas[key]
        return self.select_by_name(list(key))

    def get(self, name, default=None):
        return self.column_schemas.get(name, default)

    def __eq__(self, other):
        if not isinstance(other, Schema):
            return NotImplemented
        return self.column_schemas == other.column_schemas

    def __add__(self, other: "Schema") -> "Schema":
        merged = dict(self.column_schemas)
        for name, cs in other.column_schemas.items():
            merged[name] = cs
        return Schema(list(merged.values()))

    def __sub__(self, other: "Schema") -> "Schema":
        return Schema(
            [cs for n, cs in self.column_schemas.items() if n not in other]
        )

    # --- selection ---------------------------------------------------------
    def select_by_name(self, names: Union[str, Iterable[str]]) -> "Schema":
        if isinstance(names, str):
            names = [names]
        return Schema([self.column_schemas[n] for n in names if n in self.column_schemas])

    def select_by_tag(self, tags: Union[TagLike, Iterable[TagLike]]) -> "Schema":
        want = TagSet(tags)
        out = []
        for cs in self:
            if any(t in cs.tags for t in want):
                out.append(cs)
        return Schema(out)

    def excluding_by_name(self, names: Iterable[str]) -> "Schema":
        drop = set(names)
        return Schema([cs for cs in self if cs.name not in drop])

    def excluding_by_tag(self, tags) -> "Schema":
        want = TagSet(tags)
        return Schema([cs for cs in self if not any(t in cs.tags for t in want)])

    def apply(self, selector) -> "Schema":
        """Resolve a ColumnSelector against this schema."""
        if selector is None or (not selector.names and not selector.tags and selector.all):
            return self
        out = Schema()
        if selector.all:
            return self
        if selector.tags:
            out = out + self.select_by_tag(selector.tags)
        if selector.names:
            out = out + self.select_by_name(selector.names)
        # preserve this schema's column order
        ordered = [self.column_schemas[n] for n in self.column_names if n in out]
        # append any selected names not in this schema order (shouldn't happen)
        for cs in out:
            if cs.name not in {c.name for c in ordered}:
                ordered.append(cs)
        return Schema(ordered)

    def apply_inverse(self, selector) -> "Schema":
        if selector is None:
            return self
        selected = self.apply(selector)
        return self - selected

    # --- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {"columns": [cs.to_dict() for cs in self]}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Schema":
        return cls([ColumnSchema.from_dict(c) for c in data.get("columns", [])])

    def __repr__(self):
        rows = ", ".join(
            f"{cs.name}:{cs.dtype.name}{'[list]' if cs.is_list else ''}" for cs in self
        )
        return f"Schema([{rows}])"
