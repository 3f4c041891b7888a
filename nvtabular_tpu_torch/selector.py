"""Column selection DSL.

A copy of ``nvtabular_tpu/selector.py``: names, tags,
``grouped_names``/``subgroups`` for multi-column (joint) groups, ``+``
concatenation.

Grouping: ``ColumnSelector([["a", "b"], "c"])`` keeps ("a","b") as a subgroup
so ops like Categorify can treat it as one crossed/joint feature, while
``names`` flattens to ["a", "b", "c"].
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Union

from .tags import TagLike, Tags, TagSet


class ColumnSelector:
    def __init__(
        self,
        names: Union[str, Iterable, None] = None,
        subgroups: Optional[List["ColumnSelector"]] = None,
        tags: Union[TagLike, Iterable[TagLike], None] = None,
    ):
        self.all = False
        self._names: List[str] = []
        self.subgroups: List[ColumnSelector] = list(subgroups or [])
        if isinstance(tags, (str, Tags)):
            tags = [tags]
        self.tags: List = [t for t in (tags or [])]

        # entry order: list of ("n", name) | ("g", subgroup_index), so names
        # and grouped_names preserve the user's declaration order
        self._order: List = [("g", i) for i in range(len(self.subgroups))]

        if names is None:
            names = []
        if isinstance(names, str):
            if names == "*":
                self.all = True
            else:
                self._add_name(names)
        elif isinstance(names, Tags):
            self.tags.append(names)
        elif isinstance(names, ColumnSelector):
            for n in names._names:
                self._add_name(n)
            for sub in names.subgroups:
                if sub not in self.subgroups:
                    self._add_group(sub)
            self.tags.extend(names.tags)
            self.all = names.all
        else:
            for entry in names:
                if isinstance(entry, (list, tuple)):
                    self._add_group(ColumnSelector(list(entry)))
                elif isinstance(entry, ColumnSelector):
                    self._add_group(entry)
                elif isinstance(entry, Tags):
                    self.tags.append(entry)
                elif entry == "*":
                    self.all = True
                else:
                    self._add_name(entry)

    def _add_name(self, name: str):
        self._names.append(name)
        self._order.append(("n", name))

    def _add_group(self, sub: "ColumnSelector"):
        self.subgroups.append(sub)
        self._order.append(("g", len(self.subgroups) - 1))

    @property
    def names(self) -> List[str]:
        out = []
        for kind, val in self._ordered_entries():
            if kind == "n":
                out.append(val)
            else:
                out.extend(val.names)
        # dedupe preserving order
        seen = set()
        uniq = []
        for n in out:
            if n not in seen:
                seen.add(n)
                uniq.append(n)
        return uniq

    def _ordered_entries(self):
        emitted_groups = set()
        for kind, val in self._order:
            if kind == "n":
                yield ("n", val)
            else:
                emitted_groups.add(val)
                yield ("g", self.subgroups[val])
        for i, sub in enumerate(self.subgroups):
            if i not in emitted_groups:
                yield ("g", sub)

    @property
    def grouped_names(self) -> List[Union[str, tuple]]:
        """Names with subgroups kept as tuples, in declaration order."""
        out: List[Union[str, tuple]] = []
        for kind, val in self._ordered_entries():
            if kind == "n":
                out.append(val)
            else:
                out.append(tuple(val.names))
        return out

    def __add__(self, other) -> "ColumnSelector":
        if other is None:
            return self
        if isinstance(other, str):
            other = ColumnSelector([other])
        elif isinstance(other, (list, tuple)):
            other = ColumnSelector(list(other))
        elif isinstance(other, Tags):
            other = ColumnSelector(tags=[other])
        if not isinstance(other, ColumnSelector):
            raise TypeError(f"Cannot add {type(other)} to ColumnSelector")
        result = ColumnSelector(
            list(self._names) + list(other._names),
            subgroups=self.subgroups + other.subgroups,
            tags=self.tags + other.tags,
        )
        result.all = self.all or other.all
        return result

    def __radd__(self, other):
        if other == 0 or other is None:  # support sum()
            return self
        return ColumnSelector(other) + self

    def __rshift__(self, operator):
        # allow `ColumnSelector >> op` to start a graph
        from .dag.node import Node

        return Node(self) >> operator

    def __eq__(self, other):
        if not isinstance(other, ColumnSelector):
            return NotImplemented
        return (
            self._names == other._names
            and [s.names for s in self.subgroups] == [s.names for s in other.subgroups]
            and set(map(str, self.tags)) == set(map(str, other.tags))
            and self.all == other.all
        )

    def __bool__(self):
        return bool(self._names or self.subgroups or self.tags or self.all)

    def __repr__(self):
        parts = []
        if self.all:
            parts.append("*")
        if self._names:
            parts.append(f"names={self._names}")
        if self.subgroups:
            parts.append(f"subgroups={[s.names for s in self.subgroups]}")
        if self.tags:
            parts.append(f"tags={[str(t) for t in self.tags]}")
        return f"ColumnSelector({', '.join(parts)})"

    def filter_columns(self, other: "ColumnSelector") -> "ColumnSelector":
        """Remove any columns in `other` from this selector."""
        drop = set(other.names)
        names = [n for n in self._names if n not in drop]
        subgroups = [s for s in self.subgroups if not set(s.names) & drop]
        return ColumnSelector(names, subgroups=subgroups, tags=self.tags)

    def resolve(self, schema) -> "ColumnSelector":
        """Expand tag selections into concrete names against a schema."""
        if self.all:
            return ColumnSelector(schema.column_names)
        names = []
        if self.tags:
            names.extend(schema.select_by_tag(self.tags).column_names)
        names.extend(n for n in self._names if n in schema or True)
        seen = set()
        flat = []
        for n in names:
            if n not in seen:
                seen.add(n)
                flat.append(n)
        return ColumnSelector(flat, subgroups=self.subgroups)

    def to_dict(self):
        return {
            "names": list(self._names),
            "subgroups": [s.to_dict() for s in self.subgroups],
            "tags": [str(t) for t in self.tags],
            "all": self.all,
        }

    @classmethod
    def from_dict(cls, data):
        if data is None:
            return None
        sel = cls(
            data.get("names", []),
            subgroups=[cls.from_dict(s) for s in data.get("subgroups", [])],
            tags=data.get("tags", []),
        )
        sel.all = data.get("all", False)
        return sel
