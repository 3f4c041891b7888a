"""Semantic column tags.

A copy of ``nvtabular_tpu/tags.py``: the analog of the reference's
``merlin.schema.Tags``.
"""

from __future__ import annotations

from enum import Enum
from typing import Iterable, Set, Union


class Tags(Enum):
    # Feature types
    CATEGORICAL = "categorical"
    CONTINUOUS = "continuous"
    LIST = "list"
    SEQUENCE = "sequence"
    TEXT = "text"
    TOKENIZED = "tokenized"
    TIME = "time"

    # Feature context
    ID = "id"
    USER = "user"
    ITEM = "item"
    SESSION = "session"
    CONTEXT = "context"
    USER_ID = "user_id"
    ITEM_ID = "item_id"
    SESSION_ID = "session_id"

    # Targets
    TARGET = "target"
    BINARY = "binary"
    REGRESSION = "regression"
    MULTI_CLASS = "multi_class"

    # Embeddings
    EMBEDDING = "embedding"

    def __str__(self) -> str:
        return self.value


TagLike = Union[str, Tags]

# Compound tags expand into their atomic parts so that selecting by e.g.
# Tags.ID finds columns tagged USER_ID (mirrors reference TagSet semantics).
_COMPOUND = {
    Tags.USER_ID: {Tags.USER, Tags.ID},
    Tags.ITEM_ID: {Tags.ITEM, Tags.ID},
    Tags.SESSION_ID: {Tags.SESSION, Tags.ID},
}

# Tag combinations that conflict on a single column.
_CONFLICTS = [
    {Tags.CATEGORICAL, Tags.CONTINUOUS},
]


def _norm_tag(tag: TagLike) -> Tags:
    if isinstance(tag, Tags):
        return tag
    if isinstance(tag, str):
        try:
            return Tags(tag.lower())
        except ValueError:
            return tag  # type: ignore[return-value]  # free-form string tag
    raise TypeError(f"Cannot interpret {tag!r} as a tag")


class TagSet:
    """An immutable-ish set of tags with compound expansion."""

    def __init__(self, tags: Iterable[TagLike] = ()):  # noqa: D107
        if isinstance(tags, (str, Tags)):
            tags = [tags]
        expanded: Set[Union[Tags, str]] = set()
        for t in tags:
            t = _norm_tag(t)
            expanded.add(t)
            if isinstance(t, Tags) and t in _COMPOUND:
                expanded |= _COMPOUND[t]
        self._tags = expanded
        self._check_conflicts()

    def _check_conflicts(self):
        for conflict in _CONFLICTS:
            if conflict.issubset(self._tags):
                names = sorted(str(t) for t in conflict)
                raise ValueError(f"Tags {names} are mutually exclusive on one column")

    def __contains__(self, tag: TagLike) -> bool:
        return _norm_tag(tag) in self._tags

    def __iter__(self):
        return iter(self._tags)

    def __len__(self) -> int:
        return len(self._tags)

    def __eq__(self, other) -> bool:
        if isinstance(other, TagSet):
            return self._tags == other._tags
        if isinstance(other, (set, frozenset, list, tuple)):
            return self._tags == TagSet(other)._tags
        return NotImplemented

    def __hash__(self):
        return hash(frozenset(self._tags))

    def union(self, other: Iterable[TagLike]) -> "TagSet":
        return TagSet(list(self._tags) + list(TagSet(other)))

    def intersection(self, other: Iterable[TagLike]) -> "TagSet":
        other_set = TagSet(other)._tags
        return TagSet(t for t in self._tags if t in other_set)

    def difference(self, other: Iterable[TagLike]) -> "TagSet":
        other_set = TagSet(other)._tags
        return TagSet(t for t in self._tags if t not in other_set)

    def __or__(self, other):
        return self.union(other)

    def __and__(self, other):
        return self.intersection(other)

    def __sub__(self, other):
        return self.difference(other)

    def to_list(self):
        """Serialize to sorted list of string values."""
        return sorted(str(t) if isinstance(t, Tags) else t for t in self._tags)

    def __repr__(self) -> str:
        return f"TagSet({self.to_list()})"
