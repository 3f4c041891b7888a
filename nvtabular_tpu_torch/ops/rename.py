"""Rename (counterpart of nvtabular_tpu/ops/rename.py): each selected column
under a new name — ``f(name)``, ``name + postfix``, or ``name`` for a
single column."""

from __future__ import annotations

from typing import Callable, Optional

from ..selector import ColumnSelector
from ..table import TableBatch
from .operator import Operator


class Rename(Operator):
    def __init__(self, f: Optional[Callable] = None, postfix: Optional[str] = None, name: Optional[str] = None):
        if not any([f, postfix, name]):
            raise ValueError("Rename requires one of: f, postfix, name")
        super().__init__()
        self.f = f
        self.postfix = postfix
        self.name = name

    def _new_name(self, old: str) -> str:
        if self.f:
            return self.f(old)
        if self.postfix:
            return f"{old}{self.postfix}"
        return self.name

    def column_mapping(self, col_selector: ColumnSelector):
        if self.name and len(col_selector.names) > 1:
            raise ValueError("Rename(name=...) requires exactly one input column")
        return {self._new_name(n): [n] for n in col_selector.names}

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            out[self._new_name(name)] = batch[name]
        return out
