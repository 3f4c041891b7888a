"""Streaming moments — the statistics under Normalize.

Counterpart of ``nvtabular_tpu/ops/moments.py`` (``ColumnMoments``: count,
sum and sum of squares in float64, ddof=1, moments.py:105-119). Each batch
reduces all of its columns at once on the device the batch lives on, in
float64; the running sums stay on that device until ``columns`` reads them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..table import UNSUPPORTED_LISTS, TableBatch


class ColumnMoments:
    __slots__ = ("count", "sum", "sumsq")

    def __init__(self, count: float = 0.0, total: float = 0.0, sumsq: float = 0.0):
        self.count = count  # non-null element count
        self.sum = total
        self.sumsq = sumsq

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def var(self) -> float:
        if self.count <= 1:
            return 0.0
        return max((self.sumsq - self.sum * self.sum / self.count) / (self.count - 1), 0.0)

    @property
    def std(self) -> float:
        return math.sqrt(self.var)


class MomentsState:
    """Per-column moments for a set of columns."""

    def __init__(self, columns: List[str]):
        self.names = list(columns)
        self._acc: Optional[torch.Tensor] = None  # [3, C] float64: count, sum, sumsq

    def update_batch(self, batch: TableBatch) -> "MomentsState":
        cols = [batch[n] for n in self.names]
        if any(c.is_list for c in cols):
            raise NotImplementedError(UNSUPPORTED_LISTS)
        x = torch.stack([c.values.to(torch.float64) for c in cols])
        valid = ~torch.isnan(x)
        for i, c in enumerate(cols):
            if c.validity is not None:
                valid[i] &= c.validity
        safe = torch.where(valid, x, 0.0)
        acc = torch.stack(
            [valid.sum(dim=1, dtype=torch.float64), safe.sum(dim=1), (safe * safe).sum(dim=1)]
        )
        self._acc = acc if self._acc is None else self._acc + acc
        return self

    def merge(self, other: "MomentsState") -> "MomentsState":
        """Another rank's sums added to these (a multi-process fit)."""
        if other._acc is not None:
            self._acc = other._acc if self._acc is None else self._acc + other._acc.to(self._acc.device)
        return self

    @property
    def columns(self) -> Dict[str, ColumnMoments]:
        if self._acc is None:
            return {n: ColumnMoments() for n in self.names}
        acc = self._acc.cpu().tolist()
        return {n: ColumnMoments(acc[0][i], acc[1][i], acc[2][i]) for i, n in enumerate(self.names)}
