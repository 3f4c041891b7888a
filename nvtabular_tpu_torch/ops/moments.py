"""Streaming moments and the reservoir sample — the statistics under
Normalize, NormalizeMinMax, ReduceDtypeSize, DataStats and FillMedian.

Counterpart of ``nvtabular_tpu/ops/moments.py`` (``ColumnMoments``: count,
sum and sum of squares in float64, ddof=1, moments.py:105-119, with the
minimum, maximum, null count and row count). Each batch reduces all of its
columns at once on the device the batch lives on, in float64; the running
sums stay on that device until ``columns`` reads them. ``ReservoirSample``
is a copy of the reference's (moments.py:160-224), draw for draw.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..table import UNSUPPORTED_LISTS, TableBatch


class ColumnMoments:
    __slots__ = ("count", "sum", "sumsq", "min", "max", "null_count", "total_rows")

    def __init__(self, count: float = 0.0, total: float = 0.0, sumsq: float = 0.0, lo: float = math.inf,
                 hi: float = -math.inf, null_count: float = 0.0, total_rows: float = 0.0):
        self.count = count  # non-null element count
        self.sum = total
        self.sumsq = sumsq
        self.min = lo  # over the non-null values; inf / -inf before any
        self.max = hi
        self.null_count = null_count
        self.total_rows = total_rows

    def merge(self, other: "ColumnMoments") -> "ColumnMoments":
        return ColumnMoments(self.count + other.count, self.sum + other.sum, self.sumsq + other.sumsq,
                             min(self.min, other.min), max(self.max, other.max),
                             self.null_count + other.null_count, self.total_rows + other.total_rows)

    @classmethod
    def of(cls, col) -> "ColumnMoments":
        """One column's moments, as the reference's ``update_batch`` counts
        them (moments.py:64-100): a list column counts its flat values, NaN
        excluded, and its null rows by its validity."""
        x = col.values.to(torch.float64)
        nulls = col.is_null()
        valid = ~torch.isnan(x) if col.is_list else ~(nulls | torch.isnan(x))
        safe = torch.where(valid, x, 0.0)
        count = int(valid.sum())
        return cls(float(count), float(safe.sum()), float((safe * safe).sum()),
                   float(torch.where(valid, x, math.inf).min()) if count else math.inf,
                   float(torch.where(valid, x, -math.inf).max()) if count else -math.inf,
                   float(nulls.sum()), float(len(col)))

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
        # [5, C] float64 sums (count, sum, sumsq, nulls, rows) and [2, C]
        # extremes (min, max)
        self._acc: Optional[torch.Tensor] = None
        self._ext: Optional[torch.Tensor] = None

    def update_batch(self, batch: TableBatch) -> "MomentsState":
        cols = [batch[n] for n in self.names]
        if any(c.is_list for c in cols):
            raise NotImplementedError(UNSUPPORTED_LISTS)
        x = torch.stack([c.values.to(torch.float64) for c in cols])
        null = torch.stack([c.is_null() for c in cols])
        valid = ~(null | torch.isnan(x))
        safe = torch.where(valid, x, 0.0)
        rows = torch.full((len(cols),), float(x.shape[1]), dtype=torch.float64, device=x.device)
        acc = torch.stack(
            [valid.sum(dim=1, dtype=torch.float64), safe.sum(dim=1), (safe * safe).sum(dim=1),
             null.sum(dim=1, dtype=torch.float64), rows]
        )
        ext = torch.tensor([[math.inf], [-math.inf]], dtype=torch.float64, device=x.device).repeat(1, len(cols))
        if x.shape[1]:
            ext = torch.stack([torch.where(valid, x, math.inf).amin(dim=1), torch.where(valid, x, -math.inf).amax(dim=1)])
        return self._add(acc, ext)

    def _add(self, acc: torch.Tensor, ext: torch.Tensor) -> "MomentsState":
        if self._acc is None:
            self._acc, self._ext = acc, ext
        else:
            acc, ext = acc.to(self._acc.device), ext.to(self._acc.device)
            self._acc = self._acc + acc
            self._ext = torch.stack([torch.minimum(self._ext[0], ext[0]), torch.maximum(self._ext[1], ext[1])])
        return self

    def merge(self, other: "MomentsState") -> "MomentsState":
        """Another rank's moments folded into these (a multi-process fit)."""
        return self if other._acc is None else self._add(other._acc, other._ext)

    @property
    def columns(self) -> Dict[str, ColumnMoments]:
        if self._acc is None:
            return {n: ColumnMoments() for n in self.names}
        acc, ext = self._acc.cpu().tolist(), self._ext.cpu().tolist()
        return {
            n: ColumnMoments(acc[0][i], acc[1][i], acc[2][i], ext[0][i], ext[1][i], acc[3][i], acc[4][i])
            for i, n in enumerate(self.names)
        }


class ReservoirSample:
    """Bounded uniform sample for approximate quantiles (the median): a copy
    of the reference's (moments.py:160-224) — capacity 131,072, the same
    ``np.random.default_rng`` draws in the same order, exact below capacity —
    so a fit on the same rows in the same order, one process or several,
    keeps the same sample and the same median."""

    def __init__(self, capacity: int = 131072, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self.buf = np.empty(0, dtype=np.float64)
        self.seen = 0

    def update(self, values: np.ndarray) -> None:
        values = np.asarray(values, dtype=np.float64)
        values = values[~np.isnan(values)]
        if len(values) == 0:
            return
        room = self.capacity - len(self.buf)
        if room > 0:
            take = min(room, len(values))
            self.buf = np.concatenate([self.buf, values[:take]])
            self.seen += take
            values = values[take:]
        if len(values) == 0:
            return
        # element i (stream position seen + i + 1) draws slot j ~ U[0, seen + i + 1);
        # accepted writes apply in stream order (fancy assignment is sequential)
        positions = self.seen + np.arange(1, len(values) + 1, dtype=np.float64)
        j = (self.rng.random(len(values)) * positions).astype(np.int64)
        accept = j < self.capacity
        self.buf[j[accept]] = values[accept]
        self.seen += len(values)

    def merge(self, other: "ReservoirSample") -> "ReservoirSample":
        """Each side keeps slots in proportion to the stream rows its buffer
        stands for (the multi-process fit merges the ranks' samples so)."""
        out = ReservoirSample(self.capacity)
        out.seen = self.seen + other.seen
        if len(self.buf) + len(other.buf) <= self.capacity:
            out.buf = np.concatenate([self.buf, other.buf])
            return out
        if out.seen <= 0:
            return out
        k = self.capacity
        na = int(round(k * (self.seen / out.seen)))
        na = min(max(na, k - len(other.buf)), len(self.buf), k)
        nb = k - na
        parts = []
        if na > 0:
            parts.append(self.buf[out.rng.choice(len(self.buf), na, replace=False)])
        if nb > 0:
            parts.append(other.buf[out.rng.choice(len(other.buf), nb, replace=False)])
        out.buf = np.concatenate(parts) if parts else np.empty(0, dtype=np.float64)
        return out

    def quantile(self, q: float) -> float:
        if len(self.buf) == 0:
            return 0.0
        return float(np.quantile(self.buf, q))
