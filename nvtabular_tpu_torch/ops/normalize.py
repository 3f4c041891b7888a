"""Normalize and NormalizeMinMax (counterpart of nvtabular_tpu/ops/normalize.py:24-170).

Normalize: z-score standardization from single-pass streaming moments,
``(x - mean) / std``, or ``x - mean`` when std == 0. NormalizeMinMax:
``(x - min) / span`` with ``span = max - min`` taken in float64 and cast
once (normalize.py:141), or zeros where span == 0, NaN inputs included
(``m.zeros_like``, :146-147). Both follow the reference's casts: the input
and each constant go to ``out_dtype`` (float32 by default) first, and each
of the two operations rounds to it, as numpy does under the reference's
LocalExecutor (float16 and bfloat16 included; ROADMAP.md queue 3 records
where XLA's CPU differs). On the device executor a chain that ends in
either (fill → clip → log1p → normalize, float32 or a 16-bit store) runs as
one launch of the cont_chain kernel instead (dag/device_fuse.py);
``out_dtype="float64"`` runs here, in float64.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .. import dtypes as md
from ..selector import ColumnSelector
from ..table import Column, TableBatch
from ..tags import Tags
from .moments import MomentsState
from .stat_operator import StatOperator

_TORCH_FLOATS = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float64": torch.float64}
# significand bits and the frexp exponent of the smallest normal number
_FORMATS = {"float16": (11, -13), "bfloat16": (8, -125)}


def out_dtype_name(out_dtype) -> str:
    """"float32" for None, else the float dtype's name; other dtypes raise."""
    name = "float32" if out_dtype is None else md.normalize(out_dtype).name
    if name not in _TORCH_FLOATS:
        raise NotImplementedError(f"out_dtype {name!r}: the port normalizes into float16, bfloat16, float32 or float64")
    return name


def round_to(x: float, name: str) -> float:
    """The float ``x`` cast to the float dtype ``name``, as the reference's
    constants are (``np.asarray(x, dtype)``): float32 and float16 round x
    once, bfloat16 goes through float32 first (ml_dtypes' conversion)."""
    if name == "float64":
        return float(x)
    if name != "float16":
        x = float(np.float32(x))
    if name not in _FORMATS or not math.isfinite(x) or x == 0.0:
        return x
    bits, emin = _FORMATS[name]
    quantum = math.ldexp(1.0, max(math.frexp(x)[1], emin) - bits)
    y = round(x / quantum) * quantum  # round half to even, exact in float64
    top = math.ldexp(1.0, 16 if name == "float16" else 128)
    return math.copysign(math.inf, y) if abs(y) >= top else y


def affine(vals: torch.Tensor, sub: float, div: float, name: str, zero: bool = False) -> torch.Tensor:
    """``(vals - sub) / div`` in the float dtype ``name``, the input and both
    constants cast to it first and each operation rounded to it; zeros
    where ``zero``. 16-bit values are computed in float32 and rounded after
    each operation, which is the correctly rounded 16-bit result."""
    dtype = _TORCH_FLOATS[name]
    x = vals.to(dtype)
    if zero:
        return torch.zeros_like(x)
    work = torch.float32 if name in _FORMATS else dtype
    sub_t = torch.tensor(round_to(sub, name), dtype=work, device=x.device)
    div_t = torch.tensor(round_to(div, name), dtype=work, device=x.device)
    y = (x.to(work) - sub_t).to(dtype)
    return (y.to(work) / div_t).to(dtype)


class _MomentsOp(StatOperator):
    """The fit both normalizations share: streaming moments of the columns."""

    def __init__(self, out_dtype=None):
        super().__init__()
        out_dtype_name(out_dtype)
        self.out_dtype = out_dtype

    def fit_init(self, col_selector: ColumnSelector, input_schema):
        return MomentsState(col_selector.names)

    def fit_batch(self, col_selector, batch, state: MomentsState):
        return state.update_batch(batch)

    def fit_merge(self, states):
        out = states[0]
        for s in states[1:]:
            out = out.merge(s)
        return out

    @property
    def out_name(self) -> str:
        return out_dtype_name(self.out_dtype)

    @property
    def output_dtype(self):
        return md.normalize(self.out_name)

    @property
    def output_tags(self):
        return [Tags.CONTINUOUS]

    def constants(self, name: str):
        """(sub, div, zero) of the column's transform, as Python floats."""
        raise NotImplementedError

    def transform(self, col_selector: ColumnSelector, batch: TableBatch) -> TableBatch:
        out = TableBatch()
        for name in col_selector.names:
            col = batch[name]
            sub, div, zero = self.constants(name)
            out[name] = Column(affine(col.values, sub, div, self.out_name, zero), col.offsets, col.validity)
        return out


class Normalize(_MomentsOp):
    """(x - mean) / std."""

    def __init__(self, out_dtype=None):
        super().__init__(out_dtype)
        self.means: Dict[str, float] = {}
        self.stds: Dict[str, float] = {}

    def fit_finalize(self, state: MomentsState):
        for name, mom in state.columns.items():
            self.means[name] = mom.mean
            self.stds[name] = mom.std

    def clear(self):
        super().clear()
        self.means, self.stds = {}, {}

    def constants(self, name: str):
        std = self.stds.get(name, 0.0)
        # x - mean when std == 0: dividing by 1 is exact
        return self.means.get(name, 0.0), std if std > 0 else 1.0, False


class NormalizeMinMax(_MomentsOp):
    """(x - min) / (max - min)."""

    def __init__(self, out_dtype=None):
        super().__init__(out_dtype)
        self.mins: Dict[str, float] = {}
        self.maxs: Dict[str, float] = {}

    def fit_finalize(self, state: MomentsState):
        for name, mom in state.columns.items():
            self.mins[name] = mom.min if mom.count else 0.0
            self.maxs[name] = mom.max if mom.count else 0.0

    def clear(self):
        super().clear()
        self.mins, self.maxs = {}, {}

    def constants(self, name: str):
        lo, hi = self.mins.get(name, 0.0), self.maxs.get(name, 0.0)
        span = hi - lo
        return lo, span if span > 0 else 1.0, not span > 0
