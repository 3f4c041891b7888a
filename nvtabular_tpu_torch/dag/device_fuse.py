"""Fuse linear continuous-op chains into one launch of the cont_chain kernel.

Device counterpart of ``nvtabular_tpu/dag/host_fuse.py:45-148``
(``_op_stage``, ``extract_chain``). A chain qualifies when

* its ops are FillMissing, fitted FillMedian, Clip, LogOp and fitted
  Normalize or NormalizeMinMax (float32, float16 or bfloat16 ``out_dtype``),
  linear (one parent, no dependencies), each intermediate consumed only by
  the chain;
* the stages come in the kernel's order fill → clip → log1p → normalize,
  each at most once, at least two of them — or the chain is one fill with
  ``add_binary_cols``, whose ``_filled`` columns the kernel writes as its
  mask (a fill inside a longer chain passes on no ``_filled`` columns: the
  next op selects only the filled ones, as in the reference);
* every op of the chain selects the same column set.

The executor then stacks the chain's float32 input columns into one [C, N]
tensor and makes one kernel launch (kernels/cont_chain.py). Anything outside
the contract runs op by op in plain torch (``out_dtype="float64"`` too).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..kernels.cont_chain import FILL, HI, LO, LOG, NORM, ZERO
from .node import Node

_STAGE_FILL, _STAGE_CLIP, _STAGE_LOG, _STAGE_NORM = 0, 1, 2, 3
_STORES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def _op_stage(op, names) -> Optional[Tuple[int, Dict[str, dict]]]:
    """(stage, per-column params and flag bits) for a fusable op, else None.
    The params carry the ops' own transform constants (fill.py, clip.py,
    normalize.py of this package); a normalize's are rounded to its store."""
    from ..ops.clip import Clip
    from ..ops.fill import FillMedian, FillMissing
    from ..ops.logop import LogOp
    from ..ops.normalize import Normalize, NormalizeMinMax, round_to

    if isinstance(op, FillMedian):
        if not op.fitted:
            return None
        return _STAGE_FILL, {n: {"fill": float(op.medians.get(n, 0.0)), "flags": FILL} for n in names}
    if isinstance(op, FillMissing):
        try:
            fill = float(op.fill_val)
        except (TypeError, ValueError):
            return None
        return _STAGE_FILL, {n: {"fill": fill, "flags": FILL} for n in names}
    if isinstance(op, Clip):
        flags = (LO if op.min_value is not None else 0) | (HI if op.max_value is not None else 0)
        lo = float(op.min_value) if op.min_value is not None else 0.0
        hi = float(op.max_value) if op.max_value is not None else 0.0
        return _STAGE_CLIP, {n: {"lo": lo, "hi": hi, "flags": flags} for n in names}
    if isinstance(op, LogOp):
        return _STAGE_LOG, {n: {"flags": LOG} for n in names}
    if isinstance(op, (Normalize, NormalizeMinMax)):
        if not op.fitted or op.out_name not in _STORES:
            return None
        params = {}
        for n in names:
            sub, div, zero = op.constants(n)
            params[n] = {"sub": round_to(sub, op.out_name), "div": round_to(div, op.out_name),
                         "flags": ZERO if zero else NORM}
        return _STAGE_NORM, params
    return None


class ChainSpec:
    """One fusable chain: its head's parent, columns and kernel arguments."""

    __slots__ = ("head_parent", "names", "params", "out_dtype", "mask", "_device_args")

    def __init__(self, head_parent: Node, names: List[str], params: Dict[str, dict],
                 out_dtype: torch.dtype = torch.float32, mask: bool = False):
        self.head_parent = head_parent
        self.names = names
        self.params = params
        self.out_dtype = out_dtype
        self.mask = mask  # write the _filled columns
        self._device_args: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def has_fill(self) -> bool:
        return any(p["flags"] & FILL for p in self.params.values())

    def kernel_args(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(params [C, 5] float32, flags [C] int32) on ``device``, built once."""
        device = torch.device(device)
        if device not in self._device_args:
            cols = [self.params[n] for n in self.names]
            rows = [[p.get("fill", 0.0), p.get("lo", 0.0), p.get("hi", 0.0), p.get("sub", 0.0), p.get("div", 1.0)]
                    for p in cols]
            self._device_args[device] = (
                torch.tensor(rows, dtype=torch.float32, device=device),
                torch.tensor([p["flags"] for p in cols], dtype=torch.int32, device=device),
            )
        return self._device_args[device]


def extract_chain(tail: Node) -> Optional[ChainSpec]:
    """Walk up from ``tail`` collecting the maximal fusable linear chain."""
    names = list(tail.selector.names) if tail.selector is not None else None
    if not names:
        return None
    chain = []
    cur = tail
    while True:
        if cur.dependencies or len(cur.parents) != 1:
            break
        if cur is not tail and len(cur.children) != 1:
            break  # another consumer needs this intermediate materialized
        sel = list(cur.selector.names) if cur.selector is not None else None
        if sel is None or set(sel) != set(names):
            break
        staged = _op_stage(cur.op, names)
        if staged is None:
            break
        chain.append(staged)
        cur = cur.parents[0]
    mask = bool(chain) and chain[0][0] == _STAGE_FILL and getattr(tail.op, "add_binary_cols", False)
    if len(chain) < 2 and not mask:
        return None
    chain.reverse()  # head -> tail order
    stages = [s for s, _ in chain]
    if any(b <= a for a, b in zip(stages, stages[1:])):
        return None  # out of kernel order, or a stage repeated
    merged: Dict[str, dict] = {n: {"flags": 0} for n in names}
    for _, params in chain:
        for n in names:
            merged[n].update(params[n], flags=merged[n]["flags"] | params[n]["flags"])
    store = tail.op.out_name if stages[-1] == _STAGE_NORM else "float32"
    return ChainSpec(cur, names, merged, _STORES[store], mask)
