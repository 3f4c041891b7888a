"""Fuse linear continuous-op chains into one launch of the cont_chain kernel.

Device counterpart of ``nvtabular_tpu/dag/host_fuse.py:45-148``
(``_op_stage``, ``extract_chain``). A chain qualifies when

* its ops are FillMissing, Clip, LogOp and fitted Normalize, linear (one
  parent, no dependencies), each intermediate consumed only by the chain;
* the stages come in the kernel's order fill → clip → log1p → normalize,
  each at most once, at least two of them;
* every op of the chain selects the same column set.

The executor then stacks the chain's float32 input columns into one [C, N]
tensor and makes one kernel launch (kernels/cont_chain.py). Anything outside
the contract runs op by op in plain torch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..kernels.cont_chain import FILL, HI, LO, LOG, NORM
from .node import Node

_STAGE_FILL, _STAGE_CLIP, _STAGE_LOG, _STAGE_NORM = 0, 1, 2, 3


def _op_stage(op, names) -> Optional[Tuple[int, int, Dict[str, dict]]]:
    """(stage, flag bits, per-column params) for a fusable op, else None.
    The params carry the ops' own transform constants (fill.py, clip.py,
    normalize.py of this package)."""
    from ..ops.clip import Clip
    from ..ops.fill import FillMissing
    from ..ops.logop import LogOp
    from ..ops.normalize import Normalize

    if isinstance(op, FillMissing):
        try:
            fill = float(op.fill_val)
        except (TypeError, ValueError):
            return None
        return _STAGE_FILL, FILL, {n: {"fill": fill} for n in names}
    if isinstance(op, Clip):
        flags = (LO if op.min_value is not None else 0) | (HI if op.max_value is not None else 0)
        lo = float(op.min_value) if op.min_value is not None else 0.0
        hi = float(op.max_value) if op.max_value is not None else 0.0
        return _STAGE_CLIP, flags, {n: {"lo": lo, "hi": hi} for n in names}
    if isinstance(op, LogOp):
        return _STAGE_LOG, LOG, {n: {} for n in names}
    if isinstance(op, Normalize):
        if not op.fitted:
            return None
        params = {}
        for n in names:
            std = float(op.stds.get(n, 0.0))
            # (x - mean) / std, or x - mean when std == 0 (x / 1 is exact)
            params[n] = {"sub": float(op.means.get(n, 0.0)), "div": std if std > 0 else 1.0}
        return _STAGE_NORM, NORM, params
    return None


class ChainSpec:
    """One fusable chain: its head's parent, columns and kernel arguments."""

    __slots__ = ("head_parent", "names", "flags", "params", "_device_args")

    def __init__(self, head_parent: Node, names: List[str], flags: int, params: Dict[str, dict]):
        self.head_parent = head_parent
        self.names = names
        self.flags = flags
        self.params = params
        self._device_args: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def has_fill(self) -> bool:
        return bool(self.flags & FILL)

    def kernel_args(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(params [C, 5] float32, flags [C] int32) on ``device``, built once."""
        device = torch.device(device)
        if device not in self._device_args:
            rows = [
                [p.get("fill", 0.0), p.get("lo", 0.0), p.get("hi", 0.0), p.get("sub", 0.0), p.get("div", 1.0)]
                for p in (self.params[n] for n in self.names)
            ]
            self._device_args[device] = (
                torch.tensor(rows, dtype=torch.float32, device=device),
                torch.full((len(self.names),), self.flags, dtype=torch.int32, device=device),
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
    if len(chain) < 2:
        return None
    chain.reverse()  # head -> tail order
    stages = [s for s, _, _ in chain]
    if any(b <= a for a, b in zip(stages, stages[1:])):
        return None  # out of kernel order, or a stage repeated
    flags = 0
    merged: Dict[str, dict] = {n: {} for n in names}
    for _, bits, params in chain:
        flags |= bits
        for n in names:
            merged[n].update(params[n])
    return ChainSpec(cur, names, flags, merged)
