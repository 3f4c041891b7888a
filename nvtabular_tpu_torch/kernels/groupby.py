"""Group-stat joins: CUDA kernel K10a, its wrappers and plain PyTorch versions.

Both read fitted per-group stat arrays at each row's group index ``gidx``
[G, N] int32 (one row per key group; ``num_groups`` of that group, its pad
slot, for a miss or a null key):

* ``te_encode`` — TargetEncoding's out-of-fold smoothed means for every
  (group, target), with each row's fold hashed from its global row index;
* ``stat_gather`` — JoinGroupby's int32 count and float32 stat columns.

The stat arrays of all groups are concatenated into flat tables and found by
offsets (``TEState``, ``GatherState``), placed on the device once per fit.
The kernels are ``csrc/groupby.cu``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import List

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library
from .hash import fold_ids_plain

_P = ctypes.c_void_p
_ARGTYPES = {
    # gidx, G, T, n, sums, counts, stat_off, fsums, fcnts, fold_off, strides, means,
    # p_smooth, kfold, seed, row_offset, out, stream
    "nvt_te_encode": [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int64] + [_P] * 8
    + [ctypes.c_float, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64, _P, _P],
    # gidx, n, itable, ftable, groups, offs, ki, kf, iout, fout, stream
    "nvt_stat_gather": [_P, ctypes.c_int64] + [_P] * 4 + [ctypes.c_int, ctypes.c_int] + [_P] * 3,
}


def _fn(name: str):
    fn = getattr(library("groupby"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _tensors_to(obj, device):
    return dataclasses.replace(obj, **{k: v.to(device) for k, v in vars(obj).items() if isinstance(v, torch.Tensor)})


@dataclass
class TEState:
    """Fitted TargetEncoding stats of G groups and T targets, flat.

    ``sums``/``counts`` float32: the padded per-group arrays of every
    (g, t), entry j = g * T + t starting at ``stat_off[j]`` (int64 [G*T]).
    With kfold > 1, ``fsums``/``fcnts`` float32 hold each (g, t)'s in-fold
    [kfold, stride_g] matrix from ``fold_off[j]``; ``strides`` int64 [G] is
    num_groups + 1 of each group. ``means`` float32 [T]."""

    sums: torch.Tensor
    counts: torch.Tensor
    stat_off: torch.Tensor
    fsums: torch.Tensor
    fcnts: torch.Tensor
    fold_off: torch.Tensor
    strides: torch.Tensor
    means: torch.Tensor
    p_smooth: float
    kfold: int
    fold_seed: int

    def to(self, device) -> "TEState":
        return _tensors_to(self, device)


@dataclass
class GatherState:
    """JoinGroupby's K output columns over two flat tables: columns k < ``ki``
    are int32 counts read from ``itable``, the rest float32 stats read from
    ``ftable``. Column k reads group index row ``groups[k]`` (int32 [K]) at
    offset ``offs[k]`` (int64 [K]) of its table."""

    itable: torch.Tensor
    ftable: torch.Tensor
    groups: torch.Tensor
    offs: torch.Tensor
    ki: int

    def to(self, device) -> "GatherState":
        return _tensors_to(self, device)


def _check_gidx(gidx):
    if gidx.dim() != 2:
        raise ValueError(f"gidx must be [G, N], got shape {tuple(gidx.shape)}")
    check(gidx, "gidx", torch.int32, gidx.device)


# --- TargetEncoding ------------------------------------------------------------------
def te_encode(gidx: torch.Tensor, st: TEState, row_offset: int) -> torch.Tensor:
    """Replaces ``TargetEncoding._transform_device``'s gathers and epilogue
    (nvtabular_tpu/ops/target_encoding.py:307-362) with the fold ids of
    ``_fold_ids_dev`` (:39-50) fused. Returns float32 [G * T, N]."""
    _check_gidx(gidx)
    dev = gidx.device
    G, N = gidx.shape
    T = st.means.shape[0]
    check(st.sums, "sums", torch.float32, dev)
    check(st.counts, "counts", torch.float32, dev, st.sums.shape)
    check(st.stat_off, "stat_off", torch.int64, dev, (G * T,))
    check(st.means, "means", torch.float32, dev)
    check(st.strides, "strides", torch.int64, dev, (G,))
    if st.kfold > 1:
        check(st.fsums, "fsums", torch.float32, dev)
        check(st.fcnts, "fcnts", torch.float32, dev, st.fsums.shape)
        check(st.fold_off, "fold_off", torch.int64, dev, (G * T,))
    if row_offset < 0:
        raise ValueError(f"row_offset must be >= 0, got {row_offset}")
    if not use_kernel(gidx):
        return te_encode_plain(gidx, st, row_offset)
    out = torch.empty((G * T, N), dtype=torch.float32, device=dev)
    if G and T and N:
        folds = st.kfold > 1
        rc = _fn("nvt_te_encode")(
            ptr(gidx), G, T, N, ptr(st.sums), ptr(st.counts), ptr(st.stat_off),
            ptr(st.fsums if folds else None), ptr(st.fcnts if folds else None),
            ptr(st.fold_off if folds else None), ptr(st.strides), ptr(st.means),
            float(st.p_smooth), st.kfold, st.fold_seed & 0xFFFFFFFF, row_offset, ptr(out), stream_ptr(dev),
        )
        raise_on_error(rc, "te_encode")
        LAUNCHES["te_encode"] += 1
    return out


def te_encode_plain(gidx: torch.Tensor, st: TEState, row_offset: int) -> torch.Tensor:
    G, N = gidx.shape
    T = st.means.shape[0]
    p = torch.tensor(st.p_smooth, dtype=torch.float32, device=gidx.device)
    idx = gidx.long()
    fold = None
    if st.kfold > 1:
        fold = fold_ids_plain(row_offset, N, st.kfold, st.fold_seed, gidx.device).long()
    rows: List[torch.Tensor] = []
    for g in range(G):
        for t in range(T):
            j = g * T + t
            at = st.stat_off[j] + idx[g]
            s, c = st.sums[at], st.counts[at]
            if fold is not None:
                f = st.fold_off[j] + fold * st.strides[g] + idx[g]
                s, c = s - st.fsums[f], c - st.fcnts[f]
            mean = st.means[t]
            denom = c + p
            te = (s + p * mean) / torch.clamp(denom, min=1e-12)
            rows.append(torch.where(denom > 0, te, mean))
    if not rows:
        return torch.empty((G * T, N), dtype=torch.float32, device=gidx.device)
    return torch.stack(rows)


# --- JoinGroupby ----------------------------------------------------------------------
def stat_gather(gidx: torch.Tensor, st: GatherState):
    """Replaces ``JoinGroupby._transform_device``'s gathers
    (nvtabular_tpu/ops/join_groupby.py:255-282). Returns (int32 [ki, N],
    float32 [K - ki, N])."""
    _check_gidx(gidx)
    dev = gidx.device
    K = st.groups.shape[0]
    check(st.itable, "itable", torch.int32, dev)
    check(st.ftable, "ftable", torch.float32, dev)
    check(st.groups, "groups", torch.int32, dev, (K,))
    check(st.offs, "offs", torch.int64, dev, (K,))
    if not 0 <= st.ki <= K:
        raise ValueError(f"ki must be in [0, {K}], got {st.ki}")
    if not use_kernel(gidx):
        return stat_gather_plain(gidx, st)
    N = gidx.shape[1]
    iout = torch.empty((st.ki, N), dtype=torch.int32, device=dev)
    fout = torch.empty((K - st.ki, N), dtype=torch.float32, device=dev)
    if K and N:
        rc = _fn("nvt_stat_gather")(
            ptr(gidx), N, ptr(st.itable), ptr(st.ftable), ptr(st.groups), ptr(st.offs), st.ki,
            K - st.ki, ptr(iout), ptr(fout), stream_ptr(dev),
        )
        raise_on_error(rc, "stat_gather")
        LAUNCHES["stat_gather"] += 1
    return iout, fout


def stat_gather_plain(gidx: torch.Tensor, st: GatherState):
    N = gidx.shape[1]
    cols = [
        (st.itable if k < st.ki else st.ftable)[st.offs[k] + gidx[int(st.groups[k])].long()]
        for k in range(st.groups.shape[0])
    ]
    iout = torch.stack(cols[: st.ki]) if st.ki else torch.empty((0, N), dtype=torch.int32, device=gidx.device)
    rest = cols[st.ki:]
    fout = torch.stack(rest) if rest else torch.empty((0, N), dtype=torch.float32, device=gidx.device)
    return iout, fout
