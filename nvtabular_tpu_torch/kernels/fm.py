"""DeepFM's FM terms and their gradient: CUDA kernel K16, wrappers, plain versions.

For features ``v`` float32 [B, F, D], ids of F columns and the dense
features [B, nd], the FM output of a row is

    fm[b] = sum_f linear[offsets[f] + ids[f][b]] + dense[b] . dense_w
            + 0.5 * sum_d [(sum_f v[b, f, d])**2 - sum_f v[b, f, d]**2]

as ``nvtabular_tpu/models/deepfm.py:58-68`` computes it, with the linear
weights of every table in one float32 [sum V] tensor (the tables' order and
offsets of the embedding table) and ids following ``jnp.take``'s rules (a
negative id wraps once, an id still out of range gives NaN and no
gradient). ``v`` and ``dense`` may be strided views of a wider buffer (each
row contiguous): DeepFM passes the two blocks of its [B, F*D + nd] deep
input. The kernels are ``csrc/fm.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import LAUNCHES, check, check_rows, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library
from .embedding import LAUNCH_COLUMNS, c_columns, check_view, table_rows

# ids, offsets, sizes, the card's column table, F, D, ...
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
]
_BWD_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
]


def _check_inputs(v, dense, ids, offsets, sizes, num_rows: int, dense_w) -> Tuple[int, int, int, int]:
    """Validates the inputs of both directions; returns (B, F, D, nd)."""
    if v.dim() != 3:
        raise ValueError(f"v must be [B, F, D], got shape {tuple(v.shape)}")
    B, F, D = v.shape
    dev = v.device
    check_view(v, "v", (B, F, D), dev)
    if dense.dim() != 2:
        raise ValueError(f"dense must be [B, nd], got shape {tuple(dense.shape)}")
    nd = dense.shape[1]
    check_rows(dense, "dense", (B, nd), dev)
    check(dense_w, "dense_w", torch.float32, dev, (nd,))
    if not (len(ids) == len(offsets) == len(sizes) == F):
        raise ValueError(f"v has {F} fields; {len(ids)} id columns, {len(offsets)} offsets, {len(sizes)} sizes")
    for c, (i, off, size) in enumerate(zip(ids, offsets, sizes)):
        check(i, f"ids[{c}]", torch.int32, dev, (B,))
        if off < 0 or size < 0 or off + size > num_rows:
            raise ValueError(f"column {c}: entries [{off}, {off + size}) outside the linear weights' {num_rows}")
    return B, F, D, nd


def _check_kernel_limits(F: int, D: int) -> None:
    if F < 1 or D < 1:
        raise ValueError(f"the FM kernels take F, D >= 1, got {F}, {D}")


def _column_table(ids, offsets, sizes, device) -> Optional[torch.Tensor]:
    """Past LAUNCH_COLUMNS fields the kernels read the columns' id pointers,
    offsets and sizes from an int64 [3, F] table on the card (None below:
    they travel by value in the launch)."""
    if len(ids) <= LAUNCH_COLUMNS:
        return None
    rows = [[v.data_ptr() for v in ids], [int(o) for o in offsets], [int(s) for s in sizes]]
    return torch.tensor(rows, dtype=torch.int64).to(device)


def fm_fwd(v: torch.Tensor, dense: torch.Tensor, ids: Sequence[torch.Tensor], offsets: Sequence[int],
           sizes: Sequence[int], linear: torch.Tensor, dense_w: torch.Tensor) -> torch.Tensor:
    """The FM output float32 [B] (first- and second-order terms)."""
    if linear.dim() != 1:
        raise ValueError(f"linear must be [sum V], got shape {tuple(linear.shape)}")
    check(linear, "linear", torch.float32, v.device)
    B, F, D, nd = _check_inputs(v, dense, ids, offsets, sizes, linear.shape[0], dense_w)
    if not use_kernel(v):
        return fm_fwd_plain(v, dense, ids, offsets, sizes, linear, dense_w)
    _check_kernel_limits(F, D)
    out = torch.empty(B, dtype=torch.float32, device=v.device)
    if B == 0:
        return out
    fn = library("fm").nvt_fm_fwd
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    c_ids, c_offs, c_sizes = c_columns(ids, offsets, sizes)
    table = _column_table(ids, offsets, sizes, v.device)
    rc = fn(c_ids, c_offs, c_sizes, ptr(table), F, D, ptr(v), v.stride(0), ptr(dense), dense.stride(0), nd,
            ptr(linear), ptr(dense_w), B, ptr(out), stream_ptr(v.device))
    raise_on_error(rc, "fm_fwd")
    LAUNCHES["fm_fwd"] += 1
    return out


def fm_bwd(v: torch.Tensor, dense: torch.Tensor, ids: Sequence[torch.Tensor], offsets: Sequence[int],
           sizes: Sequence[int], dense_w: torch.Tensor, g: torch.Tensor, num_rows: int,
           dv_out: Optional[torch.Tensor] = None, ddense_out: Optional[torch.Tensor] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``fm_fwd`` for the output gradient ``g`` [B]:
    (dv [B, F, D], ddense [B, nd], dlinear [num_rows], ddense_w [nd]).
    ``dv_out`` and ``ddense_out`` may be strided views of a wider gradient
    buffer; each is allocated when not given."""
    B, F, D, nd = _check_inputs(v, dense, ids, offsets, sizes, num_rows, dense_w)
    dev = v.device
    check(g, "g", torch.float32, dev, (B,))
    if dv_out is None:
        dv_out = torch.empty((B, F, D), dtype=torch.float32, device=dev)
    check_view(dv_out, "dv_out", (B, F, D), dev)
    if ddense_out is None:
        ddense_out = torch.empty((B, nd), dtype=torch.float32, device=dev)
    check_rows(ddense_out, "ddense_out", (B, nd), dev)
    if not use_kernel(v):
        dv, ddense, dlinear, ddense_w = fm_bwd_plain(v, dense, ids, offsets, sizes, dense_w, g, num_rows)
        dv_out.copy_(dv)
        ddense_out.copy_(ddense)
        return dv_out, ddense_out, dlinear, ddense_w
    _check_kernel_limits(F, D)
    dlinear = torch.empty(num_rows, dtype=torch.float32, device=dev)  # zeroed by the C entry
    ddense_w = torch.empty(nd, dtype=torch.float32, device=dev)
    fn = library("fm").nvt_fm_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    c_ids, c_offs, c_sizes = c_columns(ids, offsets, sizes)
    table = _column_table(ids, offsets, sizes, dev)
    rc = fn(c_ids, c_offs, c_sizes, ptr(table), F, D, ptr(v), v.stride(0), ptr(dense), dense.stride(0), nd, ptr(dense_w),
            ptr(g), B, ptr(dv_out), dv_out.stride(0), ptr(ddense_out), ddense_out.stride(0), ptr(dlinear),
            num_rows, ptr(ddense_w), stream_ptr(dev))
    raise_on_error(rc, "fm_bwd")
    LAUNCHES["fm_bwd"] += int(B > 0)
    return dv_out, ddense_out, dlinear, ddense_w


def fm_fwd_plain(v, dense, ids, offsets, sizes, linear, dense_w) -> torch.Tensor:
    """The same function in plain PyTorch operations (autograd runs through
    them)."""
    rows, valid = table_rows(ids, offsets, sizes)
    lin = torch.where(valid, linear[rows], float("nan")).sum(dim=1)
    s = v.sum(dim=1)
    fm2 = 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=1)
    return (lin + dense @ dense_w) + fm2


def fm_bwd_plain(v, dense, ids, offsets, sizes, dense_w, g, num_rows):
    dv = g[:, None, None] * (v.sum(dim=1, keepdim=True) - v)
    ddense = g[:, None] * dense_w
    rows, valid = table_rows(ids, offsets, sizes)
    terms = g[:, None].expand(rows.shape)
    dlinear = torch.zeros(num_rows, dtype=torch.float32, device=v.device).index_add_(0, rows[valid], terms[valid])
    return dv, ddense, dlinear, g @ dense


class FMTerms(torch.autograd.Function):
    """The FM output [B] of a [B, F*D + nd] feature row ``x`` (the gathered
    fields, then the dense features: DeepFM's deep input). The backward
    writes the row's whole gradient, both blocks, into one [B, F*D + nd]
    tensor, and hands ``linear`` and ``dense_w`` theirs."""

    @staticmethod
    def forward(ctx, x, linear, dense_w, offsets, sizes, D, *ids):
        FD = len(ids) * D
        v, dense = x[:, :FD].unflatten(1, (len(ids), D)), x[:, FD:]
        out = fm_fwd(v, dense, ids, offsets, sizes, linear, dense_w)
        ctx.save_for_backward(x, dense_w, *ids)
        ctx.meta = (offsets, sizes, D, linear.shape[0])
        return out

    @staticmethod
    def backward(ctx, g):
        x, dense_w, *ids = ctx.saved_tensors
        offsets, sizes, D, num_rows = ctx.meta
        FD = len(ids) * D
        dx = torch.empty_like(x, memory_format=torch.contiguous_format)
        _, _, dlinear, ddense_w = fm_bwd(
            x[:, :FD].unflatten(1, (len(ids), D)), x[:, FD:], ids, offsets, sizes, dense_w, g.contiguous(),
            num_rows, dv_out=dx[:, :FD].unflatten(1, (len(ids), D)), ddense_out=dx[:, FD:],
        )
        return (dx, dlinear, ddense_w, None, None, None) + (None,) * len(ids)


def fm_terms(x: torch.Tensor, linear: torch.Tensor, dense_w: torch.Tensor, ids: Sequence[torch.Tensor],
             offsets: Sequence[int], sizes: Sequence[int], D: int) -> torch.Tensor:
    return FMTerms.apply(x, linear, dense_w, tuple(offsets), tuple(sizes), D, *ids)
