"""Ragged (values, offsets) columns: CUDA kernels K11a-c, their wrappers
and plain versions.

A list column is flat ``values`` [T] and int64 ``offsets`` [R + 1]; row
``r`` holds ``values[offsets[r]:offsets[r + 1]]``.

* ``ragged_to_padded(values, offsets, L)`` → (padded [R, L], mask float32
  [R, L]): the counterpart of ``nvtabular_tpu/kernels/ragged.py:22-32`` as
  DeviceLoader uses it (the mask cast to float32 there). Rows longer than
  ``L`` are cut off.
* ``ragged_slice_padded(values, offsets, start, end, pad_len)`` → (padded
  [R, pad_len], new_len int64 [R]): the python slice ``[start:end]`` of each
  row (negative bounds count from the row's end), ``ragged.py:35-48``.

Both launch the one padding kernel of ``csrc/ragged.cu``
(``ragged_to_padded`` is the slice ``[0, L)``) and count their launches
apart.

* ``ragged_segment_reduce(values, offsets, num_rows, combiner)`` → float32
  [num_rows]: the sum, mean, min or max of each row of a float32 column,
  ``ragged.py:51-70`` (K11c), with its edge cases: a value belongs to the
  row counted by the offsets[1:] at or below its position, rows from
  ``num_rows`` on are dropped, an empty row gives 0, +inf or -inf, NaN
  propagates through min and max, and a mean needs ``num_rows == R``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]
_UINT = {4: np.uint32, 8: np.uint64}
COMBINERS = {"sum": 0, "mean": 1, "min": 2, "max": 3}
# values, T, offsets, R, num_rows, combiner, tiles, scratch, out, stream
_REDUCE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
SEG_THREADS, SEG_ITEMS = 256, 15  # csrc/ragged.cu kSegThreads, kSegItems: a tile's threads and a thread's items
SEG_TILE = SEG_THREADS * SEG_ITEMS  # merge-path items (values and row ends) a tile
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1


def _check(values: torch.Tensor, offsets: torch.Tensor, pad_len: int) -> int:
    """Validates a list column's tensors; returns its row count R."""
    if values.dim() != 1 or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"values must be [T] and offsets [R + 1], got {tuple(values.shape)}, {tuple(offsets.shape)}")
    check(values, "values", values.dtype, values.device)
    if values.element_size() not in _UINT:
        raise TypeError(f"the ragged kernel moves 4- or 8-byte values, got {values.dtype}")
    check(offsets, "offsets", torch.int64, values.device)
    if pad_len < 0:
        raise ValueError(f"pad_len must be >= 0, got {pad_len}")
    return offsets.shape[0] - 1


def _pad_bits(pad_value, dtype: torch.dtype) -> int:
    """The bits of ``pad_value`` cast to ``dtype``, as the kernel moves words."""
    value = torch.tensor(pad_value).to(dtype).numpy()
    return int(value.view(_UINT[value.itemsize]))


def _launch(name, values, offsets, rows, L, start, end, pad_value, out, mask, new_len) -> None:
    if rows * L >= 2**38:
        raise ValueError(f"[{rows}, {L}] exceeds the ragged kernel's grid")
    if rows == 0 or L == 0:
        return
    fn = library("ragged").nvt_ragged_pad
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(values), values.shape[0], values.element_size(), ptr(offsets), rows, L, start, end,
            _pad_bits(pad_value, values.dtype), ptr(out), ptr(mask), ptr(new_len), stream_ptr(values.device))
    raise_on_error(rc, name)
    LAUNCHES[name] += 1


def ragged_to_padded(values: torch.Tensor, offsets: torch.Tensor, pad_len: int,
                     pad_value=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [T], offsets [R + 1]) → (padded [R, pad_len] of values' dtype,
    mask float32 [R, pad_len]: 1 where the slot holds a value)."""
    rows = _check(values, offsets, pad_len)
    if not use_kernel(values):
        return ragged_to_padded_plain(values, offsets, pad_len, pad_value)
    out = torch.empty((rows, pad_len), dtype=values.dtype, device=values.device)
    mask = torch.empty((rows, pad_len), dtype=torch.float32, device=values.device)
    _launch("ragged_to_padded", values, offsets, rows, pad_len, 0, pad_len, pad_value, out, mask, None)
    return out, mask


def ragged_slice_padded(values: torch.Tensor, offsets: torch.Tensor, start: int, end: int, pad_len: int,
                        pad_value=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's slice ``[start:end]`` → (padded [R, pad_len] of values'
    dtype, new_len int64 [R]: the slice's length, at most pad_len)."""
    rows = _check(values, offsets, pad_len)
    if not use_kernel(values):
        return ragged_slice_padded_plain(values, offsets, start, end, pad_len, pad_value)
    out = torch.empty((rows, pad_len), dtype=values.dtype, device=values.device)
    new_len = torch.empty(rows, dtype=torch.int64, device=values.device)
    _launch("ragged_slice_padded", values, offsets, rows, pad_len, int(start), int(end), pad_value, out, None,
            new_len)
    return out, new_len


def _gather_padded(values, offsets, s, new_len, pad_len, pad_value):
    pos = torch.arange(pad_len, device=values.device)
    valid = pos[None, :] < new_len[:, None]
    idx = (offsets[:-1, None] + s[:, None] + pos[None, :]).clamp(0, max(values.shape[0] - 1, 0))
    if values.shape[0]:
        gathered = values[idx]
    else:
        gathered = torch.zeros(idx.shape, dtype=values.dtype, device=values.device)
    pad = torch.tensor(pad_value, device=values.device).to(values.dtype)
    return torch.where(valid, gathered, pad), valid


def ragged_to_padded_plain(values, offsets, pad_len, pad_value=0):
    lengths = offsets[1:] - offsets[:-1]
    padded, valid = _gather_padded(values, offsets, torch.zeros_like(lengths), lengths, pad_len, pad_value)
    return padded, valid.to(torch.float32)


def ragged_slice_padded_plain(values, offsets, start, end, pad_len, pad_value=0):
    n = offsets[1:] - offsets[:-1]
    s = n.clamp(max=start) if start >= 0 else (n + start).clamp(min=0)
    e = torch.maximum(n.clamp(max=end) if end > 0 else n + end, s)
    new_len = (e - s).clamp(max=pad_len)
    padded, _ = _gather_padded(values, offsets, s, new_len, pad_len, pad_value)
    return padded, new_len


def _check_reduce(values: torch.Tensor, offsets: torch.Tensor, num_rows: int, combiner: str) -> int:
    """Validates K11c's arguments; returns the offsets' row count R."""
    if values.dim() != 1 or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"values must be [T] and offsets [R + 1], got {tuple(values.shape)}, {tuple(offsets.shape)}")
    check(values, "values", torch.float32, values.device)
    check(offsets, "offsets", torch.int64, values.device)
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if num_rows < 0:
        raise ValueError(f"num_rows must be >= 0, got {num_rows}")
    rows = offsets.shape[0] - 1
    if combiner == "mean" and num_rows != rows:
        # the reference divides [num_rows] sums by [R] lengths: a shape error
        raise ValueError(f"a mean needs num_rows == len(offsets) - 1 ({rows}), got {num_rows}")
    return rows


def segment_plan(T: int, rows: int, num_rows: int) -> Tuple[int, int]:
    """(tiles, scratch int64s) of K11c: the merge path of the row ends of
    rows [0, min(num_rows, rows)) and the T values, in tiles of SEG_TILE
    items; the scratch holds each tile boundary's row count (tiles + 1),
    then each tile's head and tail carries (4 bytes each: tiles int64s)."""
    tiles = -(-(min(num_rows, rows) + T) // SEG_TILE)
    return tiles, 2 * tiles + 1


def ragged_segment_reduce(values: torch.Tensor, offsets: torch.Tensor, num_rows: int,
                          combiner: str = "sum") -> torch.Tensor:
    """Per-row ``combiner`` of a ragged float32 column → float32 [num_rows]."""
    rows = _check_reduce(values, offsets, num_rows, combiner)
    if not use_kernel(values):
        return ragged_segment_reduce_plain(values, offsets, num_rows, combiner)
    out = torch.empty(num_rows, dtype=torch.float32, device=values.device)
    if num_rows == 0:
        return out
    tiles, words = segment_plan(values.shape[0], rows, num_rows)
    if tiles >= 2**31:
        raise ValueError(f"{values.shape[0]} values pass K11c's grid of {2**31 - 1} tiles")
    scratch = torch.empty(words, dtype=torch.int64, device=values.device)
    fn = library("ragged").nvt_ragged_segment_reduce
    if fn.argtypes is None:
        fn.argtypes = _REDUCE_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(values), values.shape[0], ptr(offsets), rows, num_rows, COMBINERS[combiner], tiles, ptr(scratch),
            ptr(out), stream_ptr(values.device))
    raise_on_error(rc, "ragged_segment_reduce")
    LAUNCHES["ragged_segment_reduce"] += 1
    return out


def _ordered_keys(values: torch.Tensor, nan_key: int) -> torch.Tensor:
    """int64 keys whose order is the float32 values' order (-0.0 below 0.0),
    NaN given ``nan_key``: the kernel's min / max keys."""
    b = values.contiguous().view(torch.int32).to(torch.int64)
    keys = b ^ ((b >> 31) & 0x7FFFFFFF)
    return torch.where(torch.isnan(values), nan_key, keys)


def _float_of_keys(keys: torch.Tensor) -> torch.Tensor:
    bits = (keys ^ ((keys >> 31) & 0x7FFFFFFF)).to(torch.int32).view(torch.float32)
    return torch.where((keys == _INT32_MIN) | (keys == _INT32_MAX), float("nan"), bits)


def ragged_segment_reduce_plain(values, offsets, num_rows, combiner="sum") -> torch.Tensor:
    rows = offsets.shape[0] - 1
    dev = values.device
    row = torch.searchsorted(offsets[1:], torch.arange(values.shape[0], device=dev), right=True)
    keep = row < num_rows
    row, vals = row[keep], values[keep]
    if combiner in ("sum", "mean"):
        # float64 sums, rounded once: a float32 index_add_ on the card adds in
        # its atomics' order, and over a row of millions of values its
        # roundings drift past the kernel's own error
        out = torch.zeros(num_rows, dtype=torch.float64, device=dev).index_add_(0, row, vals.double())
        if combiner == "mean":
            out = out / (offsets[1:] - offsets[:-1]).clamp(min=1).to(torch.float64)
        return out.float()
    lo = combiner == "min"
    identity = _ordered_keys(torch.tensor([float("inf") if lo else float("-inf")], device=dev), 0)
    keys = torch.full((num_rows,), int(identity), dtype=torch.int64, device=dev)
    keys.scatter_reduce_(0, row, _ordered_keys(vals, _INT32_MIN if lo else _INT32_MAX), "amin" if lo else "amax")
    return _float_of_keys(keys)
