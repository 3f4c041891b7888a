"""The training step's Adagrad update: CUDA kernel K18, its wrapper, host
plan and plain version.

``nvtabular_tpu/models/training.py:25-26, 69-70`` and
``nvtabular_tpu/parallel/train.py:55-56`` run optax.adagrad's update
(``scale_by_rss``, the learning rate, ``apply_updates``) inside ``jax.jit``,
which XLA fuses into one elementwise pass a parameter. ``adagrad_update``
is that pass over every tensor of the optimizer at once
(``csrc/adagrad.cu``): one launch for up to MAX_SEGMENTS tensors, planned by
``adagrad_plan``. It reads the gradient in full and reads and writes a
parameter and its accumulator only where the gradient's bits are not all
zero, which leaves the result as it is.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import LAUNCHES, check, raise_on_error, stream_ptr, use_kernel
from .build import library

MAX_SEGMENTS = 64  # csrc/adagrad.cu kMaxSegments: the tensors of one launch
UNIT = 4  # floats a unit: the kernel's 16-byte vector
EPS = 1e-7  # optax.adagrad's eps, inside the square root

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_double, ctypes.c_void_p]


def adagrad_plan(lengths: Sequence[int]) -> List[Tuple[List[int], List[int]]]:
    """The launches of one update over tensors of ``lengths`` floats: for
    each, the indices of its tensors (the nonempty ones in order, at most
    MAX_SEGMENTS) and the flat prefix of their units of UNIT floats (one
    entry more than tensors, from 0)."""
    if any(n < 0 for n in lengths):
        raise ValueError(f"lengths must be >= 0, got {list(lengths)}")
    live = [i for i, n in enumerate(lengths) if n > 0]
    plan = []
    for i0 in range(0, len(live), MAX_SEGMENTS):
        idx = live[i0 : i0 + MAX_SEGMENTS]
        start = [0]
        for i in idx:
            start.append(start[-1] + -(-lengths[i] // UNIT))
        plan.append((idx, start))
    return plan


def adagrad_update(params: Sequence[torch.Tensor], accs: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                   lr: float) -> None:
    """optax.adagrad(lr)'s step, in place, for each parameter ``p``, its
    accumulator ``acc`` and gradient ``g`` (float32, contiguous, one shape,
    all on one device):

        acc = g * g + acc
        p = p + (-lr) * (g * (rsqrt(acc + EPS) where acc > 0 else 0))"""
    params, accs, grads = list(params), list(accs), list(grads)
    if not len(params) == len(accs) == len(grads):
        raise ValueError(f"{len(params)} params, {len(accs)} accumulators and {len(grads)} gradients")
    if not params:
        return
    dev = params[0].device
    for i, (p, a, g) in enumerate(zip(params, accs, grads)):
        check(p, f"params[{i}]", torch.float32, dev)
        check(a, f"accs[{i}]", torch.float32, dev, p.shape)
        check(g, f"grads[{i}]", torch.float32, dev, p.shape)
    if not use_kernel(params[0]):
        adagrad_update_plain(params, accs, grads, lr)
        return
    fn = library("adagrad").nvt_adagrad_update
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    stream = stream_ptr(dev)
    for idx, start in adagrad_plan([p.numel() for p in params]):
        k = len(idx)
        p_ptr, a_ptr, g_ptr = ((ctypes.c_void_p * k)(*[ts[i].data_ptr() for i in idx]) for ts in (params, accs, grads))
        lengths = (ctypes.c_int64 * k)(*[params[i].numel() for i in idx])
        rc = fn(p_ptr, a_ptr, g_ptr, lengths, (ctypes.c_uint64 * (k + 1))(*start), k, lr, stream)
        raise_on_error(rc, "adagrad_update")
        LAUNCHES["adagrad_update"] += 1
    # the kernel writes through pointers: tell autograd that p and acc changed, as the in-place ops would
    torch.autograd.graph.increment_version(params + accs)


def adagrad_update_plain(params: Sequence[torch.Tensor], accs: Sequence[torch.Tensor],
                         grads: Sequence[torch.Tensor], lr: float) -> None:
    for p, acc, g in zip(params, accs, grads):
        acc.addcmul_(g, g)
        scale = acc.add(EPS).rsqrt_()
        scale.masked_fill_(~(acc > 0), 0.0)
        p.add_(scale.mul_(g), alpha=-lr)
