"""The exchange sort of the sharded vocabulary count: CUDA kernel K15a,
wrappers and plain versions.

``exchange_route(keys, ndev, cap)`` is the routing half of the per-device
body of ``nvtabular_tpu/parallel/sharded_vocab.py:98-115``: int32 keys →
the [ndev, cap] send buffer of the all_to_all and the count of keys that
overflowed it. ``radix_sort(keys)`` is its ``jnp.sort`` of the received
keys (:118). The kernels are ``csrc/exchange.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library
from .hash import fmix32_plain

PAD = int(np.iinfo(np.int32).max)  # sharded_vocab.py:31: routed to owner 0, never sent, sorts last
TILE = 1024  # keys a warp counts (csrc/exchange.cu kTile)
MAX_OWNERS = 1024  # counts of kWarps tiles in 48 KB of shared memory
RADIX_BUCKETS = 256

_P = ctypes.c_void_p
_ARGTYPES = {
    # keys, n, ndev, cap, hist, totals, send, overflow, stream
    "nvt_exchange_route": [_P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, _P, _P, _P, _P, _P],
    # keys, n, tmp, out, hist, totals, stream
    "nvt_radix_sort_i32": [_P, ctypes.c_int64, _P, _P, _P, _P, _P],
}


def _fn(name: str):
    fn = getattr(library("exchange"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_keys(keys: torch.Tensor) -> int:
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-d, got shape {tuple(keys.shape)}")
    check(keys, "keys", torch.int32, keys.device)
    if keys.shape[0] >= 2**31:
        raise ValueError(f"{keys.shape[0]} keys exceed the exchange kernels' int32 counts")
    return keys.shape[0]


def _tiles(n: int) -> int:
    return -(-n // TILE)


def exchange_route(keys: torch.Tensor, ndev: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 keys [n] → (send int32 [ndev, cap], overflow int32 [1]). A key
    goes to its owner ``_mix32(key) % ndev`` at its stable rank among the
    earlier keys of that owner; a key at rank >= cap is dropped and counted
    in ``overflow``; a ``PAD`` key belongs to owner 0 (it takes a rank
    there) and is never sent; empty slots hold ``PAD``."""
    n = _check_keys(keys)
    if not 1 <= ndev <= MAX_OWNERS:
        raise ValueError(f"ndev must be in [1, {MAX_OWNERS}], got {ndev}")
    if cap < 1 or cap >= 2**31:
        raise ValueError(f"cap must be in [1, 2**31), got {cap}")
    if not use_kernel(keys):
        return exchange_route_plain(keys, ndev, cap)
    dev = keys.device
    send = torch.empty((ndev, cap), dtype=torch.int32, device=dev)
    overflow = torch.empty(1, dtype=torch.int32, device=dev)
    hist = torch.empty(max(ndev * _tiles(n), 1), dtype=torch.int32, device=dev)
    totals = torch.empty(ndev, dtype=torch.int32, device=dev)
    rc = _fn("nvt_exchange_route")(ptr(keys), n, ndev, cap, ptr(hist), ptr(totals), ptr(send), ptr(overflow),
                                   stream_ptr(dev))
    raise_on_error(rc, "exchange_route")
    LAUNCHES["exchange_route"] += 1
    return send, overflow


def radix_sort(keys: torch.Tensor) -> torch.Tensor:
    """int32 keys [n] → the same keys ascending, by an LSD radix sort of 4
    passes of 8 bits over the keys with their sign bit flipped."""
    n = _check_keys(keys)
    if not use_kernel(keys):
        return radix_sort_plain(keys)
    dev = keys.device
    out = torch.empty_like(keys)
    if n == 0:
        return out
    tmp = torch.empty_like(keys)
    hist = torch.empty(RADIX_BUCKETS * _tiles(n), dtype=torch.int32, device=dev)
    totals = torch.empty(RADIX_BUCKETS, dtype=torch.int32, device=dev)
    rc = _fn("nvt_radix_sort_i32")(ptr(keys), n, ptr(tmp), ptr(out), ptr(hist), ptr(totals), stream_ptr(dev))
    raise_on_error(rc, "radix_sort")
    LAUNCHES["radix_sort"] += 1
    return out


# --- plain versions -------------------------------------------------------------
def mix32_plain(keys: torch.Tensor, ndev: int) -> torch.Tensor:
    """``_mix32`` (sharded_vocab.py:33-42): the murmur3 finalizer of each
    int32 key's uint32 bits, modulo ndev, as int64."""
    return fmix32_plain(keys.long() & 0xFFFFFFFF) % ndev


def owners_plain(keys: torch.Tensor, ndev: int) -> torch.Tensor:
    """int64 owner of each key: ``_mix32(key) % ndev``, PAD → 0."""
    return torch.where(keys == PAD, 0, mix32_plain(keys, ndev))


def stable_ranks_plain(buckets: torch.Tensor) -> torch.Tensor:
    """Each entry's count of earlier entries with the same bucket."""
    n = buckets.shape[0]
    order = torch.argsort(buckets, stable=True)
    sorted_b = buckets[order]
    first = torch.ones(n, dtype=torch.bool, device=buckets.device)
    first[1:] = sorted_b[1:] != sorted_b[:-1]
    pos = torch.arange(n, device=buckets.device)
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    ranks = torch.empty(n, dtype=torch.int64, device=buckets.device)
    ranks[order] = pos - start
    return ranks


def exchange_route_plain(keys: torch.Tensor, ndev: int, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    owner = owners_plain(keys, ndev)
    rank = stable_ranks_plain(owner)
    is_pad = keys == PAD
    sent = ~is_pad & (rank < cap)
    send = torch.full((ndev, cap), PAD, dtype=torch.int32, device=keys.device)
    send[owner[sent], rank[sent]] = keys[sent]
    overflow = (~is_pad & (rank >= cap)).sum().to(torch.int32).reshape(1)
    return send, overflow


def radix_sort_plain(keys: torch.Tensor) -> torch.Tensor:
    """The kernel's four stable passes over 8-bit digits."""
    u = (keys.long() ^ 0x80000000) & 0xFFFFFFFF
    out = keys
    for shift in (0, 8, 16, 24):
        order = torch.argsort((u >> shift) & 0xFF, stable=True)
        u, out = u[order], out[order]
    return out
