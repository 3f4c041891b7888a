"""Distributed value counts: the sharded vocabulary build.

Counterpart of ``nvtabular_tpu/parallel/sharded_vocab.py:33-320``. Each rank
of the mesh's ``data`` axis holds a shard of a column's int32 keys:

1. kernel K15a routes its keys to their owner ranks (``_mix32(key) %
   ndev``) into a fixed-capacity [ndev, cap] send buffer, counting the keys
   that overflow it (``kernels.exchange.exchange_route``);
2. one ``all_to_all_single`` delivers every key to its owner;
3. K15a sorts the keys each owner received (``kernels.exchange.radix_sort``);
4. the host run-length-encodes the owner's sorted keys. Owners hold
   disjoint key sets, so the global table is the owners' tables side by
   side, in rank order.

Rank ``r`` does what device ``r`` of the JAX mesh does: given the shard
that the reference's padding and split give device ``r``, its sorted shard
is device ``r``'s, bit for bit. Counts are exact; an overflow is reported
(and retried with twice the capacity by the ``_arrays`` and ``_exact``
forms), never dropped silently.

The multi-process reduction of partial (key → count) tables
(``exchange_partial_counts``) rides ``exchange_keyed_rows``: per-destination
lengths are gathered first, so its capacity is exact.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels.exchange import PAD, exchange_route, mix32_plain, radix_sort
from .mesh import all_gather, all_reduce, all_to_all, comm_device, mesh_device
from .multihost import allgather_pyobj, process_count, process_index

_PAD = np.int32(PAD)  # sorts last
_mix32 = mix32_plain

UNSUPPORTED_STRINGS = (
    "exchange_partial_string_counts: string vocabularies are not ported yet "
    "(ROADMAP.md queue 1 item 4: strings and hybrid execution)"
)


def _as_keys(keys, device: torch.device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int32)).to(device)


def _exchange_sort_pass(keys, mesh, axis: str = "data", capacity_factor: float = 2.5):
    """This rank's part of the SPMD exchange: its keys routed over the
    ``axis`` group's ranks through ONE all_to_all, the keys it owns sorted.
    A rank with fewer keys than the longest shard pads with ``_PAD``.
    Returns (this rank's sorted received keys [ndev * cap] on its device,
    shard length ndev * cap, ndev, the overflow summed over the ranks)."""
    group = mesh.get_group(axis)
    ndev = group.size()
    local = _as_keys(keys, keys.device if isinstance(keys, torch.Tensor) else mesh_device(mesh))
    longest = torch.tensor([local.shape[0]], dtype=torch.int64, device=comm_device(group))
    per_dev = int(all_reduce(longest, group, torch.distributed.ReduceOp.MAX).item())
    if local.shape[0] < per_dev:
        local = torch.cat([local, torch.full((per_dev - local.shape[0],), PAD, dtype=torch.int32, device=local.device)])
    cap = max(int(np.ceil(per_dev * capacity_factor / ndev)), 8)
    send, overflow = exchange_route(local, ndev, cap)
    recv = all_to_all(send.reshape(-1), group)
    sorted_keys = radix_sort(recv)
    total_overflow = int(all_reduce(overflow.to(torch.int64), group).item())
    return sorted_keys, ndev * cap, ndev, total_overflow


def _run_length(sorted_arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    boundaries = np.empty(len(sorted_arr), dtype=bool)
    boundaries[0] = True
    boundaries[1:] = sorted_arr[1:] != sorted_arr[:-1]
    starts = np.nonzero(boundaries)[0]
    vals = sorted_arr[starts]
    ends = np.append(starts[1:], len(sorted_arr))
    return vals, ends - starts


def _owned_counts(sorted_keys: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """(values, counts) int64 of an owner's sorted shard: pads dropped on
    the host (they sort last), then one run-length encode."""
    flat = sorted_keys.cpu().numpy()
    flat = flat[flat != _PAD]
    if len(flat) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    vals, cnts = _run_length(flat)
    return vals.astype(np.int64), cnts.astype(np.int64)


def sharded_value_counts(
    keys, mesh, axis: str = "data", capacity_factor: float = 2.5
) -> Tuple[Dict[int, int], int]:
    """Exact global (key → count) of every rank's int32 ``keys`` via the
    mesh all_to_all; each rank gets the whole dict. Returns (counts,
    overflow): overflow > 0 means a send capacity was exceeded (badly skewed
    hashing) and those keys are missing; retry with a larger
    ``capacity_factor``."""
    flat, _shard_len, _ndev, overflow = _exchange_sort_pass(keys, mesh, axis, capacity_factor)
    counts: Dict[int, int] = {}
    for vals, cnts in allgather_pyobj(_owned_counts(flat), group=mesh.get_group(axis)):
        counts.update(zip(vals.tolist(), cnts.tolist()))
    return counts, overflow


def owned_value_counts(
    keys, mesh, axis: str = "data", capacity_factor: float = 2.5, max_retries: int = 6
) -> Tuple[np.ndarray, np.ndarray]:
    """(values ascending, counts) int64 of the keys this rank owns, with the
    overflow retry: each retry doubles the capacity factor, on every rank at
    once (the overflow is summed over them). Owners' key sets are disjoint."""
    factor = capacity_factor
    for _ in range(max_retries):
        flat, _shard_len, _ndev, overflow = _exchange_sort_pass(keys, mesh, axis, factor)
        if overflow == 0:
            return _owned_counts(flat)
        factor *= 2
    raise RuntimeError(f"sharded_value_counts still overflowing at capacity_factor={factor}")


def sharded_value_counts_arrays(
    keys, mesh, axis: str = "data", capacity_factor: float = 2.5, max_retries: int = 6
) -> Tuple[np.ndarray, np.ndarray]:
    """`sharded_value_counts` as (values, counts) int64 arrays with the
    overflow retry: the owners' tables concatenated in rank order (each
    ascending), on every rank, as the reference's flat pass gives them."""
    shards = allgather_pyobj(
        owned_value_counts(keys, mesh, axis, capacity_factor, max_retries), group=mesh.get_group(axis)
    )
    return np.concatenate([s[0] for s in shards]), np.concatenate([s[1] for s in shards])


def sharded_value_counts_exact(
    keys, mesh, axis: str = "data", capacity_factor: float = 2.5, max_retries: int = 6
) -> Dict[int, int]:
    """`sharded_value_counts` with the overflow retry (a power-law column can
    overflow its owner's capacity; the factor doubles until it fits)."""
    factor = capacity_factor
    for _ in range(max_retries):
        counts, overflow = sharded_value_counts(keys, mesh, axis, factor)
        if overflow == 0:
            return counts
        factor *= 2
    raise RuntimeError(f"sharded_value_counts still overflowing at capacity_factor={factor}")


# --- the exact-capacity multi-process exchange ---------------------------------------
def _owner_of_int64(keys: np.ndarray, nproc: int) -> np.ndarray:
    """Deterministic owner process of each int64 key (a 64-bit finalizer of
    the same family as ``_mix32``), the reference's :180-187."""
    h = keys.astype(np.uint64)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    return (h % np.uint64(nproc)).astype(np.int64)


def exchange_keyed_rows(lanes: np.ndarray, owner: np.ndarray) -> np.ndarray:
    """Row ``i`` of ``lanes`` (int32 [n, L]) goes to process ``owner[i]``;
    returns the rows this process received, [m, L], grouped by source rank.
    Every process of the default group takes part. The per-(source,
    destination) lengths are gathered first, so the one all_to_all has exact
    splits and a skewed owner distribution cannot overflow."""
    nproc = process_count()
    lanes = np.ascontiguousarray(lanes, dtype=np.int32)
    if lanes.ndim != 2:
        raise ValueError("lanes must be [n, L]")
    if nproc == 1:
        return lanes
    rank = process_index()
    owner = np.asarray(owner, dtype=np.int64)
    order = np.argsort(owner, kind="stable")
    bounds = np.searchsorted(owner[order], np.arange(nproc + 1))
    send_lens = torch.from_numpy((bounds[1:] - bounds[:-1]).astype(np.int64))
    all_lens = all_gather(send_lens).numpy()  # [src, dst]
    recv = all_to_all(
        torch.from_numpy(np.ascontiguousarray(lanes[order])),
        out_splits=all_lens[:, rank].tolist(),
        in_splits=all_lens[rank].tolist(),
    )
    return recv.numpy()


def pack_i64_lanes(arr: np.ndarray) -> np.ndarray:
    """int64/float64 [n] -> int32 [n, 2] lanes (bit-preserving)."""
    return np.ascontiguousarray(arr).view(np.int32).reshape(-1, 2)


def unpack_i64_lanes(lanes: np.ndarray, dtype) -> np.ndarray:
    """int32 [n, 2] lanes -> [n] of int64/float64 (bit-preserving)."""
    return np.ascontiguousarray(lanes).view(np.dtype(dtype)).reshape(-1)


def exchange_partial_counts(keys: np.ndarray, counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact multi-process reduction of per-process partial (int64 key →
    count) tables through one all_to_all: each process passes its local
    unique keys and their partial counts, each pair goes to its key's owner,
    and owners sum what they receive. Returns this process's owned merged
    shard (keys ascending, counts); the shards are disjoint."""
    keys = np.asarray(keys, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    nproc = process_count()
    if nproc == 1:
        return keys, counts
    lanes = np.hstack([pack_i64_lanes(keys), pack_i64_lanes(counts)])
    recv = exchange_keyed_rows(lanes, _owner_of_int64(keys, nproc))
    if len(recv) == 0:
        return np.array([], dtype=np.int64), np.array([], dtype=np.int64)
    all_k = unpack_i64_lanes(recv[:, :2], np.int64)
    all_c = unpack_i64_lanes(recv[:, 2:], np.int64)
    order = np.argsort(all_k, kind="stable")
    sk, sc = all_k[order], all_c[order]
    starts = np.empty(len(sk), dtype=bool)
    starts[0] = True
    starts[1:] = sk[1:] != sk[:-1]
    idx = np.nonzero(starts)[0]
    return sk[idx], np.add.reduceat(sc, idx)


def exchange_partial_string_counts(values, counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    raise NotImplementedError(UNSUPPORTED_STRINGS)

