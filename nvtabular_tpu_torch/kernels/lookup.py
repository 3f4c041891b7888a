"""Column-batched Categorify lookups: CUDA kernels K1-K3, K6 and K8 with the
K4 epilogue fused, their wrappers and their plain PyTorch versions.

K1-K3 and K6 take the stacked values of C integer columns as ``values`` [C, N]
int32; K8 (``sorted_lookup``) takes C float columns as float32 [C, N]. All
write final codes [C, N] int32:

* a hit gives the code stored in the table;
* a miss gives ``miss`` (default ``OOV_INDEX``, 2: Categorify's single
  out-of-vocabulary bucket); where the optional ``nbuckets`` [C] int32 gives
  column c more than one bucket, a miss gives ``2 + hash_array(v) % nb``
  instead (K4's hashed branch): the hash of an int32 key's bits and sign
  extension, or of a float32 key's bits, as on the reference's device path;
* a row whose ``validity`` is False gives ``null`` (default ``NULL_INDEX``, 1),
  and so does a NaN float;
* then the column's ``col_offsets`` entry (the single_table shift) is added.

A group index of TargetEncoding or JoinGroupby passes ``num_groups`` as both
``miss`` and ``null`` and zero offsets: misses and null keys read the pad
slot of the group's stat arrays.

``sel`` [C] int32 picks, for each value row, its row of the bin's tables
(columns sharing a joint vocabulary share a row). Kernels are in
``csrc/lookup.cu``; see there for what bounds each one on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check, ptr, raise_on_error, stream_ptr, use_kernel
from .build import library
from .hash import M32, fmix32_plain, hash_array_plain

NULL_INDEX = 1
OOV_INDEX = 2
TINY_MAX = 4096
FLT32_MIN = 1.17549435e-38  # the smallest normal float32
BUCKET_SLOTS = 4
SEEDS = (0, 0x9E3779B9)
STASH_SEEDS = (0x68E31DA4, 0xB5297A4D)  # the stash's two hashes (nvtabular_tpu/ops/lookup.py:41-42)

_P = ctypes.c_void_p
_ARGTYPES = {
    # values, validity, keys, codes, lens, sel, col_offsets, out, C, N, vmax, miss, null, nbuckets, stream
    "nvt_tiny_lookup": [_P] * 8 + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 3 + [_P, _P],
    # values, validity, table, mins, maxs, lens, table_offsets, sel, col_offsets, out, C, N, miss, null,
    # nbuckets, stream
    "nvt_direct_lookup": [_P] * 10 + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 2 + [_P, _P],
    # values, validity, table, nbs, row_offsets, sel, col_offsets, out, C, N, miss, null, nbuckets, stream
    "nvt_cuckoo_lookup": [_P] * 8 + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 2 + [_P, _P],
    # values, validity, keys, codes, starts, lens, sel, col_offsets, out, C, N, miss, null, nbuckets, stream
    "nvt_sorted_lookup": [_P] * 9 + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 2 + [_P, _P],
    # values, validity, table, nbps, row_offsets, stash, nbss, stash_offsets, sel, col_offsets, out, C, N, miss,
    # null, nbuckets, stream
    "nvt_stash_lookup": [_P] * 11 + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_int] * 2 + [_P, _P],
}


def _fn(name: str):
    fn = getattr(library("lookup"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_common(values, validity, sel, col_offsets, nbuckets, dtype=torch.int32):
    if values.dim() != 2:
        raise ValueError(f"values must be [C, N], got shape {tuple(values.shape)}")
    dev = values.device
    check(values, "values", dtype, dev)
    check(validity, "validity", torch.bool, dev, values.shape, optional=True)
    check(sel, "sel", torch.int32, dev, (values.shape[0],))
    check(col_offsets, "col_offsets", torch.int32, dev, (values.shape[0],))
    check(nbuckets, "nbuckets", torch.int32, dev, (values.shape[0],), optional=True)


def _epilogue(code, hit, validity, col_offsets, miss, null, values=None, nbuckets=None):
    """hit → code, miss → ``miss`` or the hashed bucket, invalid or NaN →
    ``null``, then the column offset: ``nvtabular_tpu/ops/categorify.py:
    628-634`` (``_oov_codes_dev``) and ``:1666-1684``."""
    if nbuckets is not None:
        nb = nbuckets.long()[:, None]
        hashed = OOV_INDEX + hash_array_plain(values) % nb.clamp(min=1)
        miss = torch.where(nb > 1, hashed, miss)
    out = torch.where(hit, code, miss)
    if validity is not None:
        out = torch.where(validity, out, null)
    if values is not None and values.is_floating_point():
        out = torch.where(torch.isnan(values), null, out)
    return (out + col_offsets[:, None]).to(torch.int32)


def _launch(name, values, args, miss, null, nbuckets, counter=None):
    """Allocate the output and launch ``nvt_<name>`` on the current stream;
    the launch counts under ``counter`` (default ``name``)."""
    C, N = values.shape
    out = torch.empty((C, N), dtype=torch.int32, device=values.device)
    if C == 0 or N == 0:
        return out
    fn = _fn(f"nvt_{name}")
    head, tail = args
    rc = fn(*[ptr(t) for t in head], ptr(out), C, N, *tail, miss, null, ptr(nbuckets), stream_ptr(values.device))
    raise_on_error(rc, name)
    LAUNCHES[counter or name] += 1
    return out


# --- K1 + K4: tiny vocabularies (≤ 4096 keys) --------------------------------
def tiny_lookup(values, validity, keys, codes, lens, sel, col_offsets, miss=OOV_INDEX, null=NULL_INDEX,
                nbuckets=None, counter=None):
    """Replaces ``BatchedTiny.encode_dev`` (nvtabular_tpu/ops/lookup.py:157)
    and, with one table row, ``TinyLookup.encode_dev`` (:119), K8's solo
    branch (``counter="tiny_lookup_solo"``).

    keys/codes [B, vmax] int32: row b holds its ``lens[b]`` keys sorted
    ascending, then padding; lens [B] int32."""
    _check_common(values, validity, sel, col_offsets, nbuckets)
    dev = values.device
    check(keys, "keys", torch.int32, dev)
    check(codes, "codes", torch.int32, dev, keys.shape)
    check(lens, "lens", torch.int32, dev, (keys.shape[0],))
    if keys.shape[1] > TINY_MAX:
        raise ValueError(f"tiny bin holds at most {TINY_MAX} keys per column, got {keys.shape[1]}")
    if not use_kernel(values):
        return tiny_lookup_plain(values, validity, keys, codes, lens, sel, col_offsets, miss, null, nbuckets)
    return _launch(
        "tiny_lookup",
        values,
        ([values, validity, keys, codes, lens, sel, col_offsets], [keys.shape[1]]),
        miss,
        null,
        nbuckets,
        counter,
    )


def tiny_lookup_plain(values, validity, keys, codes, lens, sel, col_offsets, miss=OOV_INDEX, null=NULL_INDEX,
                      nbuckets=None):
    s = sel.long()
    k, c, n = keys[s], codes[s], lens[s].long()
    # only [0, lens) of a row is sorted (the pad repeats the FIRST key):
    # repeat the row's LAST key instead, so the whole row is non-decreasing
    last = (n - 1).clamp(min=0)[:, None]
    j = torch.arange(k.shape[1], device=k.device)[None, :]
    k = torch.gather(k, 1, torch.minimum(j, last).expand(k.shape).contiguous())
    pos = torch.searchsorted(k, values)  # first slot with key >= value
    pos_c = torch.minimum(pos, last)
    hit = (pos < n[:, None]) & (torch.gather(k, 1, pos_c) == values)
    return _epilogue(torch.gather(c, 1, pos_c), hit, validity, col_offsets, miss, null, values, nbuckets)


# --- K2 + K4: direct (dense) map ----------------------------------------------
def direct_lookup(values, validity, table, mins, maxs, lens, table_offsets, sel, col_offsets,
                  miss=OOV_INDEX, null=NULL_INDEX, nbuckets=None, counter=None):
    """Replaces ``BatchedDirect.encode_dev`` (nvtabular_tpu/ops/lookup.py:585)
    and, with one table row, ``DirectLookup.encode_dev`` (:196), K8's solo
    branch (``counter="direct_lookup_solo"``).

    table [T] int32: the concat of the per-column dense tables, -1 = empty;
    row b spans ``table[table_offsets[b] : table_offsets[b] + lens[b]]`` and
    maps keys ``mins[b] .. maxs[b]``. mins/maxs int32, lens/table_offsets int64."""
    _check_common(values, validity, sel, col_offsets, nbuckets)
    dev = values.device
    B = mins.shape[0]
    check(table, "table", torch.int32, dev)
    check(mins, "mins", torch.int32, dev, (B,))
    check(maxs, "maxs", torch.int32, dev, (B,))
    check(lens, "lens", torch.int64, dev, (B,))
    check(table_offsets, "table_offsets", torch.int64, dev, (B,))
    if not use_kernel(values):
        return direct_lookup_plain(
            values, validity, table, mins, maxs, lens, table_offsets, sel, col_offsets, miss, null, nbuckets
        )
    return _launch(
        "direct_lookup",
        values,
        ([values, validity, table, mins, maxs, lens, table_offsets, sel, col_offsets], []),
        miss,
        null,
        nbuckets,
        counter,
    )


def direct_lookup_plain(values, validity, table, mins, maxs, lens, table_offsets, sel, col_offsets,
                        miss=OOV_INDEX, null=NULL_INDEX, nbuckets=None):
    s = sel.long()
    v = values.long()  # v - min overflows int32 for keys far from min
    mn, mx = mins[s].long()[:, None], maxs[s].long()[:, None]
    idx = torch.minimum((v - mn).clamp(min=0), lens[s][:, None] - 1) + table_offsets[s][:, None]
    code = table[idx]
    hit = (v >= mn) & (v <= mx) & (code >= 0)
    return _epilogue(code, hit, validity, col_offsets, miss, null, values, nbuckets)


# --- K3 + K4: two-choice 4-slot bucketed cuckoo --------------------------------
def cuckoo_lookup(values, validity, table, nbs, row_offsets, sel, col_offsets, miss=OOV_INDEX, null=NULL_INDEX,
                  nbuckets=None, counter=None):
    """Replaces ``BatchedCuckoo.encode_dev`` (nvtabular_tpu/ops/lookup.py:693)
    and, with one table row, ``CuckooLookup.encode_dev`` (:261), K8's solo
    branch (``counter="cuckoo_lookup_solo"``).

    table [R, 8] int32: bucket rows ``[k0..k3, v0..v3]`` (v = -1: empty);
    column row b owns rows ``row_offsets[b] : row_offsets[b] + nbs[b]``.
    nbs/row_offsets int64 (nbs < 2**32)."""
    _check_common(values, validity, sel, col_offsets, nbuckets)
    dev = values.device
    B = nbs.shape[0]
    check(table, "table", torch.int32, dev)
    if table.dim() != 2 or table.shape[1] != 2 * BUCKET_SLOTS:
        raise ValueError(f"cuckoo table must be [R, 8], got {tuple(table.shape)}")
    check(nbs, "nbs", torch.int64, dev, (B,))
    check(row_offsets, "row_offsets", torch.int64, dev, (B,))
    if not use_kernel(values):
        return cuckoo_lookup_plain(
            values, validity, table, nbs, row_offsets, sel, col_offsets, miss, null, nbuckets
        )
    if table.data_ptr() % 16:
        raise ValueError("cuckoo table must be 16-byte aligned for int4 bucket loads")
    return _launch(
        "cuckoo_lookup",
        values,
        ([values, validity, table, nbs, row_offsets, sel, col_offsets], []),
        miss,
        null,
        nbuckets,
        counter,
    )


def cuckoo_lookup_plain(values, validity, table, nbs, row_offsets, sel, col_offsets, miss=OOV_INDEX, null=NULL_INDEX,
                        nbuckets=None):
    s = sel.long()
    nb, ro = nbs[s][:, None], row_offsets[s][:, None]
    code = torch.zeros_like(values)
    hit = torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    for seed in SEEDS:
        code, hit = _probe_plain(table[bucket_index_plain(values, nb, seed) + ro], values, code, hit)
    return _epilogue(code, hit, validity, col_offsets, miss, null, values, nbuckets)


def _probe_plain(rows, values, code, hit, live=True):
    """Compare ``values`` with the 4 slots of their bucket ``rows`` [..., 8]
    in slot order, a later hit overriding (the reference's order); ``live``
    masks the rows that exist."""
    for slot in range(BUCKET_SLOTS):
        h = (rows[..., slot] == values) & (rows[..., BUCKET_SLOTS + slot] >= 0) & live
        code = torch.where(h, rows[..., BUCKET_SLOTS + slot], code)
        hit = hit | h
    return code, hit


def bucket_index_plain(values: torch.Tensor, nb, seed: int) -> torch.Tensor:
    """Bucket of each int32 key under ``seed`` among ``nb`` buckets (an int
    or a tensor broadcasting against ``values``); the key's uint32 bit
    pattern is what the kernel hashes."""
    return fmix32_plain((values.long() & M32) ^ seed) % nb


# --- K6 + K4: a single-hash primary and a two-choice stash ------------------------
def stash_lookup(values, validity, table, nbps, row_offsets, stash, nbss, stash_offsets, sel, col_offsets,
                 miss=OOV_INDEX, null=NULL_INDEX, nbuckets=None, counter=None):
    """Replaces ``BatchedStash.encode_dev`` (nvtabular_tpu/ops/lookup.py:
    632) and, with one table row, ``StashLookup.encode_dev`` (:330).

    table [R, 8] int32: the primaries' bucket rows ``[k0..k3, v0..v3]`` (v =
    -1: empty), column row b owning ``nbps[b]`` rows (a power of two) from
    ``row_offsets[b]``, probed at ``mix32(u, 0) & (nbps[b] - 1)``; stash
    [S, 8]: the stashes, ``nbss[b]`` rows (a power of two, or 0) from
    ``stash_offsets[b]``, probed at ``mix32(u, seed) & (nbss[b] - 1)`` for
    the two ``STASH_SEEDS``. The kernel reads the stash only where the
    primary misses. That gives the reference's codes (which probe all three
    buckets, a later hit overriding) only for tables where each key sits in
    one bucket, as ``build_stash`` makes them; the plain version follows the
    reference's order. nbps, row_offsets, nbss, stash_offsets int64."""
    _check_common(values, validity, sel, col_offsets, nbuckets)
    dev = values.device
    B = nbps.shape[0]
    for t, what in ((table, "table"), (stash, "stash")):
        check(t, what, torch.int32, dev)
        if t.dim() != 2 or t.shape[1] != 2 * BUCKET_SLOTS:
            raise ValueError(f"stash lookup {what} must be [R, 8], got {tuple(t.shape)}")
    for t, what in ((nbps, "nbps"), (row_offsets, "row_offsets"), (nbss, "nbss"), (stash_offsets, "stash_offsets")):
        check(t, what, torch.int64, dev, (B,))
    if not use_kernel(values):
        return stash_lookup_plain(values, validity, table, nbps, row_offsets, stash, nbss, stash_offsets, sel,
                                  col_offsets, miss, null, nbuckets)
    if table.data_ptr() % 16 or stash.data_ptr() % 16:
        raise ValueError("stash lookup tables must be 16-byte aligned for int4 bucket loads")
    return _launch(
        "stash_lookup",
        values,
        ([values, validity, table, nbps, row_offsets, stash, nbss, stash_offsets, sel, col_offsets], []),
        miss,
        null,
        nbuckets,
        counter,
    )


def stash_lookup_plain(values, validity, table, nbps, row_offsets, stash, nbss, stash_offsets, sel, col_offsets,
                       miss=OOV_INDEX, null=NULL_INDEX, nbuckets=None):
    s = sel.long()
    u = values.long() & M32
    miss_all = torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    primary = (fmix32_plain(u) & (nbps[s][:, None] - 1)) + row_offsets[s][:, None]
    # the reference's order: the primary, then both stash buckets, a later hit overriding
    code, hit = _probe_plain(table[primary], values, torch.zeros_like(values), miss_all)
    nbs = nbss[s][:, None]
    has = nbs > 0
    for seed in STASH_SEEDS:
        idx = torch.where(has, (fmix32_plain(u ^ seed) & (nbs - 1).clamp(min=0)) + stash_offsets[s][:, None], 0)
        code, hit = _probe_plain(stash[idx], values, code, hit, has)
    return _epilogue(code, hit, validity, col_offsets, miss, null, values, nbuckets)


# --- K8 + K4: sorted float vocabularies, a binary search ------------------------
def sorted_lookup(values, validity, keys, codes, starts, lens, sel, col_offsets, miss=OOV_INDEX, null=NULL_INDEX,
                  nbuckets=None):
    """Replaces the searchsorted branch of ``_Vocab.encode_device``
    (nvtabular_tpu/ops/categorify.py:552-585, :570-576).

    values [C, N] float32. keys [K] float32: every vocabulary's keys
    ascending, concatenated; codes [K] int32 beside them; vocabulary row b
    spans ``keys[starts[b] : starts[b] + lens[b]]`` (starts/lens int64). A
    value's code is that of the first key equal to it (a left search), so
    two vocabulary keys that round to one float32 give the first one's code,
    and -0.0 and 0.0 find the same key. Subnormal values compare as zero, as
    XLA's flush to zero has them on the reference's device path (the table
    holds its keys flushed); a missed value hashes its own bits."""
    _check_common(values, validity, sel, col_offsets, nbuckets, torch.float32)
    dev = values.device
    B = starts.shape[0]
    check(keys, "keys", torch.float32, dev)
    check(codes, "codes", torch.int32, dev, keys.shape)
    check(starts, "starts", torch.int64, dev, (B,))
    check(lens, "lens", torch.int64, dev, (B,))
    if not use_kernel(values):
        return sorted_lookup_plain(values, validity, keys, codes, starts, lens, sel, col_offsets, miss, null, nbuckets)
    return _launch(
        "sorted_lookup",
        values,
        ([values, validity, keys, codes, starts, lens, sel, col_offsets], []),
        miss,
        null,
        nbuckets,
    )


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """Float32 subnormals → 0.0 (XLA compares them as zero on the CPU and
    the TPU; CUDA and PyTorch compare them exactly)."""
    return torch.where(x.abs() < FLT32_MIN, torch.zeros_like(x), x)


def padded_keys(keys, starts, lens):
    """[B, max(lens)] float32: row b's keys, then +inf (so every row is
    non-decreasing), and the index in ``keys`` of each entry (clamped into
    ``keys``: a pad entry's index is never read as a hit)."""
    width = int(lens.max()) if lens.numel() else 0
    j = torch.arange(width, device=keys.device)[None, :]
    idx = (starts[:, None] + torch.minimum(j, (lens[:, None] - 1).clamp(min=0))).clamp(max=max(keys.numel() - 1, 0))
    rows = keys[idx] if keys.numel() else torch.zeros(idx.shape, device=keys.device)
    return torch.where(j < lens[:, None], rows, float("inf")), idx


def sorted_lookup_plain(values, validity, keys, codes, starts, lens, sel, col_offsets, miss=OOV_INDEX,
                        null=NULL_INDEX, nbuckets=None):
    s = sel.long()
    rows, idx = padded_keys(keys, starts, lens)
    rows, idx = rows[s].contiguous(), idx[s]
    code = torch.zeros(values.shape, dtype=torch.int32, device=values.device)
    hit = torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    if rows.shape[1]:
        x = flush_subnormals(values)
        pos = torch.searchsorted(rows, x).clamp(max=rows.shape[1] - 1)  # first key >= value
        hit = (pos < lens[s][:, None]) & (torch.gather(rows, 1, pos) == x)
        code = codes[torch.gather(idx, 1, pos)]
    return _epilogue(code, hit, validity, col_offsets, miss, null, values, nbuckets)
