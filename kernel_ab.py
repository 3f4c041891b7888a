"""Times kernels of the port on the card from one or more checkouts, so
that two versions of a kernel are compared in one call at the shapes of
chip_smoke.py's main paths:

    python3 kernel_ab.py --tree OLD --tree NEW --tree NEW --tree OLD [--cases k2,bag,adagrad] [--out FILE]

The cases, by group (``--cases``; all by default):

- ``k13b``: K13b's forward and backward at DLRM's [65536, 27, 16] in both
  modes and at the multihot DLRM's [65536, 4, 64];
- ``k13b_streamed``: K13b's streamed kernels (one sample past 227 KB) at
  phase 23's [512, 120, 1024], both modes and directions, each beside
  ``bmm``: the forward's full 120 x 120 product, the backward's of the
  symmetric gradient matrix (built outside the timing);
- ``k13d``: K13d's forward and backward at xDeepFM's layers 1 and 2, in
  float32 and in bfloat16 (x_k, x_0, w and g);
- ``k16``: K16's forward and backward at phase 17's [65536, 26, 16] + 13
  dense features, and the backward's split by inputs, never by a change of
  source: its ids all out of range (no linear gradient), those ids and no
  dense features (dv alone), each column's ids on distinct rows (the
  linear gradient without hot rows), and the [sum V] zero fill alone;
- ``k15d``: K15d's forward (``range_gather_columns``) on model shard 1 of 4
  of phase 20's padded tables, phase 21's shape;
- ``repairs``: the kernels whose limits were repaired at their main-path
  shapes: K12b on [500000] with 5 bounds, K17 at [65536, 429], K13a's
  gather and scatter at [65536, 26, 16] and K13c's forward at [65536, 4] of
  [23, 16];
- ``k14``: K14 (``permute_rows``) over phase 8's 28 arrays (26 int32 codes,
  the [n, 13] float32 dense block, the label) and phase 24a's 26 int16
  columns, n = 262,144, one int64 permutation, and phase 8's 26 code columns
  alone (the int16 case's random reads, twice its bytes), each also by the
  identity permutation (the same bytes, read in order);
- ``k11c``: K11c (``ragged_segment_reduce``) for each combiner over lists
  of phase 26's size: 12,372,651 ratings in the rows of the users that
  zipf(1.2) draws among 162,000 (chip_smoke.py's MovieLens users; the
  head user holds ~2.2M), rows in a seeded order;
- ``k3``: K3 (``cuckoo_lookup``) on phase 3's cuckoo job (the 15 Criteo
  columns past 4,096 keys, vocabularies of chip_smoke.py make_part's 16
  partitions, batch 0), on the same job with 1,000 OOV buckets a column and
  31% of the values moved out of the vocabularies (phase 15's miss share),
  and on one table row (the solo branch, ``cuckoo_lookup_solo``) of the
  largest vocabulary; the tables, built on the host by the tree's
  ``build_cuckoo``, are cached in build/kernel_ab_k3.pt for the trees after;
- ``k1``: K1 (``tiny_lookup``) on phase 4's tiny job (the 11 Criteo columns
  of at most 4,096 keys, vocabularies of chip_smoke.py make_part's 16
  partitions, batch 0's [11, 262144] ids), on the same job with 1,000 OOV
  buckets a column and every value moved out of the vocabularies (K4's
  hashed branch), and on one table row (the solo branch,
  ``tiny_lookup_solo``) of the largest tiny vocabulary, each beside
  ``torch.searchsorted`` over the padded rows (positions only). The job is
  cached in build/kernel_ab_k1.pt;
- ``k2``: K2 (``direct_lookup``) on phase 6's compact job (chip_smoke.py
  make_compact_part's 4 columns of ~290K keys over its 4 partitions,
  batch 0's [4, 262144] ids), on the same job with 1,000 OOV buckets a
  column and every value moved out of the tables, on MovieLens ids as
  chip_smoke.py make_movielens_part draws them (phase 9's [1, 500000]
  group index of the userIds its 50 partitions hold, miss and null the
  group count; phase 10's [2, 500000] movieId and userId pair), and on one
  table row (the solo branch, ``direct_lookup_solo``) of the largest
  compact table; the tables are cached in build/kernel_ab_k2.pt;
- ``bag``: the range bag in take mode (``range_bag``, K15d's bag forward)
  at phase 23's shape, [65536, 4] genres lists of 1-4 ids (DeviceLoader's
  padding: id 0, mask 0) against shard 1 of 4 of the padded [24, 64]
  genres table, written into a slot of a [65536, 3, 64] buffer; and in the
  zero rule (``embedding_range_bag``, K15b) at phase 19's shape: phase
  18's [65536, 26] Criteo ids (each column's codes moved by its table's
  offset, mask 0.7) against shard 1 of 4 of the [sum V, 16] table;
- ``adagrad``: one ``Adagrad.step`` of phase 7's DLRM (dim 16, MLPs
  512-256, 13 tensors, the tables [sum V, 16] of the Criteo-like columns
  below) with the gradient of one batch of their ids: K18
  (``kernels.adagrad.adagrad_update``) on a tree that has it, held bit for
  bit against ``adagrad_update_plain`` from the same state; on a tree
  without it, the plain update that ``Adagrad.step`` ran there;
- ``k19``: K19 at phase 8's shapes: the epilogue forward (in place) and
  backward at [65536, 512] and [65536, 256] with ReLU and the bfloat16
  round, [65536, 16] with ReLU and [65536, 1] with the bias alone, and the
  round of the top MLP's input [65536, 367] and its three weights; on a
  tree without ``kernels/mlp_epilogue.py`` the plain ops that tree's MLP
  ran (``y + b``, ``relu``, the two casts, and autograd's backward of
  them). Then one forward + backward of phase 7's DLRM (as ``adagrad``
  builds it), with its device time by layer (chip_smoke.py
  ``layer_split``: the products, K13a, K13b, K19, K20, the rest);
- ``k20``: K20's loss and gradient on [65536] logits, beside
  ``F.binary_cross_entropy_with_logits`` and its backward alone; on a tree
  without ``kernels/bce.py`` its ``bce_with_logits`` and autograd's
  backward of it.

The ids are Criteo-like codes made on the card: each column's 16 x 262,144
draws of floor(card * u**2.5) (chip_smoke.py make_part) coded by descending
count from 3, as Categorify codes them, and the batch the first 65,536 of
them; the tables hold each column's distinct values and 3 reserved rows.

A tree is the root of a checkout (the directory that holds
``nvtabular_tpu_torch/``). Each runs in a process of its own, in the order
given, and builds its kernels from its own ``csrc/`` into its own
``build/``. ``DIR%kName=V[,kName=V]`` runs a variant of a tree: a copy of
its package under build/ab/ in which each named ``constexpr`` of ``csrc/``
(one definition each) is set to V, e.g. ``.%kBagLoads=8``.
``DIR@F,D,G,T,S`` runs a tree with K13b's forward planned as G samples a
group, T threads a block and S stages at [F, D] (several such plans joined
by ``+``; the tree's ``interaction.fwd_plan`` elsewhere).
Every case is first held against the tree's plain version on the same
inputs (bit-equal where the kernel's operations are the plain version's,
else within 1e-5 of the terms' magnitudes + 1e-5); its time is the median of
5 CUDA-event windows of 25 calls (5 for K13d) behind a device-side sleep,
as chip_smoke.py times the kernels. A case a tree's wrapper refuses (a
shape past its limits: ValueError or NotImplementedError) is recorded with
its error; a failed launch ends the run. ``--split`` adds each case's
device time a launch by kernel under torch.profiler (10 calls). Prints one JSON
line a tree, then a table; ``--out`` writes the records as JSON. Imports
no JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

TIMED_ITERS, REPEATS, WARMUP_S = 25, 5, 0.3
SLEEP_CYCLES = 100_000_000  # >= 50 ms at the H100's <= 1.98 GHz SM clock
RTOL, ATOL = 1e-5, 1e-5
BATCH = 65536  # chip_smoke.py TRAIN_BS
CIN_L2_BATCH, CIN_FIELDS, CIN_MAPS, CIN_DIM = 8192, 26, 200, 16  # chip_smoke.py phase 23
STREAM_BATCH, STREAM_FEATURES, STREAM_DIM = 512, 120, 1024  # chip_smoke.py phase 23


def time_ms(torch, fn, iters=TIMED_ITERS) -> float:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_S:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    samples = []
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return sorted(samples)[REPEATS // 2]


def within(got, want, magnitude) -> float:
    """The largest error; raises where an entry passes the tolerance."""
    err = (got - want).abs()
    if not bool((err <= RTOL * magnitude + ATOL).all()):
        raise SystemExit(f"kernel differs from plain: max abs {float(err.max())}")
    return float(err.max())


CRITEO_TB_CARDINALITIES = [  # chip_smoke.py
    227605432, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 130229467,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 292775614,
    40790948, 187188510, 590152, 12973, 108, 36,
]
FIT_ROWS, NUM_CONTS, TRAIN_DIM, MODEL_SHARDS, SHARD_PAD = 16 * 262144, 13, 16, 4, 4  # chip_smoke.py
PERMUTE_ROWS, BUCKET_ROWS, TS_BOUNDS = 262144, 500_000, [60.0, 3600.0, 43200.0, 86400.0, 604800.0]
GROUPS = ("k13b", "k13b_streamed", "k13d", "k16", "k15d", "repairs", "k11c", "k3", "k1", "k14", "k2", "bag",
          "adagrad", "k19", "k20")
ML_USERS, SESSION_VALUES = 162_000, 12_372_651  # chip_smoke.py; phase 26's listed ratings
ML_MOVIES, ML_GENRES, ML_ROWS_PER_PART, MH_SPARSE_MAX = 62_000, 20, 500_000, 4  # chip_smoke.py
K3_CACHE = Path("build") / "kernel_ab_k3.pt"
K1_CACHE = Path("build") / "kernel_ab_k1.pt"
K2_CACHE = Path("build") / "kernel_ab_k2.pt"
GENRES_PADDED = 24  # phase 22's genres table: 20 genres and 3 reserved rows, padded to a multiple of SHARD_PAD


def criteo_ids(torch, dev, gen):
    """Each column's batch of BATCH codes and its table's rows (the column's
    distinct values of its FIT_ROWS draws and 3 reserved rows), codes by
    descending count from 3 (ties by value)."""
    ids, sizes = [], []
    for card in CRITEO_TB_CARDINALITIES:
        u = torch.rand(FIT_ROWS, device=dev, generator=gen, dtype=torch.float64)
        raw = (card * u ** 2.5).long()
        values, inverse, counts = torch.unique(raw, return_inverse=True, return_counts=True)
        order = torch.argsort(-counts, stable=True)
        code = torch.empty_like(order)
        code[order] = torch.arange(order.numel(), device=dev)
        ids.append((code[inverse[:BATCH]] + 3).int())
        sizes.append(values.numel() + 3)
    return ids, sizes


def device_split(torch, fn, calls=10) -> dict:
    """Each kernel's mean device time a launch (microseconds) under
    torch.profiler, over ``calls`` calls of ``fn`` after one more, and the
    launches the profiler saw."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:100]: [round(e.device_time_total / e.count, 2), e.count] for e in prof.key_averages()
            if e.device_time_total > 0}


def one_tree(tree: str, plans: dict, groups, split: bool = False) -> dict:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import nvtabular_tpu_torch
    from nvtabular_tpu_torch.kernels import build

    if not Path(nvtabular_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {nvtabular_tpu_torch.__file__}, not the package of {root}")
    build.build_all()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(16)
    rec = {}

    def case(name, fn, check=None, iters=TIMED_ITERS, by_layer=False):
        """Times fn after check() (the max abs error, raising where the
        kernel differs); a tree whose wrapper refuses the case (ValueError,
        NotImplementedError) records its refusal. A failed launch raises
        RuntimeError, which ends the tree's process with its error.
        ``by_layer``: its device time a call by layer (chip_smoke.py
        layer_split)."""
        try:
            err = check() if check else None
            rec[name] = {"ms": time_ms(torch, fn, iters), "max_abs_err": err}
            if split:
                rec[name]["device_us"] = device_split(torch, fn)
            if by_layer:
                rec[name]["by_layer"] = smoke_module().layer_split(fn, calls=10)
        except (ValueError, NotImplementedError) as e:
            rec[name] = {"ms": None, "error": f"{type(e).__name__}: {e}"[:300]}

    def equal(got, want, what):
        if not torch.equal(got, want):
            raise SystemExit(f"{what} is not equal to its plain version")
        return 0.0

    if {"k13b", "k13b_streamed", "k13d"} & set(groups):
        from nvtabular_tpu_torch.kernels import cin as kcin
        from nvtabular_tpu_torch.kernels import interaction as kint

        if plans:
            tree_plan = kint.fwd_plan
            kint.fwd_plan = lambda F, D, self_interaction: plans.get((F, D)) or tree_plan(F, D, self_interaction)

    def interaction(F, D, lead, self_interaction):
        """K13b at [BATCH, F, D], its pairs after a lead-wide block of a row
        as the models write them, and the gradient from the same slot."""
        x = torch.randn((BATCH, F, D), device=dev, generator=gen)
        P = kint.num_pairs(F, self_interaction)
        buf = torch.zeros((BATCH, lead + P), device=dev)
        gbuf = torch.randn((BATCH, lead + P), device=dev, generator=gen)
        out, g = buf[:, lead:], gbuf[:, lead:]
        mode = "self" if self_interaction else "pair"
        got = kint.interaction_fwd(x, out=out, self_interaction=self_interaction)
        want = kint.interaction_fwd_plain(x, self_interaction)
        if self_interaction:
            err = equal(got, want, f"interaction_fwd self [{F}, {D}]")
        else:
            err = within(got, want, kint.interaction_fwd_plain(x.abs()))
        rec[f"interaction_fwd {mode} [{BATCH}, {F}, {D}]"] = {
            "ms": time_ms(torch, lambda: kint.interaction_fwd(x, out=out, self_interaction=self_interaction)),
            "max_abs_err": err, "plan": list(kint.fwd_plan(F, D, self_interaction))}
        got = kint.interaction_bwd(x, g, self_interaction)
        err = within(got, kint.interaction_bwd_plain(x, g, self_interaction),
                     kint.interaction_bwd_plain(x.abs(), g.abs(), self_interaction))
        rec[f"interaction_bwd {mode} [{BATCH}, {F}, {D}]"] = {
            "ms": time_ms(torch, lambda: kint.interaction_bwd(x, g, self_interaction)), "max_abs_err": err}

    if "k13b" in groups:
        interaction(27, 16, 16, False)  # DLRM's Criteo step (phases 7, 20)
        interaction(27, 16, 16, True)   # phase 23's self mode
        interaction(4, 64, 64, False)   # the multihot DLRM step (phase 22)
    if "k13b_streamed" in groups:
        B, F, D = STREAM_BATCH, STREAM_FEATURES, STREAM_DIM
        x = torch.randn((B, F, D), device=dev, generator=gen)
        for self_interaction in (False, True):
            mode = "self" if self_interaction else "pair"
            rows, cols = np.tril_indices(F, 0 if self_interaction else -1)
            g = torch.randn((B, len(rows)), device=dev, generator=gen)
            gsym = torch.zeros((B, F, F), device=dev)
            gsym[:, rows, cols] = g
            gsym = gsym + gsym.transpose(1, 2)
            case(f"interaction_fwd streamed {mode} [{B}, {F}, {D}]",
                 lambda m=self_interaction: kint.interaction_fwd(x, self_interaction=m),
                 lambda m=self_interaction: within(kint.interaction_fwd(x, self_interaction=m),
                                                   kint.interaction_fwd_plain(x, m),
                                                   kint.interaction_fwd_plain(x.abs(), m)))
            case(f"bmm {mode} [{B}, {F}, {D}] x its transpose", lambda: torch.bmm(x, x.transpose(1, 2)))
            case(f"interaction_bwd streamed {mode} [{B}, {F}, {D}]",
                 lambda m=self_interaction, g=g: kint.interaction_bwd(x, g, m),
                 lambda m=self_interaction, g=g: within(kint.interaction_bwd(x, g, m),
                                                        kint.interaction_bwd_plain(x, g, m),
                                                        kint.interaction_bwd_plain(x.abs(), g.abs(), m)))
            case(f"bmm {mode} symmetric gradient [{B}, {F}, {F}] x [{B}, {F}, {D}]",
                 lambda s=gsym: torch.bmm(s, x))
            del g, gsym
        del x
        torch.cuda.empty_cache()
    if "k13d" in groups:
        for layer, (Bc, Hk) in enumerate(((BATCH, CIN_FIELDS), (CIN_L2_BATCH, CIN_MAPS)), start=1):
            x0 = torch.randn((Bc, CIN_FIELDS, CIN_DIM), device=dev, generator=gen)
            xk = x0 if layer == 1 else torch.randn((Bc, Hk, CIN_DIM), device=dev, generator=gen)
            w = torch.randn((Hk * CIN_FIELDS, CIN_MAPS), device=dev, generator=gen) / (Hk * CIN_FIELDS) ** 0.5
            g = torch.randn((Bc, CIN_MAPS, CIN_DIM), device=dev, generator=gen)
            shape = f"[{Bc}, {Hk}, {CIN_FIELDS}, {CIN_DIM}, {CIN_MAPS}]"
            case(f"cin_fwd layer {layer} {shape}", lambda: kcin.cin_fwd(xk, x0, w),
                 lambda: within(kcin.cin_fwd(xk, x0, w), kcin.cin_fwd_plain(xk, x0, w),
                                kcin.cin_fwd_plain(xk.abs(), x0.abs(), w.abs())), iters=5)
            case(f"cin_bwd layer {layer} {shape}", lambda: kcin.cin_bwd(xk, x0, w, g),
                 lambda: max(within(*t) for t in zip(kcin.cin_bwd(xk, x0, w, g), kcin.cin_bwd_plain(xk, x0, w, g),
                                                     kcin.cin_bwd_plain(xk.abs(), x0.abs(), w.abs(), g.abs()))),
                 iters=5)
            # bfloat16 (timed only: chip_smoke.py holds it to its plain versions); a tree without it refuses
            x0h = x0.to(torch.bfloat16)
            xkh = x0h if xk is x0 else xk.to(torch.bfloat16)
            wh, gh = w.to(torch.bfloat16), g.to(torch.bfloat16)
            case(f"cin_fwd bfloat16 layer {layer} {shape}", lambda: kcin.cin_fwd(xkh, x0h, wh), iters=5)
            case(f"cin_bwd bfloat16 layer {layer} {shape}", lambda: kcin.cin_bwd(xkh, x0h, wh, gh), iters=5)
            del x0, xk, w, g, x0h, xkh, wh, gh
            torch.cuda.empty_cache()

    ids, sizes = criteo_ids(torch, dev, gen) if {"k16", "k15d", "repairs", "bag", "adagrad", "k19"} & set(groups) \
        else (None, None)
    F, D, nd = len(CRITEO_TB_CARDINALITIES), TRAIN_DIM, NUM_CONTS
    if "k16" in groups:
        from nvtabular_tpu_torch.kernels import fm as kfm

        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
        num_rows = sum(sizes)
        x = torch.randn((BATCH, F * D + nd), device=dev, generator=gen)
        v, dense = x[:, : F * D].unflatten(1, (F, D)), x[:, F * D:]
        linear = torch.randn(num_rows, device=dev, generator=gen)
        dense_w = torch.randn(nd, device=dev, generator=gen)
        g = torch.randn(BATCH, device=dev, generator=gen)
        shape = f"[{BATCH}, {F}, {D}] + {nd}"
        rows, valid = kfm.table_rows(ids, offsets, sizes)
        s2, q = v.sum(1), (v * v).sum(1)
        # chip_smoke.py phase 17's magnitudes: the second order's two sums, the linear terms, the dense dot
        fwd_mag = (s2 * s2 + q).sum(1) + torch.where(valid, linear[rows].abs(), 0.0).sum(1) + \
            (dense * dense_w).abs().sum(1)
        case(f"fm_fwd {shape}", lambda: kfm.fm_fwd(v, dense, ids, offsets, sizes, linear, dense_w),
             lambda: within(kfm.fm_fwd(v, dense, ids, offsets, sizes, linear, dense_w),
                            kfm.fm_fwd_plain(v, dense, ids, offsets, sizes, linear, dense_w), fwd_mag))
        del rows, valid, s2, q, fwd_mag
        dx = torch.empty_like(x)
        dv_out, ddense_out = dx[:, : F * D].unflatten(1, (F, D)), dx[:, F * D:]

        def bwd(ids_, dense_, dw_, dd_out):
            return lambda: kfm.fm_bwd(v, dense_, ids_, offsets, sizes, dw_, g, num_rows, dv_out=dv_out,
                                      ddense_out=dd_out)

        def check_bwd():
            got = [t.clone() for t in bwd(ids, dense, dense_w, ddense_out)()]
            want = kfm.fm_bwd_plain(v, dense, ids, offsets, sizes, dense_w, g, num_rows)
            mag = kfm.fm_bwd_plain(v, dense.abs(), ids, offsets, sizes, dense_w, g.abs(), num_rows)
            limits = (g.abs()[:, None, None] * v.abs().sum(1, keepdim=True), want[1].abs(), mag[2], mag[3])
            return max(within(a, b, m) for a, b, m in zip(got, want, limits))

        case(f"fm_bwd {shape}", bwd(ids, dense, dense_w, ddense_out), check_bwd)
        off = [torch.full_like(i, -2**31) for i in ids]  # no id in range: no linear gradient
        none = x[:, F * D: F * D]
        case(f"fm_bwd no linear {shape}", bwd(off, dense, dense_w, ddense_out))
        case(f"fm_bwd dv only {shape}", bwd(off, none, dense_w[:0], dx[:, F * D: F * D]))
        b = torch.arange(BATCH, device=dev)
        distinct = [(b % s).int() for s in sizes]  # each column's ids on distinct rows where it has them
        case(f"fm_bwd distinct ids {shape}", bwd(distinct, dense, dense_w, ddense_out))
        dl = torch.empty(num_rows, device=dev)
        case(f"zero fill of [{num_rows}]", dl.zero_)
        del x, linear, dx, dl
    if "k15d" in groups:
        from nvtabular_tpu_torch.kernels import embedding as kemb

        padded = [-(-s // SHARD_PAD) * SHARD_PAD for s in sizes]
        shard = [p // MODEL_SHARDS for p in padded]
        starts = [s * 1 for s in shard]
        offs = np.concatenate([[0], np.cumsum(shard)[:-1]]).tolist()
        cols = (offs, shard, starts, padded)
        local = torch.randn((sum(shard), D), device=dev, generator=gen)
        gbuf = torch.empty((BATCH, 1 + F, D), device=dev)
        out = gbuf[:, 1:]

        def check_gather(m):
            got = kemb.range_gather_columns(local, ids, *cols, m, out=out)
            want = kemb.range_gather_columns_plain(local, ids, *cols, m)
            if not (torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(), want.nan_to_num())):
                raise SystemExit("range_gather_columns differs from plain")
            return 0.0

        case(f"range_gather_columns shard 1 of {MODEL_SHARDS} [{BATCH}, {F}, {D}]",
             lambda: kemb.range_gather_columns(local, ids, *cols, 1, out=out), lambda: check_gather(1))
        case(f"range_gather_columns rank 0 [{BATCH}, {F}, {D}]",
             lambda: kemb.range_gather_columns(local, ids, *cols, 0, out=out), lambda: check_gather(0))
        del local, gbuf
    if "repairs" in groups:
        from nvtabular_tpu_torch.kernels import bucketize as kbk
        from nvtabular_tpu_torch.kernels import cross as kcross
        from nvtabular_tpu_torch.kernels import embedding as kemb
        from nvtabular_tpu_torch.kernels import embedding_bag as kbag
        xb = (torch.rand(BUCKET_ROWS, device=dev, generator=gen) * 1e6).float()
        bounds = torch.tensor(TS_BOUNDS, device=dev)
        case(f"bucketize [{BUCKET_ROWS}], {len(TS_BOUNDS)} bounds", lambda: kbk.bucketize(xb, bounds),
             lambda: equal(kbk.bucketize(xb, bounds), kbk.bucketize_plain(xb, bounds), "bucketize"))
        N = F * D + nd
        xw, x0, xl, gc = (torch.randn((BATCH, N), device=dev, generator=gen) for _ in range(4))
        cb = torch.randn(N, device=dev, generator=gen)
        case(f"cross_fwd [{BATCH}, {N}]", lambda: kcross.cross_fwd(xw, cb, x0, xl),
             lambda: equal(kcross.cross_fwd(xw, cb, x0, xl), kcross.cross_fwd_plain(xw, cb, x0, xl), "cross_fwd"))
        case(f"cross_bwd [{BATCH}, {N}]", lambda: kcross.cross_bwd(gc, xw, cb, x0),
             lambda: within(kcross.cross_bwd(gc, xw, cb, x0)[2], kcross.cross_bwd_plain(gc, xw, cb, x0)[2],
                            (gc * x0).abs().sum(0)))
        del xw, x0, xl, gc
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
        table = torch.randn((sum(sizes), D), device=dev, generator=gen)
        feats = torch.empty((BATCH, 1 + F, D), device=dev)
        case(f"embedding_gather [{BATCH}, {F}, {D}]",
             lambda: kemb.embedding_gather(table, ids, offsets, sizes, out=feats[:, 1:]),
             lambda: equal(kemb.embedding_gather(table, ids, offsets, sizes, out=feats[:, 1:]),
                           kemb.embedding_gather_plain(table, ids, offsets, sizes), "embedding_gather"))
        ge = torch.randn((BATCH, 1 + F, D), device=dev, generator=gen)[:, 1:]
        case(f"embedding_scatter_grad [{BATCH}, {F}, {D}]",
             lambda: kemb.embedding_scatter_grad(ge, ids, offsets, sizes, table.shape[0]),
             lambda: within(kemb.embedding_scatter_grad(ge, ids, offsets, sizes, table.shape[0]),
                            kemb.embedding_scatter_grad_plain(ge, ids, offsets, sizes, table.shape[0]),
                            kemb.embedding_scatter_grad_plain(ge.abs(), ids, offsets, sizes, table.shape[0])))
        del table, feats, ge
        tb = torch.randn((23, D), device=dev, generator=gen)
        values = torch.randint(0, 23, (BATCH, 4), device=dev, generator=gen, dtype=torch.int32)
        mask = (torch.rand((BATCH, 4), device=dev, generator=gen) < 0.7).float()
        case(f"embedding_bag_fwd [{BATCH}, 4] of [23, {D}]", lambda: kbag.embedding_bag_fwd(tb, values, mask),
             lambda: equal(kbag.embedding_bag_fwd(tb, values, mask), kbag.embedding_bag_fwd_plain(tb, values, mask),
                           "embedding_bag_fwd"))
    if "k11c" in groups:
        from nvtabular_tpu_torch.kernels import ragged as kragged

        rng = np.random.default_rng(26)
        counts = np.bincount(rng.zipf(1.2, SESSION_VALUES).clip(1, ML_USERS))[1:]
        lengths = rng.permutation(counts[counts > 0])
        offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)).to(dev)
        values = torch.from_numpy((rng.integers(1, 11, SESSION_VALUES) / 2.0).astype(np.float32)).to(dev)
        R = offsets.shape[0] - 1

        def check_reduce(c):
            got = kragged.ragged_segment_reduce(values, offsets, R, c)
            want = kragged.ragged_segment_reduce_plain(values, offsets, R, c)
            if c in ("min", "max"):
                return equal(got, want, f"ragged_segment_reduce {c}")
            return within(got.double(), want.double(),
                          kragged.ragged_segment_reduce_plain(values.abs(), offsets, R, c).double())

        for c in ("sum", "mean", "min", "max"):
            case(f"ragged_segment_reduce {c} [{SESSION_VALUES}] in {R} rows (longest {int(lengths.max())})",
                 lambda c=c: kragged.ragged_segment_reduce(values, offsets, R, c), lambda c=c: check_reduce(c))
        del values, offsets
    if "k14" in groups:
        from nvtabular_tpu_torch.kernels import permute as kperm

        n, m = PERMUTE_ROWS, ML_ROWS_PER_PART
        arrays = {f"C{c}": torch.randint(0, 2**31 - 1, (n,), device=dev, generator=gen, dtype=torch.int32)
                  for c in range(F)}
        arrays["dense"] = torch.randn((n, nd), device=dev, generator=gen)
        arrays["label"] = torch.randn(n, device=dev, generator=gen)
        perm = torch.randperm(n, device=dev, generator=gen)
        codes = {k: v for k, v in arrays.items() if k.startswith("C")}
        narrow = {k: v.to(torch.int16) for k, v in codes.items()}
        # phase 10's feed: one MovieLens partition as DeviceLoader(sparse_max={"genres": 4}) hands it over
        multihot = {
            "dense": torch.randn((m, 1), device=dev, generator=gen),
            "userId": torch.randint(3, ML_USERS + 3, (m,), device=dev, generator=gen, dtype=torch.int32),
            "movieId": torch.randint(3, ML_MOVIES + 3, (m,), device=dev, generator=gen, dtype=torch.int32),
            "genres__values": torch.randint(3, ML_GENRES + 3, (m, MH_SPARSE_MAX), device=dev, generator=gen,
                                            dtype=torch.int32),
            "genres__mask": (torch.rand((m, MH_SPARSE_MAX), device=dev, generator=gen) < 0.6).float(),
            "label": torch.rand(m, device=dev, generator=gen) * 5,
        }
        mperm = torch.randperm(m, device=dev, generator=gen)
        shapes = {"28 arrays": (arrays, perm), "26 int16 arrays": (narrow, perm), "26 int32 arrays": (codes, perm),
                  "multihot chunk's 6 arrays": (multihot, mperm)}
        for what, (arrs, p) in shapes.items():
            rows = p.shape[0]
            case(f"permute_rows {what} [{rows}]", lambda a=arrs, p=p: kperm.permute_rows(a, p),
                 lambda a=arrs, p=p: max(equal(kperm.permute_rows(a, p)[k], v[p], f"permute_rows {k}")
                                         for k, v in a.items()))
            # the same bytes read in order: what random reads cost beside them
            ident = torch.arange(rows, device=dev)
            case(f"permute_rows {what} [{rows}], identity permutation",
                 lambda a=arrs, i=ident: kperm.permute_rows(a, i))
        # an independent random-gather rate: one index_select of the 26 columns' 6.8M values by a random
        # permutation of them (int32 indexes), one random 4-byte or 2-byte read a value
        flat = torch.cat(list(codes.values()))
        idx = torch.randperm(flat.numel(), device=dev, generator=gen).int()
        for dt in (torch.int32, torch.int16):
            src = flat.to(dt)
            case(f"index_select of {flat.numel()} {str(dt)[6:]} values by a random permutation",
                 lambda s=src: torch.index_select(s, 0, idx))
        del arrays, narrow, codes, multihot, flat, idx
    if "k1" in groups:
        from nvtabular_tpu_torch.kernels import lookup as klk

        chip_smoke = smoke_module()
        job = k1_job(torch)
        keys, codes, lens, vals = (job[k].to(dev) for k in ("keys", "codes", "lens", "values"))
        C, n = vals.shape
        sel = torch.arange(C, dtype=torch.int32, device=dev)
        offs = torch.zeros(C, dtype=torch.int32, device=dev)
        moved = vals ^ 0x5A5A5A5A
        nbk = torch.full((C,), 1000, dtype=torch.int32, device=dev)
        big = int(job["largest"])
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        solo = tuple(t[big: big + 1].contiguous() for t in (keys, codes, lens))
        runs = {
            f"tiny_lookup [{C}, {n}] (phase 4's job)": (vals, (keys, codes, lens), sel, offs, None, None),
            f"tiny_lookup [{C}, {n}], 1,000 OOV buckets, every value moved": (moved, (keys, codes, lens), sel, offs,
                                                                               nbk, None),
            f"tiny_lookup_solo [1, {n}] of {int(lens[big])} keys": (vals[big: big + 1].contiguous(), solo, zero,
                                                                    zero, None, "tiny_lookup_solo"),
        }
        for name, (v, (k, cd, ln), sl, of, nk, counter) in runs.items():
            def run(v=v, k=k, cd=cd, ln=ln, sl=sl, of=of, nk=nk, counter=counter):
                return klk.tiny_lookup(v, None, k, cd, ln, sl, of, nbuckets=nk, counter=counter)

            case(name, run, lambda v=v, k=k, cd=cd, ln=ln, sl=sl, of=of, nk=nk, run=run: equal(
                run(), klk.tiny_lookup_plain(v, None, k, cd, ln, sl, of, nbuckets=nk), name))
            rows = chip_smoke.tiny_padded_rows(SimpleNamespace(keys=k, lens=ln), sl)
            case(f"searchsorted {name} (positions only)", lambda r=rows, v=v: torch.searchsorted(r, v))
        del keys, codes, vals, moved
    if "k3" in groups:
        from nvtabular_tpu_torch.kernels import lookup as klk

        job = k3_job(torch)
        table, nbs, row_off, vals = (job[k].to(dev) for k in ("table", "nbs", "row_offsets", "values"))
        C, n = vals.shape
        sel = torch.arange(C, dtype=torch.int32, device=dev)
        offs = torch.zeros(C, dtype=torch.int32, device=dev)
        moved = torch.where(torch.rand(vals.shape, device=dev, generator=gen) < 0.31, vals ^ 0x5A5A5A5A, vals)
        nbk = torch.full((C,), 1000, dtype=torch.int32, device=dev)
        solo = job["solo"]
        st, sn, sv = (solo[k].to(dev) for k in ("table", "nbs", "values"))
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        runs = {
            f"cuckoo_lookup [{C}, {n}] (phase 3's job)": (vals, table, nbs, row_off, sel, offs, None, None),
            f"cuckoo_lookup [{C}, {n}], 1,000 OOV buckets, 31% moved": (moved, table, nbs, row_off, sel, offs, nbk,
                                                                       None),
            f"cuckoo_lookup_solo [1, {sv.shape[1]}] of {int(sn[0])} buckets": (sv, st, sn, zero.long(), zero, zero,
                                                                              None, "cuckoo_lookup_solo"),
        }
        for name, (v, t, nb, ro, sl, of, nk, counter) in runs.items():
            def run(v=v, t=t, nb=nb, ro=ro, sl=sl, of=of, nk=nk, counter=counter):
                return klk.cuckoo_lookup(v, None, t, nb, ro, sl, of, nbuckets=nk, counter=counter)

            case(name, run, lambda v=v, t=t, nb=nb, ro=ro, sl=sl, of=of, nk=nk, run=run: equal(
                run(), klk.cuckoo_lookup_plain(v, None, t, nb, ro, sl, of, nbuckets=nk), name))
            rec[name].update(cuckoo_sectors(torch, klk, v, t, nb[sl.long()][:, None], ro[sl.long()][:, None]))
        del table, vals, moved, st
    if "k2" in groups:
        from nvtabular_tpu_torch.kernels import lookup as klk

        job = k2_job(torch)
        for name, t in job["tables"].items():
            job["tables"][name] = {k: v.to(dev) for k, v in t.items()}
        vals = job["compact"].to(dev)
        C, n = vals.shape
        ml = job["movielens"].to(dev)  # [2, 500000]: movieId, userId of partition 0
        big = int(job["largest"])
        groups_ = int(job["user_groups"])
        runs = {
            f"direct_lookup [{C}, {n}] (phase 6's job)": (vals, "compact", list(range(C)), 2, 1, None, None),
            f"direct_lookup [{C}, {n}], 1,000 OOV buckets, every value moved": (
                vals ^ 0x5A5A5A5A, "compact", list(range(C)), 2, 1, 1000, None),
            f"direct_lookup [1, {ml.shape[1]}] userId group index of {groups_} groups (phase 9)": (
                ml[1:].contiguous(), "users", [0], groups_, groups_, None, None),
            f"direct_lookup [2, {ml.shape[1]}] movieId, userId (phase 10)": (ml, "movielens", [0, 1], 2, 1, None,
                                                                              None),
            f"direct_lookup_solo [1, {n}] of {int(job['tables']['solo']['lens'][0])} keys": (
                vals[big: big + 1].contiguous(), "solo", [0], 2, 1, None, "direct_lookup_solo"),
        }
        for name, (v, tab, sel_, miss, null, nb, counter) in runs.items():
            t = job["tables"][tab]
            sl = torch.tensor(sel_, dtype=torch.int32, device=dev)
            of = torch.zeros(len(sel_), dtype=torch.int32, device=dev)
            nk = None if nb is None else torch.full((len(sel_),), nb, dtype=torch.int32, device=dev)
            args = (v, None, t["table"], t["mins"], t["maxs"], t["lens"], t["offsets"], sl, of, miss, null, nk)

            def run(args=args, counter=counter):
                return klk.direct_lookup(*args, counter=counter)

            case(name, run, lambda args=args, run=run, name=name: equal(run(), klk.direct_lookup_plain(*args), name))
        del vals, ml
    if "bag" in groups:
        from nvtabular_tpu_torch.kernels import embedding_bag as kbag

        rows, Dg = GENRES_PADDED // MODEL_SHARDS, 64
        lengths = torch.randint(1, MH_SPARSE_MAX + 1, (BATCH, 1), device=dev, generator=gen)
        held = torch.arange(MH_SPARSE_MAX, device=dev)[None, :] < lengths
        genres = torch.randint(3, ML_GENRES + 3, (BATCH, MH_SPARSE_MAX), device=dev, generator=gen, dtype=torch.int32)
        gvals, gmask = torch.where(held, genres, 0).to(torch.int32), held.float()
        glocal = torch.randn((rows, Dg), device=dev, generator=gen)
        buf = torch.zeros((BATCH, 3, Dg), device=dev)
        out = buf[:, 2]

        def check_take():
            got = kbag.range_bag(glocal, gvals, gmask, rows, GENRES_PADDED, 1, out=out)
            want = kbag.range_bag_plain(glocal, gvals, gmask, rows, GENRES_PADDED, 1)
            if not (torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(), want.nan_to_num())):
                raise SystemExit("range_bag differs from plain")
            return 0.0

        case(f"range_bag [{BATCH}, {MH_SPARSE_MAX}] of shard 1 of {MODEL_SHARDS} [{rows}, {Dg}]",
             lambda: kbag.range_bag(glocal, gvals, gmask, rows, GENRES_PADDED, 1, out=out), check_take)
        offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]), device=dev)
        cvals = (torch.stack([i.long() for i in ids], 1) + offsets).to(torch.int32)
        cmask = (torch.rand(cvals.shape, device=dev, generator=gen) < 0.7).float()
        crows = sum(sizes) // MODEL_SHARDS
        clocal = torch.randn((crows, D), device=dev, generator=gen)
        case(f"embedding_range_bag [{BATCH}, {F}] of shard 1 of {MODEL_SHARDS} [{crows}, {D}]",
             lambda: kbag.embedding_range_bag(clocal, cvals, cmask, crows),
             lambda: equal(kbag.embedding_range_bag(clocal, cvals, cmask, crows),
                           kbag.embedding_range_bag_plain(clocal, cvals, cmask, crows), "embedding_range_bag"))
        del buf, clocal
    if "adagrad" in groups:
        adagrad_case(torch, dev, gen, ids, sizes, case)
    if "k19" in groups:
        k19_cases(torch, dev, gen, ids, sizes, case)
    if "k20" in groups:
        k20_cases(torch, dev, gen, case)
    return {"tree": tree, "plans": {f"{F},{D}": list(p) for (F, D), p in plans.items()}, "cases": rec}


def adagrad_case(torch, dev, gen, ids, sizes, case) -> None:
    """One Adagrad.step of phase 7's DLRM over tables of ``sizes`` rows with
    the gradient of the batch ``ids``; where the tree has K18, first held
    bit for bit against its plain version from the same state."""
    import importlib.util

    from nvtabular_tpu_torch import models

    model, batch = dlrm_batch(torch, dev, gen, ids, sizes)
    opt = models.Adagrad(model.parameters(), lr=1e-2)
    models.dlrm_loss(model, batch).backward()
    check = None
    if importlib.util.find_spec("nvtabular_tpu_torch.kernels.adagrad") is not None:
        from nvtabular_tpu_torch.kernels import adagrad as kada

        def check():
            state = [t.detach().clone() for t in [*opt.params, *opt.sum_of_squares]]
            k, grads = len(opt.params), [p.grad for p in opt.params]
            want = [t.clone() for t in state]
            kada.adagrad_update(state[:k], state[k:], grads, opt.lr)
            kada.adagrad_update_plain(want[:k], want[k:], grads, opt.lr)
            for a, b in zip(state, want):
                if not (torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())):
                    raise SystemExit("adagrad_update differs from plain")
            return 0.0

    rows = sum(sizes)
    case(f"Adagrad.step [{rows}, {TRAIN_DIM}] + MLPs, {len(opt.params)} tensors", opt.step, check, iters=10)
    del model, opt, batch
    torch.cuda.empty_cache()


def bits_equal_nan(torch, got, want, what) -> float:
    """0.0 where ``got`` has ``want``'s bits, NaN where NaN; raises otherwise."""
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan].view(torch.int32),
                                                               want[~nan].view(torch.int32))):
        raise SystemExit(f"{what} is not bit-equal to its plain version")
    return 0.0


def dlrm_batch(torch, dev, gen, ids, sizes):
    """Phase 7's DLRM over tables of ``sizes`` rows and a batch of ``ids``."""
    from nvtabular_tpu_torch import models

    names = [f"C{i}" for i in range(len(sizes))]
    config = models.DLRMConfig(dict(zip(names, sizes)), num_dense=NUM_CONTS, embedding_dim=TRAIN_DIM)
    model = models.DLRM(config, seed=0, device=dev)
    batch = {**dict(zip(names, ids)), "dense": torch.randn((BATCH, NUM_CONTS), device=dev, generator=gen),
             "label": (torch.rand(BATCH, device=dev, generator=gen) < 0.25).float()}
    return model, batch


def k19_cases(torch, dev, gen, ids, sizes, case) -> None:
    """K19 at phase 8's shapes, or the plain ops of a tree without it; then
    phase 7's DLRM forward + backward, by kernel."""
    import importlib.util

    from nvtabular_tpu_torch import models

    has = importlib.util.find_spec("nvtabular_tpu_torch.kernels.mlp_epilogue") is not None
    cdt = torch.bfloat16
    for N, relu, rnd in ((512, True, cdt), (256, True, cdt), (TRAIN_DIM, True, None), (1, False, None)):
        y = torch.randn((BATCH, N), device=dev, generator=gen)
        b = torch.randn(N, device=dev, generator=gen)
        g = torch.randn((BATCH, N), device=dev, generator=gen)
        tag = f"[{BATCH}, {N}] " + ("relu, round" if rnd else "relu" if relu else "bias")
        if has:
            from nvtabular_tpu_torch.kernels import mlp_epilogue as kep

            def check_fwd(y=y, b=b, relu=relu, rnd=rnd):
                got, want = y.clone(), y.clone()
                mask, want_mask = kep.mlp_epilogue_fwd(got, b, relu, rnd), kep.mlp_epilogue_fwd_plain(want, b, relu, rnd)
                if relu and not torch.equal(mask, want_mask):
                    raise SystemExit("mlp_epilogue_fwd's mask differs from plain")
                return bits_equal_nan(torch, got, want, "mlp_epilogue_fwd")

            scratch = y.clone()  # in place: the timed calls write over a copy
            case(f"mlp_epilogue_fwd {tag}", lambda s=scratch, b=b, r=relu, c=rnd: kep.mlp_epilogue_fwd(s, b, r, c),
                 check_fwd)
            mask = kep.mlp_epilogue_fwd(y.clone(), b, relu, rnd)

            def check_bwd(g=g, mask=mask, relu=relu, rnd=rnd):
                (dz, db), (want_dz, want_db) = (kep.mlp_epilogue_bwd(g, mask, relu, rnd),
                                                kep.mlp_epilogue_bwd_plain(g, mask, relu, rnd))
                bits_equal_nan(torch, dz, want_dz, "mlp_epilogue_bwd's dz")
                return within(db, want_db, want_dz.abs().sum(0))

            case(f"mlp_epilogue_bwd {tag}", lambda g=g, m=mask, r=relu, c=rnd: kep.mlp_epilogue_bwd(g, m, r, c),
                 check_bwd)
        else:  # the tree's MLP: y + b, relu, the round's two casts, and autograd's backward of them
            def plain(y, b, relu=relu, rnd=rnd):
                z = y + b
                z = torch.relu(z) if relu else z
                return z if rnd is None else z.to(rnd).to(torch.float32)

            case(f"mlp_epilogue_fwd {tag}", lambda y=y, b=b, f=plain: f(y, b))
            yr, br = y.clone().requires_grad_(True), b.clone().requires_grad_(True)
            out = plain(yr, br)
            case(f"mlp_epilogue_bwd {tag}",
                 lambda o=out, yr=yr, br=br, g=g: torch.autograd.grad(o, (yr, br), g, retain_graph=True))
        del y, g
    group = [torch.randn((BATCH, TRAIN_DIM + 351), device=dev, generator=gen)]
    group += [torch.randn(s, device=dev, generator=gen) for s in ((TRAIN_DIM + 351, 512), (512, 256), (256, 1))]
    if has:
        case(f"round_group [{BATCH}, {TRAIN_DIM + 351}] + 3 weights", lambda: kep.round_group(group, cdt),
             lambda: max(bits_equal_nan(torch, a, w, "round_group")
                         for a, w in zip(kep.round_group(group, cdt), kep.round_group_plain(group, cdt))))
    else:
        case(f"round_group [{BATCH}, {TRAIN_DIM + 351}] + 3 weights",
             lambda: [t.to(cdt).to(torch.float32) for t in group])
    del group
    model, batch = dlrm_batch(torch, dev, gen, ids, sizes)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        models.dlrm_loss(model, batch).backward()

    case(f"DLRM forward + backward [{BATCH}]", fwd_bwd, iters=10, by_layer=True)
    del model, batch
    torch.cuda.empty_cache()


def k20_cases(torch, dev, gen, case) -> None:
    """K20 on [BATCH] logits (or a tree's plain loss and autograd's backward
    of it), beside F.binary_cross_entropy_with_logits and its backward."""
    import importlib.util

    import torch.nn.functional as F

    from nvtabular_tpu_torch import models

    logits = torch.randn(BATCH, device=dev, generator=gen) * 2
    labels = (torch.rand(BATCH, device=dev, generator=gen) < 0.25).float()
    one = torch.ones((), device=dev)
    if importlib.util.find_spec("nvtabular_tpu_torch.kernels.bce") is not None:
        from nvtabular_tpu_torch.kernels import bce as kbce

        def check_fwd():
            got, want = float(kbce.bce_fwd(logits, labels)), float(kbce.bce_fwd_plain(logits, labels))
            if not abs(got - want) <= 1e-6 * abs(want):
                raise SystemExit(f"bce_fwd {got} differs from plain {want}")
            return abs(got - want)

        case(f"bce_fwd [{BATCH}]", lambda: kbce.bce_fwd(logits, labels), check_fwd)
        case(f"bce_bwd [{BATCH}]", lambda: kbce.bce_bwd(logits, labels, one),
             lambda: bits_equal_nan(torch, kbce.bce_bwd(logits, labels, one),
                                    kbce.bce_bwd_plain(logits, labels, one), "bce_bwd"))
    else:
        case(f"bce_fwd [{BATCH}]", lambda: models.bce_with_logits(logits, labels))
        lr = logits.clone().requires_grad_(True)
        loss = models.bce_with_logits(lr, labels)
        case(f"bce_bwd [{BATCH}]", lambda: torch.autograd.grad(loss, lr, retain_graph=True))
    case(f"F.binary_cross_entropy_with_logits [{BATCH}]", lambda: F.binary_cross_entropy_with_logits(logits, labels))
    lf = logits.clone().requires_grad_(True)
    lib_loss = F.binary_cross_entropy_with_logits(lf, labels)
    case(f"its backward [{BATCH}]", lambda: torch.autograd.grad(lib_loss, lf, retain_graph=True))


def cuckoo_sectors(torch, klk, values, table, nb, ro) -> dict:
    """The distinct 32-byte buckets a lookup of ``values`` reads when it
    probes both buckets of every value, and when it probes b1 only where b0
    misses; the share of values b0 serves."""
    b0 = klk.bucket_index_plain(values, nb, klk.SEEDS[0]) + ro
    b1 = klk.bucket_index_plain(values, nb, klk.SEEDS[1]) + ro
    rows = table[b0]
    hit0 = ((rows[..., :4] == values[..., None]) & (rows[..., 4:] >= 0)).any(-1)
    return {"sectors_both": int(torch.unique(torch.cat([b0.flatten(), b1.flatten()])).numel()),
            "sectors_b0_first": int(torch.unique(torch.cat([b0.flatten(), b1[~hit0]])).numel()),
            "b0_share": float(hit0.float().mean())}


def smoke_module():
    """chip_smoke.py beside this script: its data makers and helpers."""
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import chip_smoke

    return chip_smoke


def k1_job(torch) -> dict:
    """Phase 4's tiny job: the Criteo columns of chip_smoke.py make_part of
    at most TINY_MAX distinct ids over its 16 partitions, each column's ids
    (codes 3, 4, ...) in the tree's BatchedTiny bin, batch 0's ids [C,
    262144], and the row of the largest vocabulary. Cached in K1_CACHE."""
    if K1_CACHE.exists():
        return torch.load(K1_CACHE)
    import numpy as np

    from nvtabular_tpu_torch.ops import lookup as plookup

    chip_smoke = smoke_module()
    parts = [chip_smoke.make_part(s) for s in range(chip_smoke.NUM_PARTS)]
    names = [f"C{i}" for i in range(chip_smoke.NUM_CATS)]
    vocabs = {c: np.unique(np.concatenate([p[c] for p in parts])) for c in names}
    cols = [c for c in names if len(vocabs[c]) <= plookup.TINY_MAX]
    bin_ = plookup.BatchedTiny([plookup.TinyLookup(vocabs[c], np.arange(len(vocabs[c])) + 3) for c in cols])
    job = {"keys": bin_.keys, "codes": bin_.codes, "lens": bin_.lens, "columns": cols,
           "values": torch.from_numpy(np.stack([parts[0][c] for c in cols])),
           "largest": int(bin_.lens.argmax())}
    K1_CACHE.parent.mkdir(parents=True, exist_ok=True)
    torch.save(job, K1_CACHE)
    return job


def k2_job(torch) -> dict:
    """Phase 6's compact job and MovieLens ids: the tree's BatchedDirect
    tables (codes 3, 4, ... by key) of chip_smoke.py make_compact_part's 4
    columns over its 4 partitions, batch 0's ids [4, 262144] and the largest
    table alone; the userId group index of make_movielens_part's ML_PARTS
    partitions (codes 0 .. G - 1 by key) and the movieId and userId tables,
    partition 0's [movieId, userId] ids. Cached in K2_CACHE."""
    if K2_CACHE.exists():
        return torch.load(K2_CACHE)
    import numpy as np

    from nvtabular_tpu_torch.ops import lookup as plookup

    chip_smoke = smoke_module()

    def tables(vocabs, codes):
        b = plookup.BatchedDirect([plookup.build_direct(v, c) for v, c in zip(vocabs, codes)])
        return {k: getattr(b, k) for k in ("table", "mins", "maxs", "lens", "offsets")}

    parts = [chip_smoke.make_compact_part(s) for s in range(4)]
    names = list(parts[0])
    vocabs = [np.unique(np.concatenate([p[c] for p in parts])) for c in names]
    big = int(np.argmax([len(v) for v in vocabs]))
    ml = [chip_smoke.make_movielens_part(s) for s in range(chip_smoke.ML_PARTS)]
    users = np.unique(np.concatenate([p["userId"] for p in ml]))
    movies = np.unique(np.concatenate([p["movieId"] for p in ml]))
    job = {"tables": {"compact": tables(vocabs, [np.arange(len(v)) + 3 for v in vocabs]),
                      "solo": tables(vocabs[big: big + 1], [np.arange(len(vocabs[big])) + 3]),
                      "users": tables([users], [np.arange(len(users))]),
                      "movielens": tables([movies, users], [np.arange(len(movies)) + 3, np.arange(len(users)) + 3])},
           "compact": torch.from_numpy(np.stack([parts[0][c] for c in names])), "largest": big,
           "movielens": torch.from_numpy(np.stack([ml[0]["movieId"], ml[0]["userId"]]).astype(np.int32)),
           "user_groups": len(users)}
    K2_CACHE.parent.mkdir(parents=True, exist_ok=True)
    torch.save(job, K2_CACHE)
    return job


def variant_tree(spec: str) -> str:
    """DIR%kName=V[,kName=V]: a copy of DIR's package under build/ab/ with
    each named constexpr of its csrc/ set to V; returns the copy's root."""
    tree, _, assigns = spec.partition("%")
    root = Path("build") / "ab" / ("variant_" + re.sub(r"[^\w]+", "_", spec).strip("_"))
    if root.exists():
        shutil.rmtree(root)
    pkg = root / "nvtabular_tpu_torch"
    shutil.copytree(Path(tree) / "nvtabular_tpu_torch", pkg, ignore=shutil.ignore_patterns("__pycache__"))
    sources = sorted((pkg / "csrc").glob("*.cu*"))
    for assign in assigns.split(","):
        name, _, value = assign.partition("=")
        pattern = re.compile(rf"(constexpr\s+[\w:]+\s+{re.escape(name)}\s*=\s*)[^;]+;")
        hits = [(f, f.read_text()) for f in sources if pattern.search(f.read_text())]
        if len(hits) != 1 or len(pattern.findall(hits[0][1])) != 1:
            raise SystemExit(f"{spec}: {name} is defined {sum(len(pattern.findall(t)) for _, t in hits)} times")
        f, text = hits[0]
        f.write_text(pattern.sub(lambda m: f"{m.group(1)}{value};", text))
    return str(root)


def k3_job(torch) -> dict:
    """Phase 3's cuckoo job: the Criteo columns of chip_smoke.py make_part
    past 4,096 distinct ids over its 16 partitions, each column's ids (codes
    3, 4, ...) in a table of the tree's build_cuckoo, batched as
    BatchedCuckoo stacks them; batch 0's ids [C, 262144]; and the largest
    vocabulary alone with its column of batch 0 (the solo branch). Cached
    in K3_CACHE (the build is the host's, unchanged between the trees)."""
    if K3_CACHE.exists():
        return torch.load(K3_CACHE)
    import numpy as np

    from nvtabular_tpu_torch.ops import lookup as plookup

    chip_smoke = smoke_module()
    parts = [chip_smoke.make_part(s) for s in range(chip_smoke.NUM_PARTS)]
    names = [f"C{i}" for i in range(chip_smoke.NUM_CATS)]
    vocabs = {c: np.unique(np.concatenate([p[c] for p in parts])) for c in names}
    cols = [c for c in names if len(vocabs[c]) > plookup.TINY_MAX]
    luts = {c: plookup.build_cuckoo(vocabs[c], np.arange(len(vocabs[c])) + 3) for c in cols}
    batched = plookup.BatchedCuckoo([luts[c] for c in cols])
    big = max(cols, key=lambda c: len(vocabs[c]))
    solo = plookup.BatchedCuckoo([luts[big]])
    job = {"table": batched.table, "nbs": batched.nbs, "row_offsets": batched.row_offsets,
           "values": torch.from_numpy(np.stack([parts[0][c] for c in cols])), "columns": cols,
           "solo": {"table": solo.table, "nbs": solo.nbs, "values": torch.from_numpy(parts[0][big][None].copy()),
                    "column": big}}
    K3_CACHE.parent.mkdir(parents=True, exist_ok=True)
    torch.save(job, K3_CACHE)
    return job


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="a checkout's root, or DIR@F,D,G,T,S[+...]")
    ap.add_argument("--out", help="write the card and the trees' records here")
    ap.add_argument("--cases", default=",".join(GROUPS), help=f"groups of cases, of {', '.join(GROUPS)}")
    ap.add_argument("--split", action="store_true", help="also each case's device time by kernel (torch.profiler)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        tree, _, spec = args.one.partition("@")
        plans = {}
        for item in filter(None, spec.split("+")):
            F, D, *plan = (int(v) for v in item.split(","))
            plans[(F, D)] = tuple(plan)
        print(json.dumps(one_tree(tree, plans, args.cases.split(","), args.split)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    recs = []
    for tree in args.tree:
        base, at, spec = tree.partition("@")
        one = (variant_tree(base) if "%" in base else base) + at + spec
        proc = subprocess.run([sys.executable, __file__, "--tree", tree, "--one", one, "--cases", args.cases]
                              + ["--split"] * args.split, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{tree} failed ({proc.returncode}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        recs.append({**json.loads(proc.stdout.strip().splitlines()[-1]), "tree": tree})
        print(json.dumps(recs[-1]), flush=True)
    for rec in recs:
        for name, r in rec["cases"].items():
            if "by_layer" in r:
                print(f"{rec['tree']}: {name}, device ms a call by layer {r['by_layer']}", flush=True)
    names = list(recs[0]["cases"])
    for rec in recs[1:]:
        names += [n for n in rec["cases"] if n not in names]
    width = max(len(n) for n in names)
    print(f"{'case':{width}}  " + "  ".join(r["tree"] for r in recs))
    for n in names:
        print(f"{n:{width}}  " + "  ".join(f"{r['cases'][n]['ms']:.4f}" if r["cases"].get(n, {}).get("ms") else "-"
                                           for r in recs))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "trees": recs}, indent=1))


if __name__ == "__main__":
    main()
