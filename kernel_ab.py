"""Times kernels of the port on the card from one or more checkouts, so
that two versions of a kernel are compared in one call at the shapes of
chip_smoke.py's main paths:

    python3 kernel_ab.py --tree OLD --tree NEW --tree NEW --tree OLD [--cases k16,k15d] [--out FILE]

The cases, by group (``--cases``; all by default):

- ``k13b``: K13b's forward and backward at DLRM's [65536, 27, 16] in both
  modes and at the multihot DLRM's [65536, 4, 64];
- ``k13b_streamed``: K13b's streamed kernels (one sample past 227 KB) at
  phase 23's [512, 120, 1024], both modes and directions, each beside
  ``bmm``: the forward's full 120 x 120 product, the backward's of the
  symmetric gradient matrix (built outside the timing);
- ``k13d``: K13d's forward at xDeepFM's layers 1 and 2;
- ``k16``: K16's forward and backward at phase 17's [65536, 26, 16] + 13
  dense features, and the backward's split by inputs, never by a change of
  source: its ids all out of range (no linear gradient), those ids and no
  dense features (dv alone), each column's ids on distinct rows (the
  linear gradient without hot rows), and the [sum V] zero fill alone;
- ``k15d``: K15d's forward (``range_gather_columns``) on model shard 1 of 4
  of phase 20's padded tables, phase 21's shape;
- ``repairs``: the kernels whose limits were repaired at their main-path
  shapes: K14 over phase 7's 28 arrays (and 26 int16 columns where the tree
  takes them), K12b on [500000] with 5 bounds, K17 at [65536, 429], K13a's
  gather and scatter at [65536, 26, 16] and K13c's forward at [65536, 4] of
  [23, 16];
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
  ``build_cuckoo``, are cached in build/kernel_ab_k3.pt for the trees after.

The ids are Criteo-like codes made on the card: each column's 16 x 262,144
draws of floor(card * u**2.5) (chip_smoke.py make_part) coded by descending
count from 3, as Categorify codes them, and the batch the first 65,536 of
them; the tables hold each column's distinct values and 3 reserved rows.

A tree is the root of a checkout (the directory that holds
``nvtabular_tpu_torch/``). Each runs in a process of its own, in the order
given, and builds its kernels from its own ``csrc/`` into its own
``build/``. ``DIR@F,D,G,T,S`` runs a tree with K13b's forward planned as G
samples a group, T threads a block and S stages at [F, D] (several such
plans joined by ``+``; the tree's ``interaction.fwd_plan`` elsewhere).
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
import subprocess
import sys
import time
from pathlib import Path

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
GROUPS = ("k13b", "k13b_streamed", "k13d", "k16", "k15d", "repairs", "k11c", "k3")
ML_USERS, SESSION_VALUES = 162_000, 12_372_651  # chip_smoke.py; phase 26's listed ratings
K3_CACHE = Path("build") / "kernel_ab_k3.pt"


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

    def case(name, fn, check=None, iters=TIMED_ITERS):
        """Times fn after check() (the max abs error, raising where the
        kernel differs); a tree whose wrapper refuses the case (ValueError,
        NotImplementedError) records its refusal. A failed launch raises
        RuntimeError, which ends the tree's process with its error."""
        try:
            err = check() if check else None
            rec[name] = {"ms": time_ms(torch, fn, iters), "max_abs_err": err}
            if split:
                rec[name]["device_us"] = device_split(torch, fn)
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
            err = within(kcin.cin_fwd(xk, x0, w), kcin.cin_fwd_plain(xk, x0, w),
                         kcin.cin_fwd_plain(xk.abs(), x0.abs(), w.abs()))
            rec[f"cin_fwd layer {layer} [{Bc}, {Hk}, {CIN_FIELDS}, {CIN_DIM}, {CIN_MAPS}]"] = {
                "ms": time_ms(torch, lambda: kcin.cin_fwd(xk, x0, w), iters=5), "max_abs_err": err}
            del x0, xk, w
            torch.cuda.empty_cache()

    ids, sizes = criteo_ids(torch, dev, gen) if {"k16", "k15d", "repairs"} & set(groups) else (None, None)
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
        from nvtabular_tpu_torch.kernels import permute as kperm

        n = PERMUTE_ROWS
        arrays = {f"C{c}": torch.randint(0, 2**31 - 1, (n,), device=dev, generator=gen, dtype=torch.int32)
                  for c in range(F)}
        arrays["dense"] = torch.randn((n, nd), device=dev, generator=gen)
        arrays["label"] = torch.randn(n, device=dev, generator=gen)
        perm = torch.randperm(n, device=dev, generator=gen)
        narrow = {k: v.to(torch.int16) for k, v in arrays.items() if k.startswith("C")}
        for what, arrs in (("28 arrays", arrays), ("26 int16 arrays", narrow)):
            case(f"permute_rows {what} [{n}]", lambda a=arrs: kperm.permute_rows(a, perm),
                 lambda a=arrs: max(equal(kperm.permute_rows(a, perm)[k], v[perm], f"permute_rows {k}")
                                    for k, v in a.items()))
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
    return {"tree": tree, "plans": {f"{F},{D}": list(p) for (F, D), p in plans.items()}, "cases": rec}


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

    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import chip_smoke
    from nvtabular_tpu_torch.ops import lookup as plookup

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
        proc = subprocess.run([sys.executable, __file__, "--tree", tree, "--one", tree, "--cases", args.cases]
                              + ["--split"] * args.split, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{tree} failed ({proc.returncode}):\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        recs.append({**json.loads(proc.stdout.strip().splitlines()[-1]), "tree": tree})
        print(json.dumps(recs[-1]), flush=True)
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
