#!/usr/bin/env python3
"""Drive nvtabular_tpu_torch's main path once on one CUDA GPU and hold every
kernel against its plain PyTorch version.

    python3 chip_smoke.py [--out results.json] [--profile]

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU and
nvcc (CUDA_HOME, PATH or /usr/local/cuda). Phases, each failing the run with
a nonzero exit:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles the CUDA kernels from csrc/ (one nvcc per source, all at
   once) and prints ptxas' registers / shared memory / spills;
3. main path: the Criteo ETL workflow of bench.py at full width — 26 int32
   columns at the Criteo-TB cardinality profile through
   Categorify(max_size=10_000_000), 13 float32 columns with ~5% NaN through
   FillMissing >> Clip(min_value=0) >> LogOp >> Normalize, and a label —
   Workflow.fit, then Workflow.transform of all 16 x 256K-row batches on
   cuda, with the launch counters zeroed just before and read just after;
   one batch is compared with the same workflow on the CPU (same fitted
   state through convert.load_fitted_state, plain versions): codes exact,
   floats within rtol=1e-5, atol=1e-5;
4. kernels at main-path shapes: the tiny and cuckoo lookups on the fitted
   bins and the continuous chain on [13, 262144] float32, each against its
   plain version on the same card (codes bit-identical; the chain within
   rtol=1e-5, atol=1e-6), timed with CUDA events;
5. throughput: transform rows/s with and without the host-to-device copy;
6. a second path, a compact-key workflow (4 columns of ~290K keys each,
   1M rows) whose Categorify takes the direct map, driven and checked the
   same way, and the direct lookup kernel held against its plain version;
7. the training path of bench.py at full width: the phase-3 workflow's
   transform of the first 4 partitions feeds DeviceLoader(batch_size=65536,
   shuffle=True, seed=0, drop_last=True), whose chunks train a DLRM
   (DLRMConfig.from_schema(..., embedding_dim=16): bottom 13-512-256-16, top
   367-512-256-1, 26 tables at the fitted cardinalities) with Adagrad(1e-2):
   one warm-up chunk, then TRAIN_REPEATS timed passes of 64 steps, with the
   launch counters zeroed before the loader's staging and read after the
   last step; every code is below its table's cardinality and every loss
   finite; one batch's loss, logits and gradients through the kernels are
   held against the plain versions on the card (in bfloat16 compute, as
   trained, and in float32);
8. the kernels of the training path at its shapes — permute_rows,
   embedding_gather, embedding_scatter_grad, interaction_fwd and
   interaction_bwd — each against its plain version on the card, timed
   beside its bound and, where one PyTorch call computes the same function,
   that call;
9. the advanced MovieLens path (BASELINE config 2, bench/movielens_bench.py:
   73-85) at ml-25m size — 162,000 users, 62,000 movies, 50 partitions of
   500,000 rows made by the bench's generator — through TargetEncoding
   ("rating", kfold=3, p_smooth=20) on userId and movieId, JoinGroupby on
   movieId (mean and count of ts_delta), LambdaOp(np.log1p) >> Bucketize on
   ts_delta and HashedCross(10_000) of userId and movieId: Workflow.fit, then
   Workflow.transform of every batch on cuda, the counters zeroed before
   each and read after it; batch 0 against the CPU run (codes, counts,
   cross and bucket ids exact, floats within rtol=1e-6, atol=1e-7); rows/s
   with and without the host-to-device copy and the UDF's host handoff per
   batch; hashed_cross, fold_ids, te_encode, stat_gather and bucketize at
   the path's shapes against their plain versions on the card (bucketize on
   raw ts_delta, where all six buckets fill), timed beside their bounds;
10. the MovieLens multihot path (BASELINE config 1, bench/movielens_bench.py:
   62-70, its rating binarized by a LambdaOp) on phase 9's partitions, with
   the genres list column (1-4 ids of 20 a row): Categorify of userId,
   movieId and genres, LogOp >> Normalize of ts_delta; Workflow.fit and
   Workflow.transform of every batch, counters zeroed before each; batch 0
   against the CPU run (codes and offsets exact); rows/s with and without
   the copy; then the transform of the first MH_TRAIN_PARTS partitions
   through DeviceLoader(sparse_max={"genres": 4}), which pads genres (K11)
   and permutes each chunk (K14), into TabularMLP (1041 -> 512 -> 256 -> 1,
   tables at the fitted cardinalities) with Adagrad(1e-2): a warm-up chunk,
   then TRAIN_REPEATS timed passes of MH_STEPS steps, counters read after;
   one step through the kernels against the plain versions on the card in
   bfloat16 and float32; and ListSlice(0, 3, pad=True) of the genres codes
   over every batch (K11's slice);
11. ragged_to_padded, ragged_slice_padded, embedding_bag_fwd and
   embedding_bag_bwd at phase 10's shapes against their plain versions on
   the card, timed beside their bounds and the library calls;
12. crossed features on phase 3's partitions (Criteo's low-cardinality
   fields): TargetEncoding("label", kfold=5, p_smooth=20) on the groups
   (C5, C8), (C12, C16, C18) and (C15, C24), JoinGroupby (count and mean of
   I0) on (C5, C8) and (C15, C24), Categorify(encode_type="combo") of
   (C8, C15) and (C12, C25), HashBucket(10_000_000) of C0, C9 and C19:
   Workflow.fit (every group's verified hash pair built, no collision among
   the fitted tuples' h1), then Workflow.transform of every batch, the
   counters zeroed before each; batch 0 against the CPU run (counts, combo
   codes and bucket ids exact, TE and stat columns within rtol=1e-6,
   atol=1e-7); rows/s with and without the host-to-device copy;
13. sessions on phase 9's partitions, each stably sorted by userId:
   DifferenceLag("userId", shift=[1, -1]) of rating and ts_delta, one K12a
   launch a batch; batch 0 bit-equal to the CPU run (NaN for NaN); rows/s;
14. hash_pair and hash_pair_verify (K10b on TE's (C15, C24) group, K9 on
   the combo (C8, C15)), HashBucket's K7 and difference_lag at phases
   12-13's shapes against their plain versions on the card, timed beside
   their bounds;
15. Categorify's hashed OOV buckets and float keys on phase 3's partitions:
   the 26 ids through Categorify(freq_threshold=2, max_size=10_000_000,
   num_buckets=1000) and the 13 dense features as float keys through
   Categorify(freq_threshold=2, num_buckets=1000); Workflow.fit, then
   Workflow.transform of every batch, the counters zeroed before each (one
   launch a batch of each integer table kind and of sorted_lookup, no plain
   version on the card); codes within each vocabulary's domain, every one
   of the 1,000 buckets hit by the ids; batch 0 against the CPU run (codes
   exact); the share of rows in OOV buckets; rows/s with and without the
   host-to-device copy; then sorted_lookup (K8) on [13, 262144] float32 and
   the integer lookups with hashed misses, each against its plain version
   on the card, timed beside its bound (K8's library yardstick: one
   torch.searchsorted over the vocabularies padded with +inf, positions
   only);
16. DeepFM and DCN-v2 training on phase 7's feed: the loader staged anew
   (DeviceLoader(65536, shuffle=True, seed=0, drop_last=True) over the
   first 4 transformed partitions) into each model in turn, at the JAX
   configs' defaults over phase 7's 26 tables (22,343,004 rows, dim 16)
   and 13 dense features — DeepFM (deep tower 429 -> 256 -> 128 -> 1, the
   FM terms through K16) and DCN-v2 (3 cross layers of [429, 429] through
   K17, deep tower 429 -> 256 -> 128, output 557 -> 1) — with
   Adagrad(1e-2): one warm-up chunk, then TRAIN_REPEATS timed passes of
   64 steps beside phase 7's DLRM step, the launch counters zeroed before
   the staging and read after the last step (a gather, a scatter and
   DeepFM's fm_fwd and fm_bwd, or DCN's three cross_fwd and three
   cross_bwd, each step; no plain version on the card); every loss
   finite; one batch's loss, logits and gradients through the kernels
   held against the reference forward on the card in bfloat16 and
   float32 (DeepFM's gradients for the plain path's logits gradient:
   its FM terms sum in another order, check_step_parity); each model and
   its optimizer freed before the next;
17. fm_fwd, fm_bwd, cross_fwd and cross_bwd at phase 16's shapes against
   their plain versions on the card (the FM output and the scatter and
   column sums within 1e-5 of their terms' magnitudes; the cross epilogue
   and its elementwise gradients bit-equal), timed beside their bounds;
18. the multi-GPU fit on a one-rank NCCL group (one card): phase 3's
   workflow fitted by Workflow(executor=TorchExecutor(mesh=local_mesh())),
   its 26 columns counted through K15a (route, all_to_all, radix sort),
   every vocabulary's SHA-256 equal to phase 3's, Normalize within
   rtol=1e-6, batch 0's codes equal; sharded_embedding_lookup and
   sharded_embedding_bag over phase 7's 26 tables (22,343,004 x 16) against
   K13a's gather (bit-equal) and K13c's bag (SUM_TOL); sharded_moments of
   the 13 LogOp outputs against float64 numpy (count, min, max exact; mean
   and var within rtol=1e-5); launch counters zeroed before each entry
   point and read after it;
19. the K15 kernels against their plain versions on the card: K15a's route
   at 1, 2, 4 and 8 owners on phase 3's two largest columns (bit-equal send
   buffers and overflow), four ranks composed on the card (route, the
   all_to_all's transpose, sort, run-length encode; the overflow retry on
   the most skewed column) giving phase 18's counts; K15b on model shard 1
   of 4; K15c on [262144, 13]; each timed beside its bound;
20. DLRM training on row-sharded tables on a one-rank NCCL group (one
   card): phase 7's feed (DeviceLoader(65536, shuffle=True, seed=0,
   drop_last=True) over the first 4 transformed partitions) staged anew into
   DLRMConfig.from_schema(..., embedding_dim=16, vocab_pad_multiple=4) (26
   tables, 22,343,004 rows before padding) placed by parallel.shard_params
   over local_mesh(), each batch by shard_batch, stepped by make_train_step
   with Adagrad(1e-2); first the sharded model and an unsharded DLRM of the
   same padded config and parameters take 8 steps each on the same batches
   (losses within STEP_TOL, tables within SUM_TOL), then one warm-up chunk
   and TRAIN_REPEATS timed passes of 64 steps beside phase 7's; the launch
   counters zeroed before the staging and read after the last step (one
   range_gather_columns and one range_scatter_grad a sharded step, K13a
   only in the 8 unsharded steps, no plain version on the card); every
   loss finite;
21. K15d's range_gather_columns and range_scatter_grad on model shard 1 of
   4 of phase 20's padded tables with [65536, 26] ids of its first batch
   and D = 16, each against its plain version on the card and timed beside
   its bound (index_select and zeros + index_add_ of the clamped shard rows
   as the library calls);
22. DLRM with the genres multihot table on phase 10's feed (its loader,
   staged anew: 8 partitions through DeviceLoader(sparse_max={"genres":
   4})), DLRMConfig.from_schema(num_dense=1) at the JAX config's defaults
   (dim 64, bottom and top MLPs 512-256; 2 tables, the 23-row genres
   multihot table, 4 features), Adagrad(1e-2), batch 65,536: a warm-up
   chunk and TRAIN_REPEATS timed passes of MH_STEPS steps (one K13a gather
   and scatter, one K13c bag forward and backward, one K13b forward and
   backward a step), one step kernels-vs-plain; then the same model with
   vocab_pad_multiple=4 through shard_params / shard_batch /
   make_train_step on a one-rank NCCL group: 8 steps beside an unsharded
   DLRM (losses within STEP_TOL, both tables within SUM_TOL) and timed
   passes (one range_gather_columns, range_scatter_grad, range_bag and
   range_bag_grad a step);
23. the layer entry points: dot_product_interaction(self_interaction=True)
   on [65536, 27, 16] and a two-layer CIN (xdeepfm_outer_product, 26
   fields of dim 16, 200 maps) at batch 8,192, forward and backward, held
   against the plain layers; then K15d's bag (forward in take mode and its
   gradient) on model shard 1 of 4 of phase 22's padded genres table with
   its first batch's [65536, 4] values at dim 64, K13b's self mode at
   [65536, 27, 16] -> 378 and K13d at xDeepFM's layer 1 ([65536, 26, 16]
   twice -> 200) and layer 2 ([8192, 200, 16] x [8192, 26, 16] -> 200),
   each against its plain version on the card and timed beside its bound;
24. Criteo's alternative continuous chain on phase 3's partitions, as two
   workflows: 24a, the 13 dense columns through FillMedian >> Clip(min=0) >>
   LogOp >> NormalizeMinMax(out_dtype="float16") (one K5 launch a batch:
   median fill, min-max and a float16 store) and the fields with under
   2,000 values through Categorify >> DropLowCardinality(4) >>
   ReduceDtypeSize >> AddTags; 24b, the dense columns through
   FillMissing(add_binary_cols=True) (one K5 launch a batch, writing the
   _filled masks); each fitted and transformed with the counters zeroed
   before and read after, batch 0 against the CPU run on the same fitted
   state (codes, masks, dtypes and kept columns exact, float16 within two
   ULPs: log1p's float32 ULP can move the cast one), rows/s with and
   without the copy;
25. sessions on phase 9's partitions with ~1% of ts_delta NaN:
   Dataset.shuffle_by_keys(["userId"]) (K7 on the card; the partitions
   equal the CPU shuffle's), then Dropna >> Filter(rating >= 3) >>
   Groupby("userId", sort_cols=["ts_delta"]) >> ValueCount and
   ListSlice(-20, pad=True) of the movie lists (K11b), and K11c
   (ragged_segment_reduce) of each partition's rating lists for sum, mean,
   min and max, held against Groupby's own columns (min and max exact, sum
   and mean within 1e-5 of the rows' |v| sums); every partition equal to
   the CPU run; shuffle seconds, rows/s, host handoff ms a batch;
26. K5's 16-bit and mask modes on phase 24's [13, 262144] batch, and K11c
   on all of phase 25's rating lists at once (the zipf head user among
   them), against their plain versions on the card, timed beside their
   bound and beside torch.segment_reduce.

The line before the last is {"kernels": [...]} with the 42 kernels'
launches, error, times and bound; the last line is {"ok": true,
"device": {...}}.
The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import json
import math
import os
import pkgutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
TIMED_ITERS = 25
REPEATS = 5
WARMUP_S = 0.3
SLEEP_CYCLES = 100_000_000  # >= 50 ms at the H100's <= 1.98 GHz SM clock
DEVICE = "cuda:0"
CONT_TOL = dict(rtol=1e-5, atol=1e-6)  # kernel vs plain on the same card
CPU_TOL = dict(rtol=1e-5, atol=1e-5)  # card vs CPU: log1p ULPs differ
# float32 sums in another order than cuBLAS's bmm / index_add_ (and, for the
# scatter, atomics whose order varies from run to run)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)

# bench.py:636-706: the training chain
TRAIN_PARTS, TRAIN_BS, TRAIN_STEPS, TRAIN_REPEATS, TRAIN_DIM = 4, 65536, 64, 3, 16
# kernel path vs plain path, one step on one batch: (loss rtol, largest
# logit difference, largest gradient difference over the gradient's largest
# entry). float32: only summation orders differ. bfloat16 (as trained): the
# same, and a hidden value that close to a rounding boundary may round the
# other way on the two paths, moving what it feeds by up to 2**-8 relative.
STEP_TOL = {"float32": (1e-5, 1e-4, 1e-4), "bfloat16": (1e-5, 1e-3, 1e-3)}

# bench/movielens_bench.py:30-52 at ml-25m size: 25M ratings in the bench's
# 500K-row partitions; config 2's Bucketize boundaries
ML_USERS, ML_MOVIES, ML_GENRES = 162_000, 62_000, 20
ML_ROWS_PER_PART, ML_PARTS = 500_000, 50
TS_BOUNDS = [60.0, 3600.0, 43200.0, 86400.0, 604800.0]
ML_TOL = dict(rtol=1e-6, atol=1e-7)  # card vs CPU: TE and stat columns
# the multihot path: its training feed (8 chunks of 7 full batches) and the
# loader's padded length of genres (1-4 ids a row)
MH_TRAIN_PARTS, MH_STEPS, MH_SPARSE_MAX = 8, 56, 4

# phases 18-19: the multi-GPU fit's exchange capacity (sharded_vocab.py:48),
# the ranks of phase 19's composition, and its row-sharded table's shards
CAPACITY_FACTOR, COMPOSE_RANKS, MODEL_SHARDS = 2.5, 4, 4
# phase 20: the padding of the sharded tables (a multiple of MODEL_SHARDS,
# so phase 21's shards are equal) and the steps held against the unsharded DLRM
SHARD_PAD, SHARD_PARITY_STEPS = 4, 8
# phase 23: K13b's self-interaction on phase 7's 27 features of dim 16, and
# xDeepFM's CIN in its Criteo setting (arXiv:1803.05170: 26 fields of dim 16,
# 200 feature maps a layer); layer 2 at a smaller batch (the plain version
# stores the [B, 200 * 26, 16] outer product)
SELF_FEATURES, CIN_FIELDS, CIN_DIM, CIN_MAPS, CIN_L2_BATCH = 27, 26, 16, 200, 8192

# bench.py:83-136: the Criteo 1TB click-log cardinalities, 16 x 256K rows
NUM_CATS, NUM_CONTS = 26, 13
ROWS_PER_PART, NUM_PARTS = 1 << 18, 16
CRITEO_TB_CARDINALITIES = [
    227605432, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 130229467,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 292775614,
    40790948, 187188510, 590152, 12973, 108, 36,
]


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def make_part(seed: int) -> dict:
    """One 256K-row partition, as bench.py:make_part builds it."""
    rng = np.random.default_rng(seed)
    cards = np.array(CRITEO_TB_CARDINALITIES, dtype=np.float64)[:, None]
    u = rng.random((NUM_CATS, ROWS_PER_PART))
    raw = (cards * u**2.5).astype(np.int64)
    ids = ((raw * np.int64(2654435761)) % np.int64(2**31)).astype(np.int32)
    data = {f"C{i}": ids[i] for i in range(NUM_CATS)}
    conts = rng.normal(1.0, 3.0, (NUM_CONTS, ROWS_PER_PART)).astype(np.float32)
    conts[rng.random((NUM_CONTS, ROWS_PER_PART)) < 0.05] = np.nan
    data.update({f"I{i}": conts[i] for i in range(NUM_CONTS)})
    data["label"] = rng.integers(0, 2, ROWS_PER_PART).astype(np.int32)
    return data


def make_compact_part(seed: int) -> dict:
    """4 compact-key columns of ~290K keys each over 1M rows: direct maps."""
    rng = np.random.default_rng(10_000 + seed)
    return {
        f"D{i}": (i * 1_000_000 + rng.integers(0, 300_000, ROWS_PER_PART)).astype(np.int32)
        for i in range(4)
    }


def make_movielens_part(seed: int) -> dict:
    """One partition as bench/movielens_bench.py:make_part draws it; the
    genres list column is its (values, int64 offsets) pair."""
    rng = np.random.default_rng(seed)
    rows = ML_ROWS_PER_PART
    users = rng.zipf(1.2, rows).clip(1, ML_USERS).astype(np.int64)
    movies = rng.zipf(1.1, rows).clip(1, ML_MOVIES).astype(np.int64)
    lengths = rng.integers(1, 5, rows)
    offsets = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return {
        "userId": users,
        "movieId": movies,
        "genres": (rng.integers(1, ML_GENRES + 1, int(offsets[-1])).astype(np.int64), offsets),
        "rating": (rng.integers(1, 11, rows) / 2.0).astype(np.float32),
        "ts_delta": rng.exponential(86400.0, rows).astype(np.float32),
    }


def movielens_table(nvt, part: dict, columns=None):
    """A partition as a TableBatch of ``columns`` (all by default)."""
    names = list(part) if columns is None else columns
    return nvt.TableBatch(
        {k: nvt.Column(*part[k]) if isinstance(part[k], tuple) else nvt.Column(part[k]) for k in names}
    )


def time_ms(fn, iters=TIMED_ITERS, repeats=REPEATS) -> float:
    """Median over ``repeats`` CUDA-event windows of the mean device time of
    ``iters`` back-to-back calls (the L2 cache is not flushed between calls).
    The card first runs ``fn`` for WARMUP_S, so its clocks have ramped up
    after the host-side phases that leave it idle. Each window starts behind
    a device-side sleep long enough for the host to enqueue all its calls:
    the events then time the device's work, not the host's launch rate (a
    wrapper's checks and ctypes call take longer than a 20 µs kernel)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARMUP_S:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return float(np.median(samples))


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_outputs(got, want, conts, what, tol=CPU_TOL):
    if got.column_names != want.column_names:
        fail(f"{what}: columns {got.column_names} != {want.column_names}")
    for name in want.column_names:
        g, w = got[name].values.cpu(), want[name].values
        if g.dtype != w.dtype:
            fail(f"{what}: {name} dtype {g.dtype} != {w.dtype}")
        if name in conts:
            if not torch.allclose(g, w, **tol):
                fail(f"{what}: {name} differs, max abs {float((g - w).abs().max())}")
        elif not torch.equal(g, w):
            fail(f"{what}: {name} codes differ in {int((g != w).sum())} rows")
        go, wo = got[name].offsets, want[name].offsets
        if (go is None) != (wo is None) or (wo is not None and not torch.equal(go.cpu(), wo)):
            fail(f"{what}: {name} list offsets differ")


def drive(nvt, wf, parts, conts, kernels_on_path, what):
    """Fit and transform every batch on the card with the launch counters
    zeroed just before; check the counters and one batch against the CPU."""
    from nvtabular_tpu_torch import kernels

    dataset = nvt.Dataset(parts)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    wf.fit(dataset)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [wf.transform(b) for b in dataset.to_batches()]
    torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name, count in launches.items():
        want = len(parts) if name in kernels_on_path else 0
        if count != want:
            fail(f"{what}: {name} launched {count} times, expected {want}")
    for out in outs:
        for name, col in out.columns.items():
            if col.device != torch.device(DEVICE) or col.values.shape[0] != ROWS_PER_PART:
                fail(f"{what}: output {name} has shape {tuple(col.values.shape)} on {col.device}")
            if col.values.is_floating_point() and not bool(torch.isfinite(col.values).all()):
                fail(f"{what}: output {name} holds non-finite values")
    return fit_s, first_pass_s, launches, outs


def check_against_cpu(nvt, make_graph, wf, batch, gpu_out, conts, what):
    cpu_wf = nvt.Workflow(make_graph(), device="cpu")
    nvt.load_fitted_state(cpu_wf, nvt.fitted_state(wf))
    compare_outputs(gpu_out, cpu_wf.transform(batch), conts, what)


def lookup_record(job, plain_fn, args, kernel_fn):
    """Kernel vs plain on the card: codes bit-identical; times; bytes."""
    got = kernel_fn()
    want = plain_fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{job['kind']} lookup kernel differs from plain in {int((got != want).sum())} codes")
    return {
        "max_abs_err": 0,
        "ms": time_ms(kernel_fn),
        "plain_ms": time_ms(lambda: plain_fn(*args)),
        "library_ms": None,
    }


def profile_pass(fn) -> dict:
    """Wall time of ``fn`` under torch.profiler and the device time it saw.

    Device time sums the device-side events only (kernels, copies, memsets),
    each once; ``top`` lists them by name. ``top_ops`` lists the host-side
    operators by the device time of the work they launched themselves: the
    ctypes kernels of this package launch outside any operator and appear
    only in ``top``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def ranked(on_device: bool):
        rows = [
            (e.key, e.self_device_time_total / 1e3, e.count)
            for e in events
            if (e.device_type == DeviceType.CUDA) == on_device and e.self_device_time_total > 0
        ]
        return sorted(rows, key=lambda r: -r[1])

    kernels, ops = ranked(True), ranked(False)
    device_ms = sum(r[1] for r in kernels)
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "top": [(k[:70], round(ms, 3), n) for k, ms, n in kernels[:10]],
        "top_ops": [(k[:40], round(ms, 3), n) for k, ms, n in ops[:12]],
    }


def step_grads(model, forward, batch, dz=None):
    """Logits, loss and every parameter's gradient of one batch: of the
    loss, or, given ``dz``, of the logits for the output gradient ``dz``."""
    from nvtabular_tpu_torch import models

    model.zero_grad(set_to_none=True)
    logits = forward(batch)
    loss = models.bce_with_logits(logits, batch["label"])
    if dz is None:
        loss.backward()
    else:
        logits.backward(dz)
    grads = [p.grad for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return logits.detach(), loss.detach(), grads


def check_step_parity(model, batch, reference, mlps, same_output_grad=False) -> dict:
    """One step's loss, logits and gradients through the kernels against the
    plain versions (``reference(model, batch)``) on the card, from the same
    state, in the trained bfloat16 compute and in float32 (set on ``mlps``).

    With ``same_output_grad`` both paths' gradients are taken for one output
    gradient, the plain path's dloss/dlogits: where a kernel sums the
    forward in another order (DeepFM's FM terms), each logit moves by an
    ULP or so of its partial sums, and a gradient that is a sum over the
    batch cancelling to a fraction of its terms (the output bias's) moves by
    far more than that relative to itself, though every term agrees. The
    logits themselves are held to the same limits either way."""
    from nvtabular_tpu_torch import models

    names = [name for name, _ in model.named_parameters()]
    errs = {}
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for mlp in mlps:
            mlp.compute_dtype = dtype
        p_logits, p_loss, p_grads = step_grads(model, lambda b: reference(model, b), batch)
        dz = None
        if same_output_grad:
            z = p_logits.clone().requires_grad_(True)
            (dz,) = torch.autograd.grad(models.bce_with_logits(z, batch["label"]), z)
            p_grads = step_grads(model, lambda b: reference(model, b), batch, dz)[2]
        k_logits, k_loss, k_grads = step_grads(model, model, batch, dz)
        loss_rtol, logit_atol, grad_rel = STEP_TOL[name]
        loss_err = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
        logit_err = float((k_logits - p_logits).abs().max())
        grad_errs = [
            float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30) for k, p in zip(k_grads, p_grads)
        ]
        worst = int(np.argmax(grad_errs))
        errs[name] = {"loss_rel": loss_err, "logits_abs": logit_err, "grads_rel_max": grad_errs[worst],
                      "worst_grad": names[worst], "table_grad_rel": grad_errs[0]}
        if not (loss_err <= loss_rtol and logit_err <= logit_atol and grad_errs[worst] <= grad_rel):
            fail(f"training step ({name}): kernels vs plain differ: {errs[name]} (limits {STEP_TOL[name]})")
        del k_grads, p_grads
    for mlp in mlps:
        mlp.compute_dtype = torch.bfloat16
    return errs


def train_path(nvt, wf, parts, cat_names, cont_names, profile: bool) -> dict:
    """Phase 7: ETL → DeviceLoader → DLRM training at full width."""
    from nvtabular_tpu_torch import kernels, models
    from nvtabular_tpu_torch.loader import DeviceLoader

    loader = DeviceLoader(
        wf.transform(nvt.Dataset(parts[:TRAIN_PARTS])), batch_size=TRAIN_BS, shuffle=True, seed=0,
        drop_last=True, cat_names=cat_names, cont_names=cont_names, label_names=["label"], device=DEVICE,
    )
    config = models.DLRMConfig.from_schema(wf.output_schema, embedding_dim=TRAIN_DIM)
    if (len(config.cardinalities), config.num_dense, config.interaction_dim) != (NUM_CATS, NUM_CONTS, 351):
        fail(f"train: unexpected DLRM config {len(config.cardinalities)} tables, {config.num_dense} dense")
    model = models.DLRM(config, seed=0, device=DEVICE)
    opt = models.Adagrad(model.parameters(), lr=1e-2)
    table_bytes = model.table.numel() * 4
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    staged = list(loader.chunks())
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    for chunk in staged:
        for name in cat_names:
            lo, hi = (int(v) for v in torch.aminmax(chunk[name]))
            if lo < 0 or hi >= config.cardinalities[name]:
                fail(f"train: {name} codes span [{lo}, {hi}], its table has {config.cardinalities[name]} rows")
    t0 = time.perf_counter()
    losses = [models.train_chunk(model, opt, staged[0], TRAIN_BS)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    pass_s = []
    i = 0
    for _ in range(TRAIN_REPEATS):
        steps = 0
        t0 = time.perf_counter()
        while steps < TRAIN_STEPS:
            losses.append(models.train_chunk(model, opt, staged[i % len(staged)], TRAIN_BS))
            steps += losses[-1].numel()
            i += 1
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)

    total_steps = sum(int(l.numel()) for l in losses)
    per_chunk = {"permute_rows", "tiny_lookup", "cuckoo_lookup", "cont_chain"}
    per_step = {"embedding_gather", "embedding_scatter_grad", "interaction_fwd", "interaction_bwd"}
    for name, count in launches.items():
        want = len(staged) if name in per_chunk else total_steps if name in per_step else 0
        if count != want:
            fail(f"train: {name} launched {count} times, expected {want}")
    all_losses = torch.cat(losses)
    if not bool(torch.isfinite(all_losses).all()):
        fail(f"train: non-finite losses {all_losses.tolist()}")
    step_s = float(np.median(pass_s)) / TRAIN_STEPS
    rec = {
        "stage_s": stage_s, "warm_chunk_s": warm_s, "pass_s": pass_s, "steps": total_steps,
        "steps_per_s": 1.0 / step_s, "examples_per_s": TRAIN_BS / step_s,
        "first_loss": float(all_losses[0]), "last_loss": float(all_losses[-1]),
        "table_rows": int(model.table.shape[0]), "table_bytes": table_bytes, "launches": launches,
        "chunks": len(staged), "chunk_rows": int(staged[0]["label"].shape[0]),
    }
    log(
        f"train: staged {len(staged)} chunks of {rec['chunk_rows']} rows in {stage_s:.3f} s; "
        f"{TRAIN_STEPS} steps of {TRAIN_BS}: median of {TRAIN_REPEATS} passes {rec['steps_per_s']:.2f} steps/s, "
        f"{rec['examples_per_s']:,.0f} examples/s (passes {[round(s, 4) for s in pass_s]} s); "
        f"loss {rec['first_loss']:.6f} -> {rec['last_loss']:.6f} over {total_steps} steps; "
        f"tables {rec['table_rows']} rows x {TRAIN_DIM} = {table_bytes:,} bytes; launches {launches}"
    )

    batch = {k: v[:TRAIN_BS] for k, v in staged[0].items()}
    rec["parity"] = check_step_parity(model, batch, models.reference_forward, [model.bottom, model.top])
    log(f"train: one step through the kernels equals the plain versions on the card: {rec['parity']}")
    if profile:

        def train_two_chunks():
            for c in staged[:2]:
                models.train_chunk(model, opt, c, TRAIN_BS)
            torch.cuda.synchronize()

        rec["profile"] = profile_pass(train_two_chunks)
        p = rec["profile"]
        log(f"profile train (8 steps): wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
            f"({p['busy_share']:.1%}), top device kernels {p['top']}, top operators {p['top_ops']}")

    # the step's two halves, timed apart on the device: forward + backward
    # (the gradient's allocation included), then the dense Adagrad update
    def fwd_bwd():
        opt.zero_grad()
        models.dlrm_loss(model, batch).backward()

    rec["fwd_bwd_ms"] = time_ms(fwd_bwd, iters=10)
    rec["adagrad_ms"] = time_ms(opt.step, iters=10)
    log(f"train: forward + backward {rec['fwd_bwd_ms']:.3f} ms, Adagrad update {rec['adagrad_ms']:.3f} ms "
        f"(device time per step; the timed passes' step was {1e3 * step_s:.3f} ms)")
    rec.update(model=model, staged=staged, loader=loader)
    return rec


def training_kernel_records(nvt, wf, parts, train) -> dict:
    """Phase 8: each kernel of the training path at its main-path shapes
    against its plain version on the card."""
    from nvtabular_tpu_torch.kernels import embedding as kemb
    from nvtabular_tpu_torch.kernels import interaction as kint
    from nvtabular_tpu_torch.kernels import permute as kperm

    records = {}
    model, loader = train["model"], train["loader"]
    dev = model.table.device

    # K14 on one unpermuted chunk, as the loader hands it over
    arrays = loader._device_arrays(wf.transform(parts[0]))
    n = arrays["label"].shape[0]
    perm = torch.randperm(n, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    got = kperm.permute_rows(arrays, perm)
    want = kperm.permute_rows_plain(arrays, perm)
    torch.cuda.synchronize()
    for k in arrays:
        if not torch.equal(got[k], want[k]):
            fail(f"permute_rows kernel differs from plain on {k}")
    row_bytes = sum(v[0].numel() * v.element_size() for v in arrays.values())
    rec = {
        "max_abs_err": 0, "shape": [len(arrays), n], "bytes": 2 * n * row_bytes + n * perm.element_size(),
        "ms": time_ms(lambda: kperm.permute_rows(arrays, perm)),
        "plain_ms": time_ms(lambda: kperm.permute_rows_plain(arrays, perm)),
        # 28 calls: one index_select per array
        "library_ms": time_ms(lambda: [torch.index_select(v, 0, perm) for v in arrays.values()]),
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], 0)
    records["permute_rows"] = rec
    del arrays, got, want

    # K13a on one training batch of the staged chunks
    batch = {k: v[:TRAIN_BS] for k, v in train["staged"][0].items()}
    ids = [batch[name] for name in model.names]
    table = model.table.detach()
    B, C, D = TRAIN_BS, len(ids), table.shape[1]
    feats = torch.empty((B, 1 + C, D), device=dev)
    out = feats[:, 1:]
    kemb.embedding_gather(table, ids, model.offsets, model.sizes, out=out)
    want = kemb.embedding_gather_plain(table, ids, model.offsets, model.sizes)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        fail("embedding_gather kernel differs from plain")
    flat = (torch.stack([v.long() for v in ids], dim=1) + torch.tensor(model.offsets, device=dev)).reshape(-1)
    distinct = int(torch.unique(flat).numel())
    rec = {
        "max_abs_err": 0, "shape": [B, C, D], "distinct_rows": distinct,
        "bytes": B * C * 4 + distinct * D * 4 + B * C * D * 4,
        "ms": time_ms(lambda: kemb.embedding_gather(table, ids, model.offsets, model.sizes, out=out)),
        "plain_ms": time_ms(lambda: kemb.embedding_gather_plain(table, ids, model.offsets, model.sizes)),
        "library_ms": time_ms(lambda: torch.index_select(table, 0, flat)),
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], 0)
    records["embedding_gather"] = rec

    grad_buf = torch.randn((B, 1 + C, D), device=dev, generator=torch.Generator(device=dev).manual_seed(2))
    grad = grad_buf[:, 1:]
    rows = table.shape[0]
    got = kemb.embedding_scatter_grad(grad, ids, model.offsets, model.sizes, rows)
    want = kemb.embedding_scatter_grad_plain(grad, ids, model.offsets, model.sizes, rows)
    # a hot row sums thousands of terms, in a varying order: allow 1e-5 of
    # the sum of their magnitudes (an element whose terms cancel may differ
    # by far more than 1e-5 of itself)
    magnitude = kemb.embedding_scatter_grad_plain(grad.abs(), ids, model.offsets, model.sizes, rows)
    torch.cuda.synchronize()
    if not bool(((got - want).abs() <= SUM_TOL["rtol"] * magnitude + SUM_TOL["atol"]).all()):
        fail(f"embedding_scatter_grad kernel differs from plain: max abs {float((got - want).abs().max())}")
    del magnitude
    grad_rows = grad.reshape(-1, D).contiguous()
    rec = {
        "max_abs_err": float((got - want).abs().max()), "shape": [B, C, D], "distinct_rows": distinct,
        "bytes": rows * D * 4 + B * C * 4 + B * C * D * 4,
        "ms": time_ms(lambda: kemb.embedding_scatter_grad(grad, ids, model.offsets, model.sizes, rows)),
        "plain_ms": time_ms(lambda: kemb.embedding_scatter_grad_plain(grad, ids, model.offsets, model.sizes, rows)),
        "library_ms": time_ms(lambda: torch.zeros((rows, D), device=dev).index_add_(0, flat, grad_rows)),
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], B * C * D)
    records["embedding_scatter_grad"] = rec
    # rows of a batch that land on the same table row (the atomics' contention)
    counts = torch.bincount(flat - flat.min())
    rec["hottest_row_hits"] = int(counts.max())
    del got, want, grad_rows, counts

    # K13b on that batch's features, into the top MLP's [B, D + P] input
    with torch.no_grad():
        feats[:, 0] = model.bottom(batch["dense"])
    x = feats
    F = 1 + C
    P = F * (F - 1) // 2
    top_in = torch.empty((B, D + P), device=dev)
    inter = top_in[:, D:]
    kint.interaction_fwd(x, out=inter)
    want = kint.interaction_fwd_plain(x)
    torch.cuda.synchronize()
    if not torch.allclose(inter, want, **SUM_TOL):
        fail(f"interaction_fwd kernel differs from plain: max abs {float((inter - want).abs().max())}")
    rec = {
        "max_abs_err": float((inter - want).abs().max()), "shape": [B, F, D], "bytes": B * F * D * 4 + B * P * 4,
        "ms": time_ms(lambda: kint.interaction_fwd(x, out=inter)),
        "plain_ms": time_ms(lambda: kint.interaction_fwd_plain(x)),
        # the full F x F product, not the triangle gather
        "library_ms": time_ms(lambda: torch.bmm(x, x.transpose(1, 2))),
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], 2 * B * P * D)
    records["interaction_fwd"] = rec

    gtop = torch.randn((B, D + P), device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    g = gtop[:, D:]
    got = kint.interaction_bwd(x, g)
    want = kint.interaction_bwd_plain(x, g)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, **SUM_TOL):
        fail(f"interaction_bwd kernel differs from plain: max abs {float((got - want).abs().max())}")
    rec = {
        "max_abs_err": float((got - want).abs().max()), "shape": [B, F, D],
        "bytes": 2 * B * F * D * 4 + B * P * 4,
        "ms": time_ms(lambda: kint.interaction_bwd(x, g)),
        "plain_ms": time_ms(lambda: kint.interaction_bwd_plain(x, g)), "library_ms": None,
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], 2 * B * F * (F - 1) * D)
    records["interaction_bwd"] = rec
    return records


def movielens_graph(ops):
    """BASELINE config 2 (bench/movielens_bench.py:73-85)."""
    te = ["userId", "movieId"] >> ops.TargetEncoding("rating", kfold=3, p_smooth=20)
    jg = ["movieId"] >> ops.JoinGroupby(cont_cols=["ts_delta"], stats=["mean", "count"])
    lam = ["ts_delta"] >> ops.LambdaOp(np.log1p) >> ops.Bucketize({"ts_delta": TS_BOUNDS})
    cross = ["userId", "movieId"] >> ops.HashedCross(10_000)
    return te + jg + lam + cross + ["rating"]


def check_launches(launches, want, what):
    for name, count in launches.items():
        if count != want.get(name, 0):
            fail(f"{what}: {name} launched {count} times, expected {want.get(name, 0)}")


def transform_all(wf, batches):
    for b in batches:
        wf.transform(b)
    torch.cuda.synchronize()


def transform_rates(wf, batches, rows_total):
    """rows/s of REPEATS passes over ``batches``, each ended by a
    synchronize, sorted; and the median over the passes of the host
    handoff's ms a batch (0 without a host op)."""
    ex = wf.executor
    out, handoff_ms = [], []
    for _ in range(REPEATS):
        h0, s0 = ex.host_handoffs, ex.host_handoff_seconds
        t0 = time.perf_counter()
        transform_all(wf, batches)
        out.append(rows_total / (time.perf_counter() - t0))
        handoff_ms.append(1e3 * (ex.host_handoff_seconds - s0) / max(ex.host_handoffs - h0, 1))
    return sorted(out), float(np.median(handoff_ms))


def movielens_path(nvt, dev, ml_parts, profile: bool) -> dict:
    """Phase 9: the advanced MovieLens workflow at ml-25m size, then its
    kernels at the path's shapes against their plain versions."""
    from nvtabular_tpu_torch import kernels, ops
    from nvtabular_tpu_torch.kernels import bucketize as kbkt
    from nvtabular_tpu_torch.kernels import groupby as kgb
    from nvtabular_tpu_torch.kernels import hash as khash
    from nvtabular_tpu_torch.ops.lookup import kind_of

    phase_t0 = time.perf_counter()
    # config 2 never reads the genres list column
    dataset = nvt.Dataset([movielens_table(nvt, p, ["userId", "movieId", "rating", "ts_delta"]) for p in ml_parts])
    batches = list(dataset.to_batches())  # each with its global row offset
    rows_total = ML_PARTS * ML_ROWS_PER_PART

    # fit: only the fold ids of TargetEncoding run a kernel, once a batch
    wf = nvt.Workflow(movielens_graph(ops), device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    wf.fit(dataset)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(kernels.LAUNCHES)
    check_launches(fit_launches, {"fold_ids": ML_PARTS}, "movielens fit")
    te = next(n for n in wf.graph.nodes if isinstance(n.op, ops.TargetEncoding))
    jg = next(n for n in wf.graph.nodes if isinstance(n.op, ops.JoinGroupby))
    keyed = {f"te:{t}": k for t, k in te.op.overall_stats.items()}
    keyed.update({f"join:{t}": k for t, k in jg.op.keyed.items()})
    groups = {name: k.num_groups for name, k in keyed.items()}
    index_kinds = [kind_of(k.lookup_struct()) for k in keyed.values()]
    if set(index_kinds) != {"direct"}:
        fail(f"movielens: expected direct-map group indexes (dense ids), got {index_kinds}")
    log(
        f"movielens: fit {fit_s:.2f} s (scan {wf.last_fit_stats['scan_seconds']:.2f} s, finalize "
        f"{wf.last_fit_stats['finalize_seconds']:.2f} s), groups {groups}, "
        f"TE fold groups {sum(k.num_groups for k in te.op.fold_stats.values())}, launches {fit_launches}"
    )

    # transform: per batch, one lookup per group index (TE's two, JoinGroupby's
    # one), one TE epilogue, one stat gather, one cross, one bucketize
    ex = wf.executor
    kernels.reset_launches()
    handoffs0 = ex.host_handoffs
    t0 = time.perf_counter()
    outs = [wf.transform(b) for b in batches]
    torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    per_batch = {"direct_lookup": len(index_kinds), "te_encode": 1, "stat_gather": 1, "hashed_cross": 1,
                 "bucketize": 1}
    check_launches(launches, {k: v * ML_PARTS for k, v in per_batch.items()}, "movielens transform")
    if ex.host_handoffs - handoffs0 != ML_PARTS:
        fail(f"movielens: {ex.host_handoffs - handoffs0} host handoffs over {ML_PARTS} batches, expected one each")
    floats = {"TE_userId_rating", "TE_movieId_rating", "movieId_ts_delta_mean", "rating"}
    for out in outs:
        for name, col in out.columns.items():
            if col.device != dev or col.values.shape[0] != ML_ROWS_PER_PART:
                fail(f"movielens: output {name} has shape {tuple(col.values.shape)} on {col.device}")
            if name in floats and not bool(torch.isfinite(col.values).all()):
                fail(f"movielens: output {name} holds non-finite values")
    buckets = torch.bincount(outs[0]["ts_delta"].values.long(), minlength=len(TS_BOUNDS) + 1).tolist()
    log(f"movielens: first transform pass {first_pass_s:.2f} s, launches {launches}, "
        f"columns {outs[0].column_names}, batch 0 bucket counts {buckets}")
    cpu_wf = nvt.Workflow(movielens_graph(ops), device="cpu")
    nvt.load_fitted_state(cpu_wf, nvt.fitted_state(wf))
    compare_outputs(outs[0], cpu_wf.transform(batches[0]), floats, "movielens vs cpu", ML_TOL)
    log("movielens: batch 0 equals the CPU run (codes, counts, cross and bucket ids exact, "
        "floats within rtol=1e-6, atol=1e-7)")
    del outs

    # throughput, and the UDF's host handoff (both copies and np.log1p)
    with_h2d_all, handoff_ms = transform_rates(wf, batches, rows_total)
    on_card = [ex.stage(b) for b in batches]
    torch.cuda.synchronize()
    without_h2d_all, handoff_card_ms = transform_rates(wf, on_card, rows_total)
    rec = {
        "fit_s": fit_s, "fit_stats": dict(wf.last_fit_stats), "groups": groups, "fit_launches": fit_launches,
        "first_pass_s": first_pass_s, "launches": launches, "rows": rows_total,
        "rows_per_s_with_h2d": with_h2d_all, "rows_per_s_without_h2d": without_h2d_all,
        "handoff_ms_per_batch": handoff_ms, "handoff_ms_per_batch_on_card": handoff_card_ms,
        "bucket_counts_batch0": buckets,
    }
    if profile:
        rec["profile"] = {
            "with_h2d": profile_pass(lambda: transform_all(wf, batches[:4])),
            "without_h2d": profile_pass(lambda: transform_all(wf, on_card[:4])),
        }
        for what, p in rec["profile"].items():
            log(f"profile movielens {what}: wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
                f"({p['busy_share']:.1%}), top device kernels {p['top']}, top operators {p['top_ops']}")
    log(
        f"movielens: transform median of {REPEATS} passes {float(np.median(with_h2d_all)):,.0f} rows/s "
        f"(min {with_h2d_all[0]:,.0f}, max {with_h2d_all[-1]:,.0f}) with the host-to-device copy, "
        f"{float(np.median(without_h2d_all)):,.0f} rows/s (min {without_h2d_all[0]:,.0f}, max "
        f"{without_h2d_all[-1]:,.0f}) from batches on the card; UDF host handoff {handoff_ms:.3f} ms a batch "
        f"({handoff_card_ms:.3f} ms from batches on the card)"
    )

    # the kernels at the path's shapes, on batch 0 as staged on the card
    staged = on_card[0]
    n = ML_ROWS_PER_PART
    records = {}

    def record(name, got, want, fn, plain_fn, nbytes, ops, library_fn=None, exact=True, **extra):
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            if exact and not torch.equal(g, w):
                fail(f"{name} kernel differs from plain in {int((g != w).sum())} entries")
            if not exact and not torch.allclose(g, w, **ML_TOL, equal_nan=True):
                fail(f"{name} kernel differs from plain: max abs {float((g - w).abs().max())}")
        err = max(float((g.double() - w.double()).abs().nan_to_num(0.0).max()) if g.numel() else 0.0
                  for g, w in pairs)
        rec = {"max_abs_err": err, "ms": time_ms(fn), "plain_ms": time_ms(plain_fn),
               "library_ms": None if library_fn is None else time_ms(library_fn), "bytes": nbytes, **extra}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
        records[name] = rec

    # K7: the cross of the two id columns, and the fold ids of one batch
    cols = [staged["movieId"].values, staged["userId"].values]
    record("hashed_cross", khash.hashed_cross(cols, 10_000), khash.hashed_cross_plain(cols, 10_000),
           lambda: khash.hashed_cross(cols, 10_000), lambda: khash.hashed_cross_plain(cols, 10_000),
           n * (8 + 8 + 4), n * 2 * 30, shape=[2, n])
    off = batches[-1].row_offset
    record("fold_ids", khash.fold_ids(off, n, 3, 42, dev), khash.fold_ids_plain(off, n, 3, 42, dev),
           lambda: khash.fold_ids(off, n, 3, 42, dev), lambda: khash.fold_ids_plain(off, n, 3, 42, dev),
           n * 4, n * 30, shape=[n], row_offset=off)

    # K10a: TargetEncoding's epilogue over its two group indexes; JoinGroupby's gathers
    state = ex.op_state(te.op, dev)
    gidx = torch.stack([state["index"][t](staged[t]) for t in state["tags"]])
    st = state["te"]
    G, T = gidx.shape[0], st.means.shape[0]
    fold = khash.fold_ids(0, n, st.kfold, st.fold_seed, dev).long()
    touched = sum(
        int(torch.unique(gidx[g]).numel()) + int(torch.unique(fold * int(st.strides[g]) + gidx[g]).numel())
        for g in range(G)
    )
    record("te_encode", kgb.te_encode(gidx, st, 0), kgb.te_encode_plain(gidx, st, 0),
           lambda: kgb.te_encode(gidx, st, 0), lambda: kgb.te_encode_plain(gidx, st, 0),
           G * n * 4 + G * T * n * 4 + touched * T * 8, G * T * n * 10 + G * n * 30, exact=False,
           shape=[G, n], stat_entries_touched=touched * T * 2)
    jstate = ex.op_state(jg.op, dev)
    jidx = torch.stack([jstate["index"][t](staged[t]) for t in jstate["names"]])
    gs = jstate["gather"]
    K = int(gs.groups.shape[0])
    distinct = int(torch.unique(jidx).numel())
    ioff, foff = int(gs.offs[0]), int(gs.offs[gs.ki])
    record("stat_gather", kgb.stat_gather(jidx, gs), kgb.stat_gather_plain(jidx, gs),
           lambda: kgb.stat_gather(jidx, gs), lambda: kgb.stat_gather_plain(jidx, gs),
           n * 4 + K * n * 4 + K * distinct * 4, 0,
           # two calls: one index_select per output column
           library_fn=lambda: (torch.index_select(gs.itable[ioff:], 0, jidx[0]),
                               torch.index_select(gs.ftable[foff:], 0, jidx[0])),
           shape=[K, n], distinct_groups=distinct)

    # K12b on raw ts_delta, where all six buckets fill, with values on the
    # boundaries and NaN
    x = staged["ts_delta"].values.clone()
    bounds = torch.tensor(TS_BOUNDS, dtype=torch.float32, device=dev)
    x[: len(TS_BOUNDS)] = bounds
    x[len(TS_BOUNDS)] = float("nan")
    got = kbkt.bucketize(x, bounds)
    if set(torch.unique(got).tolist()) != set(range(len(TS_BOUNDS) + 1)):
        fail(f"bucketize: raw ts_delta fills buckets {torch.unique(got).tolist()}, not all six")
    record("bucketize", got, kbkt.bucketize_plain(x, bounds), lambda: kbkt.bucketize(x, bounds),
           lambda: kbkt.bucketize_plain(x, bounds), n * 8 + len(TS_BOUNDS) * 4,
           n * math.ceil(math.log2(len(TS_BOUNDS) + 1)), library_fn=lambda: torch.bucketize(x, bounds, right=True),
           shape=[n])
    rec["kernels"] = records
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"movielens: phase 9 took {rec['phase_s']:.1f} s")
    return rec


def binarize_rating(col):
    """The getting-started ETL's label: rating > 3."""
    return (np.asarray(col) > 3).astype(np.float32)


def config1_graph(ops):
    """BASELINE config 1 (bench/movielens_bench.py:62-70), its rating
    binarized."""
    cats = ["userId", "movieId", "genres"] >> ops.Categorify()
    conts = ["ts_delta"] >> ops.LogOp() >> ops.Normalize()
    return cats + conts + (["rating"] >> ops.LambdaOp(binarize_rating))


def multihot_train(nvt, wf, batches, profile: bool) -> dict:
    """Phase 10's training: the transform of the first MH_TRAIN_PARTS
    partitions through DeviceLoader(sparse_max) into the tabular MLP."""
    from nvtabular_tpu_torch import kernels, models, ops
    from nvtabular_tpu_torch.loader import DeviceLoader

    cat_names = ["userId", "movieId", "genres"]
    loader = DeviceLoader(
        wf.transform(nvt.Dataset(batches[:MH_TRAIN_PARTS])), batch_size=TRAIN_BS, shuffle=True, seed=0,
        drop_last=True, sparse_max={"genres": MH_SPARSE_MAX}, cat_names=cat_names, cont_names=["ts_delta"],
        label_names=["rating"], device=DEVICE,
    )
    single, multi = ops.get_embedding_sizes(wf)
    config = models.TabularMLPConfig(embedding_sizes=single, num_continuous=1, multihot_embedding_sizes=multi)
    if multi != {"genres": (ML_GENRES + 3, 16)} or config.input_dim != 1041:
        fail(f"multihot: unexpected embedding sizes {single}, {multi} (MLP input {config.input_dim})")
    model = models.TabularMLP(config, seed=0, device=DEVICE)
    opt = models.Adagrad(model.parameters(), lr=1e-2)
    cards = {**{k: v[0] for k, v in single.items()}, **{k: v[0] for k, v in multi.items()}}
    torch.cuda.synchronize()

    kernels.reset_launches()
    handoffs0 = wf.executor.host_handoffs
    t0 = time.perf_counter()
    staged = list(loader.chunks())
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    for chunk in staged:
        chunk["continuous"] = chunk.pop("dense")  # the tabular MLP's name for the dense features
        for name in cat_names:
            codes = chunk[f"{name}__values" if name in multi else name]
            lo, hi = (int(v) for v in torch.aminmax(codes))
            if lo < 0 or hi >= cards[name]:
                fail(f"multihot train: {name} codes span [{lo}, {hi}], its table has {cards[name]} rows")
    t0 = time.perf_counter()
    losses = [models.train_chunk(model, opt, staged[0], TRAIN_BS, models.tabular_mlp_loss)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    pass_s = []
    i = 0
    for _ in range(TRAIN_REPEATS):
        steps = 0
        t0 = time.perf_counter()
        while steps < MH_STEPS:
            losses.append(models.train_chunk(model, opt, staged[i % len(staged)], TRAIN_BS, models.tabular_mlp_loss))
            steps += losses[-1].numel()
            i += 1
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)

    total_steps = sum(int(l.numel()) for l in losses)
    per_chunk = {"direct_lookup", "tiny_lookup", "cont_chain", "ragged_to_padded", "permute_rows"}
    # a gather and a scatter per id table, a bag and its gradient per step
    per_step = {"embedding_gather": len(model.tables), "embedding_scatter_grad": len(model.tables),
                "embedding_bag_fwd": 1, "embedding_bag_bwd": 1}
    check_launches(launches, {**{k: len(staged) for k in per_chunk},
                              **{k: n * total_steps for k, n in per_step.items()}}, "multihot train")
    if wf.executor.host_handoffs - handoffs0 != len(staged):
        fail(f"multihot train: {wf.executor.host_handoffs - handoffs0} host handoffs for {len(staged)} chunks")
    all_losses = torch.cat(losses)
    if not bool(torch.isfinite(all_losses).all()):
        fail(f"multihot train: non-finite losses {all_losses.tolist()}")
    step_s = float(np.median(pass_s)) / MH_STEPS
    table_bytes = sum(p.numel() * 4 for p in [*model.tables, *model.mh_tables])
    rec = {
        "stage_s": stage_s, "warm_chunk_s": warm_s, "pass_s": pass_s, "steps": total_steps,
        "steps_per_s": 1.0 / step_s, "examples_per_s": TRAIN_BS / step_s,
        "first_loss": float(all_losses[0]), "last_loss": float(all_losses[-1]), "launches": launches,
        "chunks": len(staged), "chunk_rows": int(staged[0]["label"].shape[0]),
        "embedding_sizes": {"single": single, "multihot": multi}, "table_bytes": table_bytes,
    }
    log(
        f"multihot train: staged {len(staged)} chunks of {rec['chunk_rows']} rows in {stage_s:.3f} s; "
        f"{MH_STEPS} steps of {TRAIN_BS}: median of {TRAIN_REPEATS} passes {rec['steps_per_s']:.2f} steps/s, "
        f"{rec['examples_per_s']:,.0f} examples/s (passes {[round(s, 4) for s in pass_s]} s); "
        f"loss {rec['first_loss']:.6f} -> {rec['last_loss']:.6f} over {total_steps} steps; "
        f"tables {single} + {multi} = {table_bytes:,} bytes; launches {launches}"
    )

    batch = {k: v[:TRAIN_BS] for k, v in staged[0].items()}
    rec["parity"] = check_step_parity(model, batch, models.tabular_reference_forward, [model.mlp])
    log(f"multihot train: one step through the kernels equals the plain versions on the card: {rec['parity']}")
    if profile:

        def train_two_chunks():
            for c in staged[:2]:
                models.train_chunk(model, opt, c, TRAIN_BS, models.tabular_mlp_loss)
            torch.cuda.synchronize()

        rec["profile"] = profile_pass(train_two_chunks)
        p = rec["profile"]
        log(f"profile multihot train (14 steps): wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
            f"({p['busy_share']:.1%}), top device kernels {p['top']}, top operators {p['top_ops']}")

    def fwd_bwd():
        opt.zero_grad()
        models.tabular_mlp_loss(model, batch).backward()

    rec["fwd_bwd_ms"] = time_ms(fwd_bwd, iters=10)
    rec["adagrad_ms"] = time_ms(opt.step, iters=10)
    log(f"multihot train: forward + backward {rec['fwd_bwd_ms']:.3f} ms, Adagrad update {rec['adagrad_ms']:.3f} ms "
        f"(device time per step; the timed passes' step was {1e3 * step_s:.3f} ms)")
    rec.update(model=model, batch=batch, loader=loader)
    return rec


def multihot_path(nvt, dev, ml_parts, profile: bool) -> dict:
    """Phase 10: the MovieLens multihot path at ml-25m size — fit, device
    transform, training and ListSlice."""
    from nvtabular_tpu_torch import kernels, ops

    phase_t0 = time.perf_counter()
    dataset = nvt.Dataset([movielens_table(nvt, p) for p in ml_parts])
    batches = list(dataset.to_batches())
    rows_total = ML_PARTS * ML_ROWS_PER_PART

    wf = nvt.Workflow(config1_graph(ops), device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    wf.fit(dataset)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check_launches(dict(kernels.LAUNCHES), {}, "multihot fit")  # the fit counts on the card with torch.unique
    cat = next(n.op for n in wf.graph.nodes if isinstance(n.op, ops.Categorify))
    kinds = {k: sorted(row_index) for k, (_, row_index) in cat._get_batched().items()}
    if kinds != {"direct": ["movieId", "userId"], "tiny": ["genres"]}:
        fail(f"multihot: expected direct maps for the ids and a tiny table for genres, got {kinds}")
    log(f"multihot: fit {fit_s:.2f} s (scan {wf.last_fit_stats['scan_seconds']:.2f} s, finalize "
        f"{wf.last_fit_stats['finalize_seconds']:.2f} s), vocabularies "
        f"{ {k: len(v.values_by_code) for k, v in cat.vocabs.items()} }, tables {kinds}")

    # transform: per batch one direct lookup (both ids), one tiny lookup (the
    # genres' flat values), one continuous chain, one host handoff (the label)
    ex = wf.executor
    kernels.reset_launches()
    handoffs0 = ex.host_handoffs
    t0 = time.perf_counter()
    outs = [wf.transform(b) for b in batches]
    torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, {"direct_lookup": ML_PARTS, "tiny_lookup": ML_PARTS, "cont_chain": ML_PARTS},
                   "multihot transform")
    if ex.host_handoffs - handoffs0 != ML_PARTS:
        fail(f"multihot: {ex.host_handoffs - handoffs0} host handoffs over {ML_PARTS} batches, expected one each")
    genre_card = ML_GENRES + 3
    for b, out in zip(batches, outs):
        for name, col in out.columns.items():
            if col.device != dev or len(col) != ML_ROWS_PER_PART:
                fail(f"multihot: output {name} has {len(col)} rows on {col.device}")
        g = out["genres"]
        if not torch.equal(g.offsets.cpu(), b["genres"].offsets) or int(g.values.max()) >= genre_card:
            fail(f"multihot: genres codes reach {int(g.values.max())} (table of {genre_card}) or lost their offsets")
        if not bool(torch.isfinite(out["ts_delta"].values).all()):
            fail("multihot: ts_delta holds non-finite values")
    cpu_wf = nvt.Workflow(config1_graph(ops), device="cpu")
    nvt.load_fitted_state(cpu_wf, nvt.fitted_state(wf))
    compare_outputs(outs[0], cpu_wf.transform(batches[0]), {"ts_delta"}, "multihot vs cpu")
    log(f"multihot: first transform pass {first_pass_s:.2f} s, launches {launches}; batch 0 equals the CPU run "
        f"(codes, genres offsets and labels exact, ts_delta within rtol=1e-5, atol=1e-5)")

    with_h2d_all, handoff_ms = transform_rates(wf, batches, rows_total)
    on_card = [ex.stage(b) for b in batches]
    torch.cuda.synchronize()
    without_h2d_all, handoff_card_ms = transform_rates(wf, on_card, rows_total)
    del on_card
    log(
        f"multihot: transform median of {REPEATS} passes {float(np.median(with_h2d_all)):,.0f} rows/s "
        f"(min {with_h2d_all[0]:,.0f}, max {with_h2d_all[-1]:,.0f}) with the host-to-device copy, "
        f"{float(np.median(without_h2d_all)):,.0f} rows/s (min {without_h2d_all[0]:,.0f}, max "
        f"{without_h2d_all[-1]:,.0f}) from batches on the card; label handoff {handoff_ms:.3f} ms a batch "
        f"({handoff_card_ms:.3f} ms from batches on the card)"
    )
    rec = {
        "fit_s": fit_s, "fit_stats": dict(wf.last_fit_stats), "first_pass_s": first_pass_s, "launches": launches,
        "rows": rows_total, "rows_per_s_with_h2d": with_h2d_all, "rows_per_s_without_h2d": without_h2d_all,
        "handoff_ms_per_batch": handoff_ms, "handoff_ms_per_batch_on_card": handoff_card_ms,
    }
    rec["train"] = multihot_train(nvt, wf, batches, profile)

    # ListSlice(0, 3, pad=True) of the genres codes: K11's slice once a batch
    def slice_graph():
        return ["genres"] >> ops.Categorify() >> ops.ListSlice(0, 3, pad=True)

    genres = nvt.Dataset([movielens_table(nvt, p, ["genres"]) for p in ml_parts])
    swf = nvt.Workflow(slice_graph(), device=dev)
    swf.fit(genres)
    kernels.reset_launches()
    t0 = time.perf_counter()
    souts = [swf.transform(b) for b in genres.to_batches()]
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    rec["slice_launches"] = dict(kernels.LAUNCHES)
    check_launches(rec["slice_launches"], {"tiny_lookup": ML_PARTS, "ragged_slice_padded": ML_PARTS}, "list slice")
    width = 3 * ML_ROWS_PER_PART
    if any(o["genres"].values.shape[0] != width or int(o["genres"].offsets[-1]) != width for o in souts):
        fail("list slice: a batch's genres are not 3 padded slots a row")
    cpu_swf = nvt.Workflow(slice_graph(), device="cpu")
    nvt.load_fitted_state(cpu_swf, nvt.fitted_state(swf))
    compare_outputs(souts[0], cpu_swf.transform(next(genres.to_batches())), set(), "list slice vs cpu")
    log(f"multihot: ListSlice(0, 3, pad=True) over {ML_PARTS} batches in {slice_s:.2f} s, launches "
        f"{rec['slice_launches']}; batch 0 equals the CPU run")
    rec["genres_batch0"] = outs[0]["genres"]
    rec["schema"] = wf.output_schema
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"multihot: phase 10 took {rec['phase_s']:.1f} s")
    return rec


def multihot_kernel_records(mh: dict) -> dict:
    """Phase 11: K11 and K13c at phase 10's shapes against their plain
    versions on the card, timed beside their bounds and library calls."""
    from nvtabular_tpu_torch.kernels import embedding_bag as kbag
    from nvtabular_tpu_torch.kernels import ragged as kragged

    records = {}

    def record(name, got, want, fn, plain_fn, nbytes, ops, library_fn=None, **extra):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                fail(f"{name} kernel differs from plain in {int((g != w).sum())} entries")
        rec = {"max_abs_err": 0, "ms": time_ms(fn), "plain_ms": time_ms(plain_fn),
               "library_ms": None if library_fn is None else time_ms(library_fn), "bytes": nbytes, **extra}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
        records[name] = rec

    # K11 on batch 0's genres codes as Categorify leaves them on the card
    genres = mh["genres_batch0"]
    values, offsets = genres.values, genres.offsets
    R, L = offsets.shape[0] - 1, MH_SPARSE_MAX
    lengths = offsets[1:] - offsets[:-1]
    read = int(lengths.clamp(max=L).sum())
    record("ragged_to_padded", kragged.ragged_to_padded(values, offsets, L),
           kragged.ragged_to_padded_plain(values, offsets, L),
           lambda: kragged.ragged_to_padded(values, offsets, L), lambda: kragged.ragged_to_padded_plain(values, offsets, L),
           (R + 1) * 8 + read * 4 + R * L * 8, 0,
           # the padded values alone (no mask), on the same bits viewed as float32
           library_fn=lambda: torch.ops.aten._jagged_to_padded_dense_forward(
               values.view(torch.float32)[:, None], [offsets], [L], 0.0),
           shape=[R, L], values=int(values.shape[0]))
    got = kragged.ragged_slice_padded(values, offsets, 0, 3, 3)
    sliced = int(got[1].sum())
    record("ragged_slice_padded", got, kragged.ragged_slice_padded_plain(values, offsets, 0, 3, 3),
           lambda: kragged.ragged_slice_padded(values, offsets, 0, 3, 3),
           lambda: kragged.ragged_slice_padded_plain(values, offsets, 0, 3, 3),
           (R + 1) * 8 + sliced * 4 + R * 3 * 4 + R * 8, 0,
           # the padded values alone (no lengths): slice (0, 3) is the first 3 of each row
           library_fn=lambda: torch.ops.aten._jagged_to_padded_dense_forward(
               values.view(torch.float32)[:, None], [offsets], [3], 0.0),
           shape=[R, 3], values=int(values.shape[0]))

    # K13c on a training batch's padded genres, its output and gradient a
    # slot of the MLP's [B, 1044] input, as the model passes them
    model, batch = mh["train"]["model"], mh["train"]["batch"]
    table = model.mh_tables[0].detach()
    ids, mask = batch["genres__values"], batch["genres__mask"]
    (B, L), (V, D) = ids.shape, table.shape
    start = model.layout.bags[0][2]
    buf = torch.empty((B, model.layout.width), device=table.device)
    out = buf[:, start : start + D]
    kbag.embedding_bag_fwd(table, ids, mask, out=out)
    cnt = mask.sum(1, keepdim=True).clamp(min=1.0)
    weights = (mask / cnt).contiguous()
    distinct = int(torch.unique(ids).numel())
    record("embedding_bag_fwd", (out,), (kbag.embedding_bag_fwd_plain(table, ids, mask),),
           lambda: kbag.embedding_bag_fwd(table, ids, mask, out=out),
           lambda: kbag.embedding_bag_fwd_plain(table, ids, mask),
           B * L * 8 + distinct * D * 4 + B * D * 4, B * L * D * 2 + B * D,
           library_fn=lambda: torch.nn.functional.embedding_bag(ids, table, per_sample_weights=weights, mode="sum"),
           shape=[B, L, V, D], distinct_rows=distinct)

    gbuf = torch.randn((B, model.layout.width), device=table.device,
                       generator=torch.Generator(device=table.device).manual_seed(4))
    grad = gbuf[:, start : start + D]
    got = kbag.embedding_bag_bwd(grad, ids, mask, V)
    want = kbag.range_bag_grad_plain(grad, ids, mask, 0, V, V)
    magnitude = kbag.range_bag_grad_plain(grad.abs(), ids, mask, 0, V, V)
    torch.cuda.synchronize()
    # 65,536 x 4 terms on 23 rows, summed in a varying order: 1e-5 of the
    # sum of their magnitudes, as for K13a's scatter
    if not bool(((got - want).abs() <= SUM_TOL["rtol"] * magnitude + SUM_TOL["atol"]).all()):
        fail(f"embedding_bag_bwd kernel differs from plain: max abs {float((got - want).abs().max())}")
    terms = ((grad / cnt)[:, None, :] * mask[..., None]).reshape(-1, D).contiguous()
    flat = ids.reshape(-1).long()
    rec = {
        "max_abs_err": float((got - want).abs().max()), "shape": [B, L, V, D],
        "bytes": B * L * 8 + B * D * 4 + V * D * 4,
        "ms": time_ms(lambda: kbag.embedding_bag_bwd(grad, ids, mask, V)),
        "plain_ms": time_ms(lambda: kbag.range_bag_grad_plain(grad, ids, mask, 0, V, V)),
        # the terms precomputed outside the timing
        "library_ms": time_ms(lambda: torch.zeros((V, D), device=table.device).index_add_(0, flat, terms)),
        "hottest_row_hits": int(torch.bincount(flat[mask.reshape(-1) > 0]).max()),
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], B * L * D * 2 + B * D)
    records["embedding_bag_bwd"] = rec
    return records


def crossed_graph(ops):
    """Crossed features on Criteo's low-cardinality fields: multi-column
    TargetEncoding and JoinGroupby groups, combo Categorify, and HashBucket on
    the three largest fields (the hashing trick in place of a vocabulary)."""
    te = [["C5", "C8"], ["C12", "C16", "C18"], ["C15", "C24"]] >> ops.TargetEncoding("label", kfold=5, p_smooth=20)
    jg = [["C5", "C8"], ["C15", "C24"]] >> ops.JoinGroupby(cont_cols=["I0"], stats=["count", "mean"])
    combo = [["C8", "C15"], ["C12", "C25"]] >> ops.Categorify(encode_type="combo")
    hb = ["C0", "C9", "C19"] >> ops.HashBucket(10_000_000)
    return te + jg + combo + hb + ["label"]


CROSSED_COLUMNS = ["C0", "C5", "C8", "C9", "C12", "C15", "C16", "C18", "C19", "C24", "C25", "I0", "label"]


@contextlib.contextmanager
def plain_calls_on_card(what: str):
    """Fail if any kernel module's plain version is called with a tensor on
    the card inside the block: the path must launch the kernels."""
    from nvtabular_tpu_torch import kernels

    calls, saved = [], []

    def on_card(args):
        for a in args:
            if isinstance(a, (list, tuple)) and on_card(a):
                return True
            if isinstance(a, torch.Tensor) and a.is_cuda:
                return True
        return False

    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"nvtabular_tpu_torch.kernels.{info.name}")
        for attr, fn in list(vars(mod).items()):
            if attr.endswith("_plain") and callable(fn):
                def spy(*a, _fn=fn, _attr=attr, **k):
                    if on_card(list(a) + list(k.values())):
                        calls.append(_attr)
                    return _fn(*a, **k)

                saved.append((mod, attr, fn))
                setattr(mod, attr, spy)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    if calls:
        fail(f"{what}: plain versions ran on the card: {sorted(set(calls))}")


def nan_equal(got, want) -> bool:
    """Equal, NaN where NaN (a NaN's bits may differ)."""
    return got.shape == want.shape and bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


def crossed_path(nvt, dev, parts, profile: bool) -> dict:
    """Phase 12: the crossed-feature workflow on phase 3's partitions."""
    from nvtabular_tpu_torch import kernels, ops
    from nvtabular_tpu_torch.ops.lookup import kind_of

    phase_t0 = time.perf_counter()
    dataset = nvt.Dataset([nvt.TableBatch({c: p[c] for c in CROSSED_COLUMNS}) for p in parts])
    batches = list(dataset.to_batches())
    rows_total = NUM_PARTS * ROWS_PER_PART

    # fit: TargetEncoding's fold ids are its one kernel, once a batch
    wf = nvt.Workflow(crossed_graph(ops), device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_calls_on_card("crossed fit"):
        wf.fit(dataset)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(kernels.LAUNCHES)
    check_launches(fit_launches, {"fold_ids": NUM_PARTS}, "crossed fit")
    te = next(n.op for n in wf.graph.nodes if isinstance(n.op, ops.TargetEncoding))
    jg = next(n.op for n in wf.graph.nodes if isinstance(n.op, ops.JoinGroupby))
    cat = next(n.op for n in wf.graph.nodes if isinstance(n.op, ops.Categorify))
    # every group's verified hash pair, built on the host: raises on a
    # collision among the fitted tuples' h1
    pairs = {f"te:{t}": k.hashed_lookup_struct() for t, k in te.overall_stats.items()}
    pairs.update({f"join:{t}": k.hashed_lookup_struct() for t, k in jg.keyed.items()})
    pairs.update({f"combo:{t}": v.lookup_struct() for t, v in cat.vocabs.items()})
    groups = {name: len(pair[1]) - 1 for name, pair in pairs.items()}
    kinds = {name: kind_of(pair[0]) for name, pair in pairs.items()}
    want_kinds = {"te:C5_C8": "tiny", "te:C12_C16_C18": "cuckoo", "te:C15_C24": "cuckoo", "join:C5_C8": "tiny",
                  "join:C15_C24": "cuckoo", "combo:C8_C15": "cuckoo", "combo:C12_C25": "tiny"}
    if kinds != want_kinds:
        fail(f"crossed: h1 tables {kinds}, expected {want_kinds}")
    log(
        f"crossed: fit {fit_s:.2f} s (scan {wf.last_fit_stats['scan_seconds']:.2f} s, finalize "
        f"{wf.last_fit_stats['finalize_seconds']:.2f} s), fitted tuples {groups} (no h1 collision), h1 tables "
        f"{kinds}, launches {fit_launches}"
    )

    # transform: per group a hash pair, a probe of h1 and a verify (TE 3, JoinGroupby
    # 2, combo 2); one TE epilogue, one stat gather, a HashBucket column each
    ex = wf.executor
    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_calls_on_card("crossed transform"):
        outs = [wf.transform(b) for b in batches]
        torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    kinds_list = list(kinds.values())
    per_batch = {"hash_pair": 7, "hash_pair_verify": 7, "tiny_lookup": kinds_list.count("tiny"),
                 "cuckoo_lookup": kinds_list.count("cuckoo"), "te_encode": 1, "stat_gather": 1, "hashed_cross": 3}
    check_launches(launches, {k: v * NUM_PARTS for k, v in per_batch.items()}, "crossed transform")
    te_cols = ["TE_C5_C8_label", "TE_C12_C16_C18_label", "TE_C15_C24_label"]
    stat_cols = ["C5_C8_I0_mean", "C15_C24_I0_mean"]
    cards = {"C8_C15": cat.vocabs["C8_C15"].size, "C12_C25": cat.vocabs["C12_C25"].size}
    for out in outs:
        for name, col in out.columns.items():
            if col.device != dev or col.values.shape[0] != ROWS_PER_PART:
                fail(f"crossed: output {name} has shape {tuple(col.values.shape)} on {col.device}")
        for name in te_cols:
            if not bool(torch.isfinite(out[name].values).all()):
                fail(f"crossed: {name} holds non-finite values")
        for name, card in cards.items():
            lo, hi = (int(v) for v in torch.aminmax(out[name].values))
            if lo < 3 or hi >= card:  # every tuple of the fitted data is in the vocabulary
                fail(f"crossed: {name} codes span [{lo}, {hi}], vocabulary size {card}")
        for name in ("C0", "C9", "C19"):
            lo, hi = (int(v) for v in torch.aminmax(out[name].values))
            if lo < 0 or hi >= 10_000_000:
                fail(f"crossed: {name} buckets span [{lo}, {hi}]")
    log(f"crossed: first transform pass {first_pass_s:.2f} s, launches {launches} (no plain version on the card "
        f"in the fit or the transform), columns {outs[0].column_names}")
    cpu_wf = nvt.Workflow(crossed_graph(ops), device="cpu")
    nvt.load_fitted_state(cpu_wf, nvt.fitted_state(wf))
    compare_outputs(outs[0], cpu_wf.transform(batches[0]), set(te_cols + stat_cols), "crossed vs cpu",
                    dict(ML_TOL, equal_nan=True))
    log("crossed: batch 0 equals the CPU run (group counts, combo codes and bucket ids exact, TE and stat "
        "columns within rtol=1e-6, atol=1e-7)")
    del outs

    with_h2d_all, _ = transform_rates(wf, batches, rows_total)
    on_card = [ex.stage(b) for b in batches]
    torch.cuda.synchronize()
    without_h2d_all, _ = transform_rates(wf, on_card, rows_total)
    rec = {
        "fit_s": fit_s, "fit_stats": dict(wf.last_fit_stats), "fitted_tuples": groups, "h1_tables": kinds,
        "fit_launches": fit_launches, "first_pass_s": first_pass_s, "launches": launches, "rows": rows_total,
        "rows_per_s_with_h2d": with_h2d_all, "rows_per_s_without_h2d": without_h2d_all,
    }
    if profile:
        rec["profile"] = {
            "with_h2d": profile_pass(lambda: transform_all(wf, batches[:4])),
            "without_h2d": profile_pass(lambda: transform_all(wf, on_card[:4])),
        }
        for what, p in rec["profile"].items():
            log(f"profile crossed {what}: wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
                f"({p['busy_share']:.1%}), top device kernels {p['top']}, top operators {p['top_ops']}")
    log(
        f"crossed: transform median of {REPEATS} passes {float(np.median(with_h2d_all)):,.0f} rows/s "
        f"(min {with_h2d_all[0]:,.0f}, max {with_h2d_all[-1]:,.0f}) with the host-to-device copy, "
        f"{float(np.median(without_h2d_all)):,.0f} rows/s (min {without_h2d_all[0]:,.0f}, max "
        f"{without_h2d_all[-1]:,.0f}) from batches on the card"
    )
    rec.update(wf=wf, staged=on_card[0], te=te, cat=cat)
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"crossed: phase 12 took {rec['phase_s']:.1f} s")
    return rec


def sessions_graph(ops):
    """Each rating's change from the user's previous rating and to the next."""
    diffs = ["rating", "ts_delta"] >> ops.DifferenceLag("userId", shift=[1, -1])
    return diffs + ["userId"]


def sessions_path(nvt, dev, ml_parts, profile: bool) -> dict:
    """Phase 13: DifferenceLag over phase 9's partitions, each stably sorted
    by userId as ml-25m's ratings.csv is ordered by user."""
    from nvtabular_tpu_torch import kernels, ops

    phase_t0 = time.perf_counter()
    tables = []
    for p in ml_parts:
        order = np.argsort(p["userId"], kind="stable")
        tables.append(nvt.TableBatch({k: nvt.Column(p[k][order]) for k in ("userId", "rating", "ts_delta")}))
    dataset = nvt.Dataset(tables)
    batches = list(dataset.to_batches())
    rows_total = ML_PARTS * ML_ROWS_PER_PART
    wf = nvt.Workflow(sessions_graph(ops), device=dev)
    wf.fit(dataset)  # no statistics: builds the schema
    ex = wf.executor
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_calls_on_card("sessions transform"):
        outs = [wf.transform(b) for b in batches]
        torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, {"difference_lag": ML_PARTS}, "sessions transform")
    names = ["rating_difference_lag_1", "ts_delta_difference_lag_1", "rating_difference_lag_-1",
             "ts_delta_difference_lag_-1", "userId"]
    nan_share = {}
    for out in outs:
        if out.column_names != names:
            fail(f"sessions: columns {out.column_names}, expected {names}")
        for name in names[:4]:
            col = out[name].values
            if col.device != dev or col.shape[0] != ML_ROWS_PER_PART or col.dtype != torch.float32:
                fail(f"sessions: output {name} has shape {tuple(col.shape)} {col.dtype} on {col.device}")
        # a lag is NaN exactly where the previous row is another user's (no NaN in the inputs)
        first = torch.ones(ML_ROWS_PER_PART, dtype=torch.bool, device=dev)
        uid = out["userId"].values
        first[1:] = uid[1:] != uid[:-1]
        if not torch.equal(torch.isnan(out["rating_difference_lag_1"].values), first):
            fail("sessions: rating's lag is not NaN exactly at each user's first rating")
    for name in names[:4]:
        nan_share[name] = float(torch.isnan(outs[0][name].values).float().mean())
    cpu_wf = nvt.Workflow(sessions_graph(ops), device="cpu")
    cpu_wf.fit(dataset)
    want = cpu_wf.transform(batches[0])
    for name in names:
        if not nan_equal(outs[0][name].values.cpu(), want[name].values):
            fail(f"sessions vs cpu: {name} is not bit-equal to the CPU run")
    log(f"sessions: first transform pass {first_pass_s:.2f} s, launches {launches} (no plain version on the "
        f"card); batch 0 bit-equal to the CPU "
        f"run (NaN for NaN); NaN share of batch 0 {nan_share}")
    del outs

    with_h2d_all, _ = transform_rates(wf, batches, rows_total)
    on_card = [ex.stage(b) for b in batches]
    torch.cuda.synchronize()
    without_h2d_all, _ = transform_rates(wf, on_card, rows_total)
    rec = {
        "first_pass_s": first_pass_s, "launches": launches, "rows": rows_total, "nan_share_batch0": nan_share,
        "rows_per_s_with_h2d": with_h2d_all, "rows_per_s_without_h2d": without_h2d_all,
    }
    if profile:
        rec["profile"] = {"without_h2d": profile_pass(lambda: transform_all(wf, on_card[:4]))}
        p = rec["profile"]["without_h2d"]
        log(f"profile sessions without_h2d: wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
            f"({p['busy_share']:.1%}), top device kernels {p['top']}, top operators {p['top_ops']}")
    log(
        f"sessions: transform median of {REPEATS} passes {float(np.median(with_h2d_all)):,.0f} rows/s "
        f"(min {with_h2d_all[0]:,.0f}, max {with_h2d_all[-1]:,.0f}) with the host-to-device copy, "
        f"{float(np.median(without_h2d_all)):,.0f} rows/s (min {without_h2d_all[0]:,.0f}, max "
        f"{without_h2d_all[-1]:,.0f}) from batches on the card"
    )
    rec["staged"] = on_card[0]
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"sessions: phase 13 took {rec['phase_s']:.1f} s")
    return rec


def crossed_kernel_records(dev, crossed: dict, sessions: dict) -> dict:
    """Phase 14: K10b / K9 (hash_pair, hash_pair_verify), K12a
    (difference_lag) and HashBucket's K7 at phases 12-13's shapes against
    their plain versions on the card, timed beside their bounds."""
    from nvtabular_tpu_torch.kernels import difference_lag as kdl
    from nvtabular_tpu_torch.kernels import hash as khash
    from nvtabular_tpu_torch.kernels import hash_pair as khp

    records = {}
    staged = crossed["staged"]
    n = ROWS_PER_PART

    def record(name, got, want, fn, plain_fn, nbytes, ops, **extra):
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            if not nan_equal(g, w):
                fail(f"{name} kernel differs from plain in {int(((g != w) & ~(g.isnan() & w.isnan())).sum())} entries")
        rec = {"max_abs_err": 0, "ms": time_ms(fn), "plain_ms": time_ms(plain_fn), "library_ms": None,
               "bytes": nbytes, **extra}
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops)
        records[name] = rec

    def group_records(suffix, members, index, hit_offset, oov, null):
        """hash_pair and hash_pair_verify of one group on batch 0 as staged."""
        cols = [staged[c].values for c in members]
        k = len(cols)
        h1, h2 = khp.hash_pair(cols)
        record(f"hash_pair{suffix}", (h1, h2), khp.hash_pair_plain(cols), lambda: khp.hash_pair(cols),
               lambda: khp.hash_pair_plain(cols), n * 4 * k + n * 8, n * k * 60, shape=[k, n])
        misses = index.misses
        idx = index.table.encode(h1[None], None, index.zero, index.zero, misses, misses)[0]
        hits = int(torch.unique(idx).numel())
        args = (idx, h2, index.h2, [], misses, hit_offset, oov, null)
        record(f"hash_pair_verify{suffix}", khp.hash_pair_verify(*args), khp.hash_pair_verify_plain(*args),
               lambda: khp.hash_pair_verify(*args), lambda: khp.hash_pair_verify_plain(*args),
               n * 12 + hits * 4, n * 6, shape=[n], groups=misses, distinct_rows=hits)

    # K10b on TargetEncoding's (C15, C24) group: 16,740 fitted tuples, a cuckoo table
    ex = crossed["wf"].executor
    te_state = ex.op_state(crossed["te"], dev)
    index = te_state["index"]["C15_C24"].pair
    G = index.misses
    group_records("", ["C15", "C24"], index, 0, G, G)
    # K9 on the combo (C8, C15): the same two kernels with Categorify's codes
    cat = crossed["cat"]
    vocab = cat.vocabs["C8_C15"]
    combo = ex.op_state(cat, dev)["combo"]["C8_C15"]
    group_records(":combo", ["C8", "C15"], combo, vocab.start_index, 2, 1)
    # dispatch.hash_lanes (not on the path) against its plain version
    lo, hi = (staged[c].values.long() & 0xFFFFFFFF for c in ("C15", "C24"))
    if not torch.equal(khp.hash_lanes(lo, hi, 17), khp.hash_lanes_plain(lo, hi, 17)):
        fail("hash_lanes kernel differs from plain")

    # K7 as HashBucket: the largest Criteo field into 10M buckets
    col = [staged["C19"].values]
    record("hashed_cross:hash_bucket", khash.hashed_cross(col, 10_000_000), khash.hashed_cross_plain(col, 10_000_000),
           lambda: khash.hashed_cross(col, 10_000_000), lambda: khash.hashed_cross_plain(col, 10_000_000),
           n * 8, n * 30, shape=[n])

    # K12a on phase 13's batch 0: userId keys, rating and ts_delta, shifts 1 and -1
    s = sessions["staged"]
    keys, values, shifts = [s["userId"].values], [s["rating"].values, s["ts_delta"].values], [1, -1]
    m = ML_ROWS_PER_PART
    S, C = len(shifts), len(values)
    record("difference_lag", kdl.difference_lag(keys, values, shifts), kdl.difference_lag_plain(keys, values, shifts),
           lambda: kdl.difference_lag(keys, values, shifts), lambda: kdl.difference_lag_plain(keys, values, shifts),
           m * 8 + C * m * 4 + S * C * m * 4, S * C * m + S * m, shape=[S, C, m])
    return records


BUCKETS = 1000  # not a power of two: a hash reduced by a mask would miss buckets
LIBRARY_WHAT = {
    "sorted_lookup": "positions only",
    "exchange_route": "no PyTorch call routes keys to owners by a hash at a stable rank",
    "embedding_range_gather": "index_select of the clamped local rows, no zeros for other shards' rows",
    "embedding_range_bag": "embedding_bag of the clamped local rows, weights mask * in_range",
    "column_moments": "no one PyTorch call gives count, mean, M2, min and max with NaN as null",
    "range_gather_columns": "index_select of each id's row clamped into its column's shard, no zeros or NaN",
    "range_scatter_grad": "zeros + index_add_ of the held ids' rows",
}


def buckets_graph(ops, cat_names, cont_names):
    """Categorify with hashed OOV buckets: the Criteo ids at the benchmark's
    frequency threshold (bench/criteo_bench.py:57, 133-134), and the 13
    dense features used as categories (float keys)."""
    cats = cat_names >> ops.Categorify(freq_threshold=2, max_size=10_000_000, num_buckets=BUCKETS)
    conts = cont_names >> ops.Categorify(freq_threshold=2, num_buckets=BUCKETS)
    return cats + conts + ["label"]


def buckets_path(nvt, dev, parts, cat_names, cont_names, profile: bool) -> dict:
    """Phase 15: Categorify's hashed OOV buckets and float keys on phase 3's
    partitions."""
    from nvtabular_tpu_torch import kernels, ops

    phase_t0 = time.perf_counter()
    dataset = nvt.Dataset(parts)
    batches = list(dataset.to_batches())
    rows_total = NUM_PARTS * ROWS_PER_PART

    def graph():
        return buckets_graph(ops, cat_names, cont_names)

    wf = nvt.Workflow(graph(), device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_calls_on_card("buckets fit"):
        wf.fit(dataset)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check_launches(kernels.LAUNCHES, {}, "buckets fit")  # counting is torch.unique on the card
    nodes = [n for n in wf.graph.nodes if isinstance(n.op, ops.Categorify)]
    int_node = next(n for n in nodes if cat_names[0] in n.op.vocabs)
    float_node = next(n for n in nodes if cont_names[0] in n.op.vocabs)
    kept = {g: sum(len(n.op.vocabs[c].values_by_code) for c in names)
            for g, n, names in (("int", int_node, cat_names), ("float", float_node, cont_names))}
    int_kinds = sorted(k for k in int_node.op._get_batched() if k != "sorted")
    if sorted(float_node.op._get_batched()) != ["sorted"]:
        fail(f"buckets: float columns took tables {sorted(float_node.op._get_batched())}")
    log(
        f"buckets: fit {fit_s:.2f} s (scan {wf.last_fit_stats['scan_seconds']:.2f} s, finalize "
        f"{wf.last_fit_stats['finalize_seconds']:.2f} s), keys kept at freq_threshold=2 {kept}, int tables "
        f"{int_kinds}"
    )

    kernels.reset_launches()
    t0 = time.perf_counter()
    with plain_calls_on_card("buckets transform"):
        outs = [wf.transform(b) for b in batches]
        torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    per_batch = {f"{k}_lookup": 1 for k in int_kinds}
    per_batch["sorted_lookup"] = 1
    check_launches(launches, {k: v * NUM_PARTS for k, v in per_batch.items()}, "buckets transform")
    hits = {g: torch.zeros(BUCKETS, dtype=torch.int64, device=dev) for g in ("int", "float")}
    rows = {g: 0 for g in hits}
    nulls = {g: 0 for g in hits}
    for out in outs:
        for g, node, names in (("int", int_node, cat_names), ("float", float_node, cont_names)):
            for name in names:
                codes = out[name].values
                if codes.device != dev or codes.shape[0] != ROWS_PER_PART or codes.dtype != torch.int32:
                    fail(f"buckets: output {name} has shape {tuple(codes.shape)} {codes.dtype} on {codes.device}")
                lo, hi = (int(v) for v in torch.aminmax(codes))
                if lo < 1 or hi >= node.op.vocabs[name].size:
                    fail(f"buckets: {name} codes span [{lo}, {hi}], vocabulary size {node.op.vocabs[name].size}")
                oov = codes[(codes >= 2) & (codes < 2 + BUCKETS)] - 2
                hits[g] += torch.bincount(oov.long(), minlength=BUCKETS)
                rows[g] += codes.numel()
                nulls[g] += int((codes == 1).sum())
    oov_share = {g: int(hits[g].sum()) / rows[g] for g in hits}
    buckets_hit = {g: int((hits[g] > 0).sum()) for g in hits}
    if buckets_hit["int"] != BUCKETS:
        fail(f"buckets: the integer columns' misses hit {buckets_hit['int']} of {BUCKETS} buckets")
    log(f"buckets: first transform pass {first_pass_s:.2f} s, launches {launches} (no plain version on the card "
        f"in the fit or the transform); share of rows in OOV buckets {oov_share}, buckets hit {buckets_hit}, "
        f"null rows {nulls}")
    cpu_wf = nvt.Workflow(graph(), device="cpu")
    nvt.load_fitted_state(cpu_wf, nvt.fitted_state(wf))
    compare_outputs(outs[0], cpu_wf.transform(batches[0]), set(), "buckets vs cpu")
    log("buckets: batch 0 equals the CPU run (codes exact)")
    del outs

    ex = wf.executor
    with_h2d_all, _ = transform_rates(wf, batches, rows_total)
    on_card = [ex.stage(b) for b in batches]
    torch.cuda.synchronize()
    without_h2d_all, _ = transform_rates(wf, on_card, rows_total)
    rec = {
        "fit_s": fit_s, "fit_stats": dict(wf.last_fit_stats), "keys_kept": kept, "int_tables": int_kinds,
        "first_pass_s": first_pass_s, "launches": launches, "rows": rows_total, "oov_share": oov_share,
        "buckets_hit": buckets_hit, "null_rows": nulls,
        "rows_per_s_with_h2d": with_h2d_all, "rows_per_s_without_h2d": without_h2d_all,
    }
    if profile:
        rec["profile"] = {"without_h2d": profile_pass(lambda: transform_all(wf, on_card[:4]))}
        p = rec["profile"]["without_h2d"]
        log(f"profile buckets without_h2d: wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
            f"({p['busy_share']:.1%}), top device kernels {p['top']}, top operators {p['top_ops']}")
    log(
        f"buckets: transform median of {REPEATS} passes {float(np.median(with_h2d_all)):,.0f} rows/s "
        f"(min {with_h2d_all[0]:,.0f}, max {with_h2d_all[-1]:,.0f}) with the host-to-device copy, "
        f"{float(np.median(without_h2d_all)):,.0f} rows/s (min {without_h2d_all[0]:,.0f}, max "
        f"{without_h2d_all[-1]:,.0f}) from batches on the card"
    )
    rec.update(wf=wf, staged=on_card[0], nodes=(int_node, float_node))
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"buckets: phase 15 took {rec['phase_s']:.1f} s")
    return rec


def search_probes(values, keys, starts, lens, sel):
    """(distinct key entries read, distinct codes read, probes) of K8's
    searches over ``values`` [C, N] float32: the kernel's lower-bound loop
    run on the card in PyTorch, recording every index it reads."""
    from nvtabular_tpu_torch.kernels.lookup import flush_subnormals

    s = sel.long()
    start, n = starts[s][:, None], lens[s][:, None].expand(values.shape)
    x = flush_subnormals(values)
    active = ~torch.isnan(values)
    lo, hi = torch.zeros_like(n), torch.where(active, n, torch.zeros_like(n))
    read, probes = [], 0
    while True:
        live = lo < hi
        count = int(live.sum())
        if count == 0:
            break
        probes += count
        mid = (lo + hi) >> 1
        idx = (start + mid)[live]
        read.append(idx)
        less = torch.zeros_like(live)
        less[live] = keys[idx] < x[live]
        lo = torch.where(live & less, mid + 1, lo)
        hi = torch.where(live & ~less, mid, hi)
    last = active & (lo < n)
    final = (start + lo)[last]
    hit = keys[final] == x[last]
    key_reads = torch.unique(torch.cat(read + [final])).numel() if read or final.numel() else 0
    return key_reads, int(torch.unique(final[hit]).numel()), probes + int(last.sum())


def buckets_kernel_records(dev, rec) -> dict:
    """Phase 15's kernels at its shapes: sorted_lookup (K8) over the 13
    float columns, and the integer lookups with hashed misses (K4's hashed
    branch in K1-K3), each against its plain version on the card, timed
    beside its bound."""
    from nvtabular_tpu_torch.kernels import lookup as klk

    records = {}
    ex, staged = rec["wf"].executor, rec["staged"]
    n = ROWS_PER_PART
    jobs = {}
    for node in rec["nodes"]:
        state = ex.op_state(node.op, dev)
        jobs.update({j["kind"]: j for j in node.op.lookup_jobs(node.selector, staged, state)})
    if jobs.get("sorted") is None or jobs["sorted"]["nbuckets"] is None:
        fail(f"buckets: expected a sorted job with hashed misses, got {sorted(jobs)}")

    # K8 over [13, 262144] float32 values
    j = jobs["sorted"]
    t = j["table"]
    args = (j["values"], j["validity"], t.keys, t.codes, t.starts, t.lens, j["sel"], j["col_offsets"], 2, 1,
            j["nbuckets"])
    r = lookup_record(j, klk.sorted_lookup_plain, args, lambda: klk.sorted_lookup(*args))
    C = j["values"].shape[0]
    key_reads, code_reads, probes = search_probes(j["values"], t.keys, t.starts, t.lens, j["sel"])
    codes = klk.sorted_lookup_plain(*args)
    misses = int(((codes >= 2) & (codes < 2 + BUCKETS)).sum())
    rows, _ = klk.padded_keys(t.keys, t.starts, t.lens)
    rows = rows[j["sel"].long()].contiguous()
    r["library_ms"] = time_ms(lambda: torch.searchsorted(rows, j["values"]))
    r.update(shape=[C, n], bytes=C * n * 8 + key_reads * 4 + code_reads * 4, table_keys=int(t.keys.numel()),
             probes=probes, distinct_keys_read=key_reads, library_what=LIBRARY_WHAT["sorted_lookup"])
    r["bound_ms"], r["bound_by"] = bound(r["bytes"], probes * 2 + misses * 12)
    records["sorted_lookup"] = r

    # K1 / K2 / K3 with hashed misses over the Criteo ids
    for kind, j in jobs.items():
        if kind == "sorted":
            continue
        t = j["table"]
        s = j["sel"].long()
        C = j["values"].shape[0]
        if kind == "tiny":
            args = (j["values"], j["validity"], t.keys, t.codes, t.lens, j["sel"], j["col_offsets"], 2, 1,
                    j["nbuckets"])
            r = lookup_record(j, klk.tiny_lookup_plain, args, lambda a=args: klk.tiny_lookup(*a))
            table_bytes = int(t.lens[torch.unique(s)].sum()) * 8
            ops = int(torch.log2(t.lens[s].float() + 1).ceil().sum()) * n * 2
        elif kind == "cuckoo":
            args = (j["values"], j["validity"], t.table, t.nbs, t.row_offsets, j["sel"], j["col_offsets"], 2, 1,
                    j["nbuckets"])
            r = lookup_record(j, klk.cuckoo_lookup_plain, args, lambda a=args: klk.cuckoo_lookup(*a))
            buckets = torch.cat([
                (klk.bucket_index_plain(j["values"], t.nbs[s][:, None], seed) + t.row_offsets[s][:, None]).flatten()
                for seed in klk.SEEDS
            ])
            table_bytes = int(torch.unique(buckets).numel()) * 32
            ops = C * n * 40
        else:
            args = (j["values"], j["validity"], t.table, t.mins, t.maxs, t.lens, t.offsets, j["sel"],
                    j["col_offsets"], 2, 1, j["nbuckets"])
            r = lookup_record(j, klk.direct_lookup_plain, args, lambda a=args: klk.direct_lookup(*a))
            idx = torch.minimum((j["values"].long() - t.mins[s].long()[:, None]).clamp(min=0),
                                t.lens[s][:, None] - 1) + t.offsets[s][:, None]
            table_bytes = int(torch.unique(idx // 8).numel()) * 32
            ops = C * n * 10
        plain, kernel = {"tiny": (klk.tiny_lookup_plain, klk.tiny_lookup),
                         "cuckoo": (klk.cuckoo_lookup_plain, klk.cuckoo_lookup),
                         "direct": (klk.direct_lookup_plain, klk.direct_lookup)}[kind]
        codes = plain(*args)
        misses = int(((codes >= 2) & (codes < 2 + BUCKETS)).sum())
        # the batch's ids may all hit (the tiny columns do at freq_threshold=2): hold the hashed
        # branch against its plain version on the same ids moved out of the vocabularies as well
        moved = (j["values"] ^ 0x5A5A5A5A,) + args[1:]
        want = plain(*moved)
        torch.cuda.synchronize()
        if not torch.equal(kernel(*moved), want):
            fail(f"{kind} lookup kernel with hashed misses differs from plain on the moved ids")
        moved_misses = int(((want >= 2) & (want < 2 + BUCKETS)).sum())
        if moved_misses == 0:
            fail(f"{kind} lookup: the moved ids took no hashed bucket")
        r.update(shape=[C, n], bytes=C * n * 8 + table_bytes, misses=misses, moved_misses=moved_misses)
        r["bound_ms"], r["bound_by"] = bound(r["bytes"], ops + misses * 12)
        records[f"{kind}_lookup:hashed"] = r
    return records


def train_family(family, loader, cards, dlrm_step_ms: float, smi: str, profile: bool) -> dict:
    """Phase 16 for DeepFM or DCN-v2 at the JAX configs' defaults over phase
    7's tables, the model and its optimizer freed on return: the loader
    staged anew and one warm-up chunk, then TRAIN_REPEATS timed passes of
    TRAIN_STEPS steps, the launch counters zeroed before the staging and
    read after the last step, no plain version on the card; one step held
    against the plain versions; and the inputs of phase 17's kernels kept."""
    from nvtabular_tpu_torch import kernels, models
    from nvtabular_tpu_torch.models.layers import _round_to

    phase_t0 = time.perf_counter()
    if family == "deepfm":
        model = models.DeepFM(models.DeepFMConfig(cards, NUM_CONTS, embedding_dim=TRAIN_DIM), seed=0, device=DEVICE)
        loss_fn, reference, mlps = models.deepfm_loss, models.deepfm_reference_forward, [model.deep]
        own = {"fm_fwd": 1, "fm_bwd": 1}  # launches a step of the model's own kernels
    else:
        model = models.DCN(models.DCNConfig(cards, NUM_CONTS, embedding_dim=TRAIN_DIM), seed=0, device=DEVICE)
        loss_fn, reference, mlps = models.dcn_loss, models.dcn_reference_forward, [model.cross, model.deep, model.out]
        own = {"cross_fwd": model.config.num_cross_layers, "cross_bwd": model.config.num_cross_layers}
    if model.config.input_dim != NUM_CATS * TRAIN_DIM + NUM_CONTS:
        fail(f"{family}: input width {model.config.input_dim}, expected {NUM_CATS * TRAIN_DIM + NUM_CONTS}")
    opt = models.Adagrad(model.parameters(), lr=1e-2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    with plain_calls_on_card(f"{family} training"):
        staged = list(loader.chunks())
        t0 = time.perf_counter()
        losses = [models.train_chunk(model, opt, staged[0], TRAIN_BS, loss_fn)]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        pass_s, i = [], 1
        for _ in range(TRAIN_REPEATS):
            steps = 0
            t0 = time.perf_counter()
            while steps < TRAIN_STEPS:
                losses.append(models.train_chunk(model, opt, staged[i % len(staged)], TRAIN_BS, loss_fn))
                steps += losses[-1].numel()
                i += 1
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    total_steps = sum(int(l.numel()) for l in losses)
    per_chunk = {"permute_rows", "tiny_lookup", "cuckoo_lookup", "cont_chain"}
    per_step = {"embedding_gather": 1, "embedding_scatter_grad": 1, **own}
    for name, count in launches.items():
        want = len(staged) if name in per_chunk else total_steps * per_step.get(name, 0)
        if count != want:
            fail(f"{family}: {name} launched {count} times, expected {want}")
    all_losses = torch.cat(losses)
    if not bool(torch.isfinite(all_losses).all()):
        fail(f"{family}: non-finite losses {all_losses.tolist()}")
    step_s = float(np.median(pass_s)) / TRAIN_STEPS
    rec = {
        "warm_chunk_s": warm_s, "pass_s": pass_s, "steps": total_steps, "step_ms": 1e3 * step_s,
        "steps_per_s": 1.0 / step_s, "examples_per_s": TRAIN_BS / step_s,
        "first_loss": float(all_losses[0]), "last_loss": float(all_losses[-1]), "launches": launches,
        "params": sum(p.numel() for p in model.parameters()),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(
        f"{family}: {TRAIN_STEPS} steps of {TRAIN_BS}: median of {TRAIN_REPEATS} passes {rec['step_ms']:.3f} ms a step, "
        f"{rec['examples_per_s']:,.0f} examples/s (passes {[round(s, 4) for s in pass_s]} s; phase 7's DLRM "
        f"{dlrm_step_ms:.3f} ms); loss {rec['first_loss']:.6f} -> {rec['last_loss']:.6f} over {total_steps} steps; "
        f"{rec['params']:,} parameters, peak {rec['peak_gb']:.2f} GB; launches {launches}; {smi}"
    )

    batch = {k: v[:TRAIN_BS] for k, v in staged[0].items()}
    # DCN's forward is bit-equal through its kernels, DeepFM's FM sums in another order
    rec["parity"] = check_step_parity(model, batch, reference, mlps, same_output_grad=family == "deepfm")
    log(f"{family}: one step through the kernels equals the plain versions on the card: {rec['parity']}")
    if profile:

        def train_two_chunks():
            for c in staged[:2]:
                models.train_chunk(model, opt, c, TRAIN_BS, loss_fn)
            torch.cuda.synchronize()

        rec["profile"] = p = profile_pass(train_two_chunks)
        log(f"profile {family} (8 steps): wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
            f"({p['busy_share']:.1%}), top device kernels {p['top']}, top operators {p['top_ops']}")

    def fwd_bwd():
        opt.zero_grad()
        loss_fn(model, batch).backward()

    rec["fwd_bwd_ms"] = time_ms(fwd_bwd, iters=10)
    rec["adagrad_ms"] = time_ms(opt.step, iters=10)
    log(f"{family}: forward + backward {rec['fwd_bwd_ms']:.3f} ms, Adagrad update {rec['adagrad_ms']:.3f} ms "
        f"(device time per step); {smi}")

    # phase 17's inputs: the trained state on one batch, as the main path hands it to the kernels
    with torch.no_grad():
        x = model.features(batch)
        if family == "deepfm":
            rec["kernel_inputs"] = dict(x=x, ids=model.ids(batch), offsets=model.offsets, sizes=model.sizes,
                                        linear=model.linear.detach().clone(), dense_w=model.dense_w.detach().clone())
        else:  # the second cross layer: x_1 from the first, its product and bias
            cross, cdt = model.cross, torch.bfloat16
            x1 = (_round_to(x, cdt) @ _round_to(cross.weights[0], cdt)).add_(cross.biases[0]).mul_(x).add_(x)
            xw1 = _round_to(x1, cdt) @ _round_to(cross.weights[1], cdt)
            rec["kernel_inputs"] = dict(xw=xw1, b=cross.biases[1].detach().clone(), x0=x, x=x1)
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"{family}: phase 16 took {rec['phase_s']:.1f} s")
    return rec


def factorized_kernel_records(recs) -> dict:
    """Phase 17: fm_fwd, fm_bwd (K16), cross_fwd and cross_bwd (K17) at
    phase 16's shapes against their plain versions on the card, timed
    beside their bounds."""
    from nvtabular_tpu_torch.kernels import cross as kcross
    from nvtabular_tpu_torch.kernels import fm as kfm
    from nvtabular_tpu_torch.kernels.embedding import table_rows

    records = {}
    k = recs["deepfm"].pop("kernel_inputs")
    x, ids, offsets, sizes, linear, dense_w = (k[n] for n in ("x", "ids", "offsets", "sizes", "linear", "dense_w"))
    B, F, D, nd = x.shape[0], len(ids), TRAIN_DIM, NUM_CONTS
    dev = x.device
    v, dense = x[:, : F * D].unflatten(1, (F, D)), x[:, F * D :]
    got = kfm.fm_fwd(v, dense, ids, offsets, sizes, linear, dense_w)
    want = kfm.fm_fwd_plain(v, dense, ids, offsets, sizes, linear, dense_w)
    rows, valid = table_rows(ids, offsets, sizes)
    s, q = v.sum(1), (v * v).sum(1)
    scale = (s * s + q).sum(1) + torch.where(valid, linear[rows].abs(), 0.0).sum(1) + (dense * dense_w).abs().sum(1)
    torch.cuda.synchronize()
    # the second order's two sums cancel: allow 1e-5 of the magnitudes they sum, not of the result
    if not bool(((got - want).abs() <= SUM_TOL["rtol"] * scale + SUM_TOL["atol"]).all()):
        fail(f"fm_fwd kernel differs from plain: max abs {float((got - want).abs().max())}")
    distinct = int(torch.unique(rows[valid]).numel())
    row_bytes = B * (F * D + nd) * 4
    rec = {
        "max_abs_err": float((got - want).abs().max()), "shape": [B, F, D], "distinct_linear": distinct,
        "bytes": row_bytes + B * F * 4 + distinct * 4 + nd * 4 + B * 4,
        "ms": time_ms(lambda: kfm.fm_fwd(v, dense, ids, offsets, sizes, linear, dense_w)),
        "plain_ms": time_ms(lambda: kfm.fm_fwd_plain(v, dense, ids, offsets, sizes, linear, dense_w)),
        "library_ms": None,
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], B * (3 * F * D + 2 * D + F + 2 * nd))
    records["fm_fwd"] = rec

    g = torch.randn(B, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    num_rows = linear.shape[0]
    dx = torch.empty_like(x)
    dv_out, ddense_out = dx[:, : F * D].unflatten(1, (F, D)), dx[:, F * D :]

    def bwd():
        return kfm.fm_bwd(v, dense, ids, offsets, sizes, dense_w, g, num_rows, dv_out=dv_out, ddense_out=ddense_out)

    got = [t.clone() for t in bwd()]
    want = kfm.fm_bwd_plain(v, dense, ids, offsets, sizes, dense_w, g, num_rows)
    mag = kfm.fm_bwd_plain(v, dense.abs(), ids, offsets, sizes, dense_w, g.abs(), num_rows)
    sv = g.abs()[:, None, None] * v.abs().sum(1, keepdim=True)
    torch.cuda.synchronize()
    limits = (sv, torch.zeros_like(want[1]), mag[2], mag[3])  # dv, ddense (one product: exact), dlinear, ddense_w
    for what, a, b, m in zip(("dv", "ddense", "dlinear", "ddense_w"), got, want, limits):
        if not bool(((a - b).abs() <= SUM_TOL["rtol"] * m + (SUM_TOL["atol"] if what != "ddense" else 0.0)).all()):
            fail(f"fm_bwd kernel differs from plain in {what}: max abs {float((a - b).abs().max())}")
    rec = {
        "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, want)), "shape": [B, F, D],
        "bytes": 2 * row_bytes + B * F * 4 + B * 4 + num_rows * 4 + 2 * nd * 4,
        "ms": time_ms(bwd),
        "plain_ms": time_ms(lambda: kfm.fm_bwd_plain(v, dense, ids, offsets, sizes, dense_w, g, num_rows)),
        "library_ms": None,
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], B * (3 * F * D + F + 3 * nd))
    records["fm_bwd"] = rec
    del k, x, v, dense, got, want, mag, sv, dx, linear

    k = recs["dcn"].pop("kernel_inputs")
    xw, b, x0, xl = k["xw"], k["b"], k["x0"], k["x"]
    B, N = xw.shape
    got = kcross.cross_fwd(xw, b, x0, xl)
    want = kcross.cross_fwd_plain(xw, b, x0, xl)
    torch.cuda.synchronize()
    if not torch.equal(got, want):  # the same rounded operations
        fail(f"cross_fwd kernel differs from plain: max abs {float((got - want).abs().max())}")
    rec = {
        "max_abs_err": 0.0, "shape": [B, N], "bytes": 4 * B * N * 4 + N * 4,
        "ms": time_ms(lambda: kcross.cross_fwd(xw, b, x0, xl)),
        "plain_ms": time_ms(lambda: kcross.cross_fwd_plain(xw, b, x0, xl)),
        "library_ms": None,
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], 3 * B * N)
    records["cross_fwd"] = rec

    g = torch.randn((B, N), device=xw.device, generator=torch.Generator(device=xw.device).manual_seed(5))
    got = kcross.cross_bwd(g, xw, b, x0)
    want = kcross.cross_bwd_plain(g, xw, b, x0)
    magnitude = (g * x0).abs().sum(0)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("cross_bwd kernel differs from plain in dxw or dx0")
    # a column sum of 65,536 products in a varying order: 1e-5 of the sum of their magnitudes
    if not bool(((got[2] - want[2]).abs() <= SUM_TOL["rtol"] * magnitude + SUM_TOL["atol"]).all()):
        fail(f"cross_bwd kernel differs from plain in db: max abs {float((got[2] - want[2]).abs().max())}")
    rec = {
        "max_abs_err": float((got[2] - want[2]).abs().max()), "shape": [B, N], "bytes": 5 * B * N * 4 + 2 * N * 4,
        "ms": time_ms(lambda: kcross.cross_bwd(g, xw, b, x0)),
        "plain_ms": time_ms(lambda: kcross.cross_bwd_plain(g, xw, b, x0)),
        "library_ms": None,
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], 4 * B * N)
    records["cross_bwd"] = rec
    return records


def vocab_digest(vocab) -> str:
    """SHA-256 of a fitted vocabulary: values in code order, counts, and its
    start index and single_table offset."""
    h = hashlib.sha256()
    for part in (vocab.values_by_code, vocab.counts, [vocab.start_index, vocab.offset]):
        h.update(np.ascontiguousarray(np.asarray(part, dtype=np.int64)).tobytes())
    return h.hexdigest()


def column_keys(parts, name: str, dev) -> torch.Tensor:
    """A column of every partition, concatenated on the card."""
    return torch.cat([p[name].values for p in parts]).to(dev)


def pad_split(keys: torch.Tensor, ndev: int, factor: float):
    """The reference's padding and split (sharded_vocab.py:84-90): each
    device's keys, and the send capacity."""
    from nvtabular_tpu_torch.kernels.exchange import PAD

    per = -(-keys.numel() // ndev)
    padded = torch.full((per * ndev,), PAD, dtype=torch.int32, device=keys.device)
    padded[: keys.numel()] = keys
    return list(padded.view(ndev, per)), max(int(np.ceil(per * factor / ndev)), 8)


def sharded_fit_path(nvt, ops, dev, wf, parts, criteo_graph, cat_names, cont_names) -> dict:
    """Phase 18: the multi-GPU fit's entry points on a one-rank NCCL group."""
    import torch.distributed as dist

    from nvtabular_tpu_torch import kernels, parallel
    from nvtabular_tpu_torch.dag.executor import TorchExecutor
    from nvtabular_tpu_torch.kernels import embedding as kemb
    from nvtabular_tpu_torch.kernels import embedding_bag as kbag

    phase_t0 = time.perf_counter()
    store = Path("build") / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    parallel.initialize_distributed("nccl", f"file://{store.resolve()}", rank=0, world_size=1, timeout=300)
    rec = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    try:
        mesh = parallel.local_mesh()
        rec["mesh"] = {axis: mesh.get_group(axis).size() for axis in ("data", "model")}

        # the Criteo workflow of phase 3, its vocabularies counted with K15a
        swf = nvt.Workflow(criteo_graph(), executor=TorchExecutor(dev, mesh=mesh))
        dataset = nvt.Dataset(parts)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with plain_calls_on_card("sharded fit"):
            swf.fit(dataset)
            torch.cuda.synchronize()
        rec["fit_s"] = time.perf_counter() - t0
        rec["fit_launches"] = dict(kernels.LAUNCHES)
        check_launches(rec["fit_launches"], {"exchange_route": NUM_CATS, "radix_sort": NUM_CATS}, "sharded fit")
        rec["fit_stats"] = swf.last_fit_stats
        want_cat = next(n.op for n in wf.graph.nodes if isinstance(n.op, ops.Categorify))
        got_cat = next(n.op for n in swf.graph.nodes if isinstance(n.op, ops.Categorify))
        if sorted(got_cat.vocabs) != sorted(want_cat.vocabs):
            fail(f"sharded fit: vocabularies {sorted(got_cat.vocabs)} != {sorted(want_cat.vocabs)}")
        for key, vocab in want_cat.vocabs.items():
            if vocab_digest(got_cat.vocabs[key]) != vocab_digest(vocab):
                fail(f"sharded fit: vocabulary {key} differs from phase 3's (SHA-256 of values, counts, offsets)")
        want_norm = next(n.op for n in wf.graph.nodes if isinstance(n.op, ops.Normalize))
        got_norm = next(n.op for n in swf.graph.nodes if isinstance(n.op, ops.Normalize))
        for name in cont_names:
            for what in ("means", "stds"):
                g, w = getattr(got_norm, what)[name], getattr(want_norm, what)[name]
                if not math.isclose(g, w, rel_tol=1e-6):
                    fail(f"sharded fit: Normalize {what}[{name}] {g} != phase 3's {w}")
        out = swf.transform(parts[0])
        want_out = wf.transform(parts[0])
        for name in cat_names:
            if not torch.equal(out[name].values, want_out[name].values):
                fail(f"sharded fit: {name} codes of batch 0 differ from phase 3's")
        rec["vocab_keys"] = sum(len(v.values_by_code) for v in got_cat.vocabs.values())
        rec["vocabs"] = {k: (v.values_by_code, v.counts) for k, v in got_cat.vocabs.items()}
        log(
            f"sharded fit: one-rank {rec['backend']} group, mesh {rec['mesh']}; fit {rec['fit_s']:.2f} s (scan "
            f"{rec['fit_stats']['scan_seconds']:.2f}, reduce {rec['fit_stats']['reduce_seconds']:.2f}, finalize "
            f"{rec['fit_stats']['finalize_seconds']:.2f}) against phase 3's {wf.last_fit_stats['scan_seconds']:.2f} / "
            f"{wf.last_fit_stats['finalize_seconds']:.2f} s; {NUM_CATS} columns through K15a, {rec['vocab_keys']} "
            f"keys: every vocabulary's SHA-256 equals phase 3's, Normalize within rtol=1e-6, batch 0's codes equal"
        )

        # the row-sharded lookups over phase 7's 26 tables (22,343,004 rows, dim 16)
        cards = [want_cat.vocabs[name].size for name in cat_names]
        offsets = np.concatenate([[0], np.cumsum(cards)[:-1]]).tolist()
        table = torch.randn((sum(cards), TRAIN_DIM), device=dev, generator=torch.Generator(device=dev).manual_seed(5))
        ids = [out[name].values[:TRAIN_BS].contiguous() for name in cat_names]
        values = (torch.stack([v.long() for v in ids], 1) + torch.tensor(offsets, device=dev)).to(torch.int32)
        mask = (torch.rand(values.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(6)) < 0.7).float()
        flat = values.reshape(-1)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with plain_calls_on_card("sharded lookups"):
            looked = parallel.sharded_embedding_lookup(table, flat, mesh)
            bagged = parallel.sharded_embedding_bag(table, values, mask, mesh)
            torch.cuda.synchronize()
        rec["lookup_launches"] = dict(kernels.LAUNCHES)
        check_launches(rec["lookup_launches"], {"embedding_range_gather": 1, "embedding_range_bag": 1}, "sharded lookups")
        gathered = kemb.embedding_gather(table, ids, offsets, cards)
        pooled = kbag.embedding_bag_fwd(table, values, mask, "mean")
        torch.cuda.synchronize()
        if not torch.equal(looked, gathered.reshape(-1, TRAIN_DIM)):
            fail("sharded_embedding_lookup differs from K13a's gather over the same ids")
        if not torch.allclose(bagged, pooled, **SUM_TOL):
            fail(f"sharded_embedding_bag differs from K13c's bag: max abs {float((bagged - pooled).abs().max())}")
        rec["bag_max_abs_err"] = float((bagged - pooled).abs().max())
        rec.update(table=table, flat=flat, values=values, mask=mask, table_rows=int(table.shape[0]))
        log(f"sharded lookups: [{TRAIN_BS} x {NUM_CATS}] ids of batch 0 over {table.shape[0]} rows: the lookup equals "
            f"K13a's gather, the bag K13c's within SUM_TOL (max abs {rec['bag_max_abs_err']})")

        # sharded moments of the 13 LogOp outputs of every partition
        lwf = nvt.Workflow(cont_names >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp(), device=dev)
        x = torch.cat([torch.stack([lwf.transform(p)[c].values for c in cont_names], 1) for p in parts])
        torch.cuda.synchronize()
        kernels.reset_launches()
        with plain_calls_on_card("sharded moments"):
            mom = parallel.sharded_moments(x, mesh)
            torch.cuda.synchronize()
        rec["moments_launches"] = dict(kernels.LAUNCHES)
        check_launches(rec["moments_launches"], {"column_moments": 1}, "sharded moments")
        x64 = x.cpu().numpy().astype(np.float64)
        want = {"count": (~np.isnan(x64)).sum(0), "min": np.nanmin(x64, 0), "max": np.nanmax(x64, 0),
                "mean": np.nanmean(x64, 0), "var": np.nanvar(x64, 0, ddof=1)}
        for k in ("count", "min", "max"):
            if not np.array_equal(mom[k], want[k]):
                fail(f"sharded_moments {k} differs from float64 numpy: {mom[k]} != {want[k]}")
        for k in ("mean", "var"):
            if not np.allclose(mom[k], want[k], rtol=1e-5, atol=0):
                fail(f"sharded_moments {k} differs from float64 numpy beyond rtol=1e-5: {mom[k]} != {want[k]}")
        rec["moments_rel_err"] = {k: float(np.max(np.abs(mom[k] - want[k]) / np.abs(want[k]))) for k in ("mean", "var")}
        rec["x0"] = x[:ROWS_PER_PART].contiguous()
        log(f"sharded moments: [{x.shape[0]}, {x.shape[1]}] LogOp outputs; count, min and max equal float64 numpy, "
            f"mean and var within rtol=1e-5 (largest relative errors {rec['moments_rel_err']})")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"sharded: phase 18 took {rec['phase_s']:.1f} s")
    return rec


def sharded_kernel_records(dev, parts, cat_names, sharded: dict) -> dict:
    """Phase 19: each K15 kernel against its plain version on the card; the
    four-rank exchange composed on one card; times beside bounds."""
    import torch.nn.functional as F

    from nvtabular_tpu_torch.kernels import embedding as kemb
    from nvtabular_tpu_torch.kernels import embedding_bag as kbag
    from nvtabular_tpu_torch.kernels import exchange as kex
    from nvtabular_tpu_torch.kernels import moments as kmom
    from nvtabular_tpu_torch.parallel.sharded_vocab import _owned_counts

    phase_t0 = time.perf_counter()
    records, compose = {}, {}
    vocabs = sharded["vocabs"]
    largest = sorted(cat_names, key=lambda c: -len(vocabs[c][0]))[:2]
    # the column whose most frequent key holds the largest share of the rows
    skewed = max(cat_names, key=lambda c: vocabs[c][1].max() / vocabs[c][1].sum())

    def check_route(local, ndev, cap):
        send, overflow = kex.exchange_route(local, ndev, cap)
        want_send, want_overflow = kex.exchange_route_plain(local, ndev, cap)
        torch.cuda.synchronize()
        if not (torch.equal(send, want_send) and torch.equal(overflow, want_overflow)):
            fail(f"exchange_route differs from plain at ndev {ndev}, cap {cap}")
        return send, int(overflow[0])

    def check_sort(keys):
        got = kex.radix_sort(keys)
        if not torch.equal(got, kex.radix_sort_plain(keys)):
            fail(f"radix_sort differs from plain on {keys.numel()} keys")
        return got

    for col in largest + [skewed]:
        keys = column_keys(parts, col, dev)
        if col in largest:
            for ndev in (1, 2, 4, 8):
                shards, cap = pad_split(keys, ndev, CAPACITY_FACTOR)
                for local in shards:
                    check_route(local, ndev, cap)
        # four ranks on one card: route each shard, exchange as all_to_all
        # does (recv[d] = every source's send[d]), sort each owner's keys;
        # an overflow doubles the capacity, as sharded_value_counts_arrays does
        factor, overflows = CAPACITY_FACTOR, []
        while True:
            shards, cap = pad_split(keys, COMPOSE_RANKS, factor)
            routed = [check_route(local, COMPOSE_RANKS, cap) for local in shards]
            overflows.append(sum(o for _, o in routed))
            if overflows[-1] == 0:
                break
            if len(overflows) > 6:
                fail(f"compose {col}: still overflowing at capacity factor {factor}")
            factor *= 2
        recv = torch.stack([send for send, _ in routed]).transpose(0, 1).reshape(COMPOSE_RANKS, -1)
        owned = [_owned_counts(check_sort(recv[d].contiguous())) for d in range(COMPOSE_RANKS)]
        vals = np.concatenate([v for v, _ in owned])
        cnts = np.concatenate([c for _, c in owned])
        order = np.argsort(vals)
        want_vals, want_cnts = (np.asarray(a, dtype=np.int64) for a in vocabs[col])
        want_order = np.argsort(want_vals)
        if not (np.array_equal(vals[order], want_vals[want_order]) and np.array_equal(cnts[order], want_cnts[want_order])):
            fail(f"compose {col}: the four ranks' counts differ from phase 18's vocabulary")
        compose[col] = {"keys": int(keys.numel()), "overflows": overflows, "factor": factor, "cap": cap,
                        "owned": [len(v) for v, _ in owned]}
        log(f"compose {col}: {keys.numel()} keys over {COMPOSE_RANKS} ranks on the card, overflow per pass "
            f"{overflows} (capacity factor {factor}, cap {cap}), owners hold {compose[col]['owned']} keys; "
            f"the counts equal phase 18's")
    if compose[skewed]["overflows"][0] == 0:
        fail(f"compose {skewed}: its skew should overflow the first capacity at {COMPOSE_RANKS} ranks")

    # K15a at phase 18's shapes: the largest column routed to one owner, the received keys sorted
    keys = column_keys(parts, largest[0], dev)
    n = keys.numel()
    cap = max(int(np.ceil(n * CAPACITY_FACTOR)), 8)
    send, _ = check_route(keys, 1, cap)
    recv = send.reshape(-1)
    check_sort(recv)
    torch.cuda.synchronize()
    rec = {"max_abs_err": 0, "shape": [n, 1, cap], "bytes": n * 4 + cap * 4,
           "ms": time_ms(lambda: kex.exchange_route(keys, 1, cap)),
           "plain_ms": time_ms(lambda: kex.exchange_route_plain(keys, 1, cap)), "library_ms": None}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], n * 12)
    records["exchange_route"] = rec
    N = recv.numel()
    rec = {"max_abs_err": 0, "shape": [N], "bytes": 2 * N * 4,
           "ms": time_ms(lambda: kex.radix_sort(recv)), "plain_ms": time_ms(lambda: kex.radix_sort_plain(recv)),
           "library_ms": time_ms(lambda: torch.sort(recv))}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], 0)
    records["radix_sort"] = rec
    del keys, send, recv

    # K15b with the rows of model shard 1 of 4
    table, flat, values, mask = (sharded[k] for k in ("table", "flat", "values", "mask"))
    rows = table.shape[0] // MODEL_SHARDS
    start = rows
    local = table[start: start + rows]
    D = table.shape[1]
    got = kemb.embedding_range_gather(local, flat, start)
    if not torch.equal(got, kemb.embedding_range_gather_plain(local, flat, start)):
        fail("embedding_range_gather differs from plain")
    local_ids = flat.long() - start
    hit = (local_ids >= 0) & (local_ids < rows)
    distinct = int(torch.unique(local_ids[hit]).numel())
    safe = local_ids.clamp(0, rows - 1)
    rec = {"max_abs_err": 0, "shape": [flat.numel(), rows, D], "distinct_rows": distinct, "in_range": int(hit.sum()),
           "bytes": flat.numel() * 4 + distinct * D * 4 + flat.numel() * D * 4,
           "ms": time_ms(lambda: kemb.embedding_range_gather(local, flat, start)),
           "plain_ms": time_ms(lambda: kemb.embedding_range_gather_plain(local, flat, start)),
           # the clamped local rows, without the zeros for other shards' rows
           "library_ms": time_ms(lambda: torch.index_select(local, 0, safe))}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], 0)
    records["embedding_range_gather"] = rec

    B, L = values.shape
    got = kbag.embedding_range_bag(local, values, mask, start)
    want = kbag.embedding_range_bag_plain(local, values, mask, start)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, **SUM_TOL):
        fail(f"embedding_range_bag differs from plain: max abs {float((got - want).abs().max())}")
    bag_ids = values.long() - start
    bag_hit = (bag_ids >= 0) & (bag_ids < rows)
    weights = (mask * bag_hit.float()).contiguous()
    bag_safe = bag_ids.clamp(0, rows - 1)
    bag_distinct = int(torch.unique(bag_ids[bag_hit]).numel())
    rec = {"max_abs_err": float((got - want).abs().max()), "shape": [B, L, rows, D], "distinct_rows": bag_distinct,
           "bytes": B * L * 8 + bag_distinct * D * 4 + B * D * 4,
           "ms": time_ms(lambda: kbag.embedding_range_bag(local, values, mask, start)),
           "plain_ms": time_ms(lambda: kbag.embedding_range_bag_plain(local, values, mask, start)),
           "library_ms": time_ms(lambda: F.embedding_bag(bag_safe, local, per_sample_weights=weights, mode="sum"))}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], B * L * D * 2)
    records["embedding_range_bag"] = rec

    # K15c on one partition's LogOp outputs
    x = sharded["x0"]
    R, C = x.shape
    got = kmom.column_moments(x)
    want = kmom.column_moments_plain(x)
    torch.cuda.synchronize()
    for i, what in enumerate(("count", "mean", "m2", "min", "max")):
        exact = what in ("count", "min", "max")
        if not (torch.equal(got[i], want[i]) if exact else torch.allclose(got[i], want[i], rtol=1e-5, atol=0)):
            fail(f"column_moments {what} differs from plain: {got[i].tolist()} != {want[i].tolist()}")
    rec = {"max_abs_err": max(float((got[i] - want[i]).abs().max()) for i in (1, 2)), "shape": [R, C],
           "bytes": R * C * 4 + C * 5 * 4,
           "ms": time_ms(lambda: kmom.column_moments(x)), "plain_ms": time_ms(lambda: kmom.column_moments_plain(x)),
           "library_ms": None}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], R * C * 6)
    records["column_moments"] = rec
    log(f"sharded kernels: phase 19 took {time.perf_counter() - phase_t0:.1f} s")
    return records, compose


def sharded_train_path(feed, schema, dlrm_steps_per_s: float, smi: str, profile: bool) -> dict:
    """Phase 20: DLRM on row-sharded tables through shard_params, shard_batch
    and make_train_step on a one-rank NCCL group, phase 7's feed staged anew."""
    import torch.distributed as dist

    from nvtabular_tpu_torch import kernels, models, parallel

    phase_t0 = time.perf_counter()
    config = models.DLRMConfig.from_schema(schema, embedding_dim=TRAIN_DIM, vocab_pad_multiple=SHARD_PAD)
    rows = sum(config.cardinalities.values())
    store = Path("build") / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    parallel.initialize_distributed("nccl", f"file://{store.resolve()}", rank=0, world_size=1, timeout=300)
    rec = {"backend": dist.get_backend(), "world": dist.get_world_size(), "rows": rows}
    try:
        mesh = parallel.local_mesh()
        model = models.DLRM(config, seed=0, device=DEVICE)
        ref = models.DLRM(config, seed=0, device=DEVICE)
        p_specs, b_specs = models.dlrm_param_specs(model), models.batch_specs(config)
        parallel.shard_params(model, p_specs, mesh)
        if model.shard is None or not torch.equal(model.table, ref.table):
            fail("sharded train: shard_params on a one-rank mesh must keep every row")
        rec["padded_rows"] = int(model.table.shape[0])
        opt, ref_opt = models.Adagrad(model.parameters(), lr=1e-2), models.Adagrad(ref.parameters(), lr=1e-2)
        step = parallel.make_train_step(models.dlrm_loss, opt, mesh=mesh, param_specs=p_specs, batch_specs=b_specs)

        def train(chunk):
            n = chunk["label"].shape[0] // TRAIN_BS * TRAIN_BS
            batches = [{k: v[s : s + TRAIN_BS] for k, v in chunk.items()} for s in range(0, n, TRAIN_BS)]
            return torch.stack([step(model, opt, parallel.shard_batch(b, b_specs, mesh)) for b in batches])

        torch.cuda.synchronize()
        kernels.reset_launches()
        with plain_calls_on_card("sharded training"):
            staged = list(feed.chunks())
            # the sharded step against the unsharded one, from the same parameters on the same batches
            parity = [{k: v[s : s + TRAIN_BS] for k, v in c.items()} for c in staged
                      for s in range(0, c["label"].shape[0] - TRAIN_BS + 1, TRAIN_BS)][:SHARD_PARITY_STEPS]
            got = torch.stack([step(model, opt, parallel.shard_batch(b, b_specs, mesh)) for b in parity])
            want = torch.stack([models.train_step(ref, ref_opt, b) for b in parity])
            torch.cuda.synchronize()
            loss_rtol = STEP_TOL["bfloat16"][0]
            rec["parity_loss_rel"] = float(((got - want).abs() / want.abs()).max())
            table_err = (model.table.detach() - ref.table.detach()).abs()
            rec["parity_table_abs"] = float(table_err.max())
            if rec["parity_loss_rel"] > loss_rtol:
                fail(f"sharded train: losses {got.tolist()} differ from the unsharded {want.tolist()} beyond rtol {loss_rtol}")
            if not bool((table_err <= SUM_TOL["rtol"] * ref.table.detach().abs() + SUM_TOL["atol"]).all()):
                fail(f"sharded train: tables differ from the unsharded DLRM's by up to {rec['parity_table_abs']}")
            del ref, ref_opt, table_err
            torch.cuda.empty_cache()
            losses = [got]
            t0 = time.perf_counter()
            losses.append(train(staged[0]))
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            pass_s, i = [], 1
            for _ in range(TRAIN_REPEATS):
                steps = 0
                t0 = time.perf_counter()
                while steps < TRAIN_STEPS:
                    losses.append(train(staged[i % len(staged)]))
                    steps += losses[-1].numel()
                    i += 1
                torch.cuda.synchronize()
                pass_s.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        sharded_steps = sum(int(l.numel()) for l in losses)
        per_chunk = {"permute_rows", "tiny_lookup", "cuckoo_lookup", "cont_chain"}
        want_launches = {k: len(staged) for k in per_chunk}
        want_launches.update(range_gather_columns=sharded_steps, range_scatter_grad=sharded_steps,
                             embedding_gather=len(parity), embedding_scatter_grad=len(parity),
                             interaction_fwd=sharded_steps + len(parity), interaction_bwd=sharded_steps + len(parity))
        check_launches(launches, want_launches, "sharded train")
        all_losses = torch.cat(losses)
        if not bool(torch.isfinite(all_losses).all()):
            fail(f"sharded train: non-finite losses {all_losses.tolist()}")
        step_s = float(np.median(pass_s)) / TRAIN_STEPS
        rec.update(
            warm_chunk_s=warm_s, pass_s=pass_s, steps=sharded_steps, parity_steps=len(parity),
            step_ms=1e3 * step_s, steps_per_s=1.0 / step_s, examples_per_s=TRAIN_BS / step_s,
            dlrm_steps_per_s=dlrm_steps_per_s, first_loss=float(all_losses[0]), last_loss=float(all_losses[-1]),
            launches=launches,
        )
        log(
            f"sharded train: one-rank {rec['backend']} group; {rows} rows padded to {rec['padded_rows']}; "
            f"{len(parity)} steps equal the unsharded DLRM's (losses within rtol {rec['parity_loss_rel']:.2e}, "
            f"tables within {rec['parity_table_abs']:.2e}); {TRAIN_STEPS} steps of {TRAIN_BS}: median of "
            f"{TRAIN_REPEATS} passes {rec['steps_per_s']:.2f} steps/s ({rec['step_ms']:.3f} ms a step; phase 7's "
            f"DLRM {dlrm_steps_per_s:.2f} steps/s), {rec['examples_per_s']:,.0f} examples/s (passes "
            f"{[round(x, 4) for x in pass_s]} s); loss {rec['first_loss']:.6f} -> {rec['last_loss']:.6f} over "
            f"{sharded_steps} steps; launches {launches}; {smi}"
        )
        batch = parallel.shard_batch({k: v[:TRAIN_BS] for k, v in staged[0].items()}, b_specs, mesh)
        if profile:

            def train_two_chunks():
                for c in staged[:2]:
                    train(c)
                torch.cuda.synchronize()

            rec["profile"] = p = profile_pass(train_two_chunks)
            log(f"profile sharded train (8 steps): wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
                f"({p['busy_share']:.1%}), top device kernels {p['top']}, top operators {p['top_ops']}")

        def fwd_bwd():
            opt.zero_grad()
            models.dlrm_loss(model, batch).backward()

        rec["fwd_bwd_ms"] = time_ms(fwd_bwd, iters=10)
        rec["adagrad_ms"] = time_ms(opt.step, iters=10)
        log(f"sharded train: forward + backward {rec['fwd_bwd_ms']:.3f} ms, Adagrad update {rec['adagrad_ms']:.3f} ms "
            f"(device time per step; the gradients' data-axis sums and the loss's add the rest)")
        rec["ids"] = [batch[name] for name in model.names]
        rec["padded"] = list(model.shard.padded)
        del model, opt, staged
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"sharded train: phase 20 took {rec['phase_s']:.1f} s")
    return rec


def sharded_step_kernel_records(dev, sharded_train: dict) -> dict:
    """Phase 21: K15d's two kernels on model shard 1 of MODEL_SHARDS of phase
    20's padded tables, with its first batch's ids, against their plain
    versions on the card; times beside bounds."""
    from nvtabular_tpu_torch.kernels import embedding as kemb

    phase_t0 = time.perf_counter()
    ids, padded = sharded_train["ids"], sharded_train["padded"]
    m = 1
    sizes = [vp // MODEL_SHARDS for vp in padded]
    starts = [m * s for s in sizes]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    cols = (offsets, sizes, starts, padded)
    rows = sum(sizes)
    local = torch.randn((rows, TRAIN_DIM), device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    B, C, D = ids[0].shape[0], len(ids), TRAIN_DIM
    records = {}

    got = kemb.range_gather_columns(local, ids, *cols, m)
    want = kemb.range_gather_columns_plain(local, ids, *cols, m)
    torch.cuda.synchronize()
    if not nan_equal(got, want):
        fail("range_gather_columns differs from plain")
    shard_row, mine, _ = kemb.shard_rows(ids, *cols)
    held = int(mine.sum())
    held_rows = shard_row[mine]
    distinct = int(torch.unique(held_rows).numel())
    # each id's row clamped into its column's shard rows, as phase 19's yardstick
    idx = torch.stack([v.long() for v in ids], 1)
    vp, st = torch.tensor(padded, device=dev), torch.tensor(starts, device=dev)
    local_ids = torch.where(idx < 0, idx + vp, idx) - st
    top = torch.tensor(sizes, device=dev) - 1
    flat = (torch.minimum(local_ids.clamp(min=0), top) + torch.tensor(offsets, device=dev)).reshape(-1)
    rec = {"max_abs_err": 0, "shape": [B, C, rows, D], "in_range": held, "distinct_rows": distinct,
           "bytes": B * C * 4 + distinct * D * 4 + B * C * D * 4,
           "ms": time_ms(lambda: kemb.range_gather_columns(local, ids, *cols, m)),
           "plain_ms": time_ms(lambda: kemb.range_gather_columns_plain(local, ids, *cols, m)),
           "library_ms": time_ms(lambda: torch.index_select(local, 0, flat))}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], 0)
    records["range_gather_columns"] = rec

    gbuf = torch.randn((B, 1 + C, D), device=dev, generator=torch.Generator(device=dev).manual_seed(8))
    grad = gbuf[:, 1:]
    got = kemb.range_scatter_grad(grad, ids, *cols, rows)
    want = kemb.range_scatter_grad_plain(grad, ids, *cols, rows)
    # a hot row sums many terms in a varying order: 1e-5 of their magnitudes
    magnitude = kemb.range_scatter_grad_plain(grad.abs(), ids, *cols, rows)
    torch.cuda.synchronize()
    if not bool(((got - want).abs() <= SUM_TOL["rtol"] * magnitude + SUM_TOL["atol"]).all()):
        fail(f"range_scatter_grad differs from plain: max abs {float((got - want).abs().max())}")
    del magnitude
    grad_held = grad[mine].contiguous()  # the same function: the held ids' rows only
    rec = {"max_abs_err": float((got - want).abs().max()), "shape": [B, C, rows, D], "in_range": held,
           "distinct_rows": distinct, "bytes": rows * D * 4 + B * C * 4 + held * D * 4,
           "ms": time_ms(lambda: kemb.range_scatter_grad(grad, ids, *cols, rows)),
           "plain_ms": time_ms(lambda: kemb.range_scatter_grad_plain(grad, ids, *cols, rows)),
           "library_ms": time_ms(lambda: torch.zeros((rows, D), device=dev).index_add_(0, held_rows, grad_held))}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], held * D)
    records["range_scatter_grad"] = rec
    log(f"sharded step kernels: shard {m} of {MODEL_SHARDS} ({rows} rows), {held} of {B * C} ids held, "
        f"{distinct} distinct rows; phase 21 took {time.perf_counter() - phase_t0:.1f} s")
    return records


def multihot_dlrm_path(feed, schema, smi: str, profile: bool) -> dict:
    """Phase 22: DLRM with the genres multihot table on phase 10's feed
    (DeviceLoader(sparse_max={"genres": 4}) over the first MH_TRAIN_PARTS
    transformed partitions, staged anew) at the JAX config's defaults, then
    the same model row-sharded on a one-rank NCCL group."""
    import torch.distributed as dist

    from nvtabular_tpu_torch import kernels, models, parallel

    phase_t0 = time.perf_counter()
    config = models.DLRMConfig.from_schema(schema, num_dense=1)
    shape = (len(config.cardinalities), dict(config.multihot_cardinalities), config.num_features, config.embedding_dim)
    if shape != (2, {"genres": ML_GENRES + 3}, 4, 64):
        fail(f"multihot dlrm: unexpected config (tables, multihot, features, dim) {shape}")
    model = models.DLRM(config, seed=0, device=DEVICE)
    opt = models.Adagrad(model.parameters(), lr=1e-2)
    table_bytes = sum(p.numel() * 4 for p in [model.table, *model.mh_tables])
    torch.cuda.synchronize()

    def run_passes(train, staged, steps_each):
        """A warm-up chunk, then TRAIN_REPEATS timed passes of steps_each steps."""
        t0 = time.perf_counter()
        losses = [train(staged[0])]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        pass_s, i = [], 1
        for _ in range(TRAIN_REPEATS):
            steps = 0
            t0 = time.perf_counter()
            while steps < steps_each:
                losses.append(train(staged[i % len(staged)]))
                steps += losses[-1].numel()
                i += 1
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
        return losses, warm_s, pass_s

    kernels.reset_launches()
    with plain_calls_on_card("multihot dlrm"):
        t0 = time.perf_counter()
        staged = list(feed.chunks())
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        losses, warm_s, pass_s = run_passes(lambda c: models.train_chunk(model, opt, c, TRAIN_BS), staged, MH_STEPS)
    launches = dict(kernels.LAUNCHES)
    total_steps = sum(int(l.numel()) for l in losses)
    per_chunk = {"direct_lookup", "tiny_lookup", "cont_chain", "ragged_to_padded", "permute_rows"}
    per_step = {"embedding_gather", "embedding_scatter_grad", "embedding_bag_fwd", "embedding_bag_bwd",
                "interaction_fwd", "interaction_bwd"}
    check_launches(launches, {**{k: len(staged) for k in per_chunk}, **{k: total_steps for k in per_step}},
                   "multihot dlrm")
    all_losses = torch.cat(losses)
    if not bool(torch.isfinite(all_losses).all()):
        fail(f"multihot dlrm: non-finite losses {all_losses.tolist()}")
    step_s = float(np.median(pass_s)) / MH_STEPS
    rec = {
        "config": {"cardinalities": dict(config.cardinalities), "multihot": dict(config.multihot_cardinalities),
                   "embedding_dim": config.embedding_dim, "bottom": list(config.bottom_mlp),
                   "top": list(config.top_mlp)},
        "stage_s": stage_s, "warm_chunk_s": warm_s, "pass_s": pass_s, "steps": total_steps,
        "step_ms": 1e3 * step_s, "steps_per_s": 1.0 / step_s, "examples_per_s": TRAIN_BS / step_s,
        "first_loss": float(all_losses[0]), "last_loss": float(all_losses[-1]), "launches": launches,
        "chunks": len(staged), "table_bytes": table_bytes,
    }
    log(
        f"multihot dlrm: {shape[0]} tables {config.cardinalities} + multihot {config.multihot_cardinalities}, "
        f"dim {config.embedding_dim}, {table_bytes:,} table bytes; staged {len(staged)} chunks in {stage_s:.3f} s; "
        f"{MH_STEPS} steps of {TRAIN_BS}: median of {TRAIN_REPEATS} passes {rec['steps_per_s']:.2f} steps/s "
        f"({rec['step_ms']:.3f} ms a step), {rec['examples_per_s']:,.0f} examples/s (passes "
        f"{[round(x, 4) for x in pass_s]} s); loss {rec['first_loss']:.6f} -> {rec['last_loss']:.6f} over "
        f"{total_steps} steps; launches {launches}; {smi}"
    )
    batch = {k: v[:TRAIN_BS] for k, v in staged[0].items()}
    rec["parity"] = check_step_parity(model, batch, models.reference_forward, [model.bottom, model.top])
    log(f"multihot dlrm: one step through the kernels equals the plain versions on the card: {rec['parity']}")
    if profile:

        def train_two_chunks():
            for c in staged[:2]:
                models.train_chunk(model, opt, c, TRAIN_BS)
            torch.cuda.synchronize()

        rec["profile"] = p = profile_pass(train_two_chunks)
        log(f"profile multihot dlrm (14 steps): wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
            f"({p['busy_share']:.1%}), top device kernels {p['top']}, top operators {p['top_ops']}")

    def fwd_bwd():
        opt.zero_grad()
        models.dlrm_loss(model, batch).backward()

    rec["fwd_bwd_ms"] = time_ms(fwd_bwd, iters=10)
    rec["adagrad_ms"] = time_ms(opt.step, iters=10)
    log(f"multihot dlrm: forward + backward {rec['fwd_bwd_ms']:.3f} ms, Adagrad update {rec['adagrad_ms']:.3f} ms "
        f"(device time per step)")
    del model, opt

    # the same model on row-sharded tables: a one-rank NCCL group
    pconfig = models.DLRMConfig.from_schema(schema, num_dense=1, vocab_pad_multiple=SHARD_PAD)
    store = Path("build") / f"nccl_store_mh_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    parallel.initialize_distributed("nccl", f"file://{store.resolve()}", rank=0, world_size=1, timeout=300)
    try:
        mesh = parallel.local_mesh()
        smodel = models.DLRM(pconfig, seed=0, device=DEVICE)
        ref = models.DLRM(pconfig, seed=0, device=DEVICE)
        p_specs, b_specs = models.dlrm_param_specs(smodel), models.batch_specs(pconfig)
        parallel.shard_params(smodel, p_specs, mesh)
        if smodel.shard is None or smodel.shard.bag_padded != (24,) or not torch.equal(smodel.mh_tables[0],
                                                                                        ref.mh_tables[0]):
            fail("multihot dlrm: shard_params on a one-rank mesh must keep every row of the padded genres table")
        sopt, ref_opt = models.Adagrad(smodel.parameters(), lr=1e-2), models.Adagrad(ref.parameters(), lr=1e-2)
        step = parallel.make_train_step(models.dlrm_loss, sopt, mesh=mesh, param_specs=p_specs, batch_specs=b_specs)

        def train(chunk):
            n = chunk["label"].shape[0] // TRAIN_BS * TRAIN_BS
            return torch.stack([step(smodel, sopt, parallel.shard_batch({k: v[s : s + TRAIN_BS] for k, v in
                                                                        chunk.items()}, b_specs, mesh))
                                for s in range(0, n, TRAIN_BS)])

        torch.cuda.synchronize()
        kernels.reset_launches()
        with plain_calls_on_card("multihot dlrm, sharded"):
            parity = [{k: v[s : s + TRAIN_BS] for k, v in c.items()} for c in staged
                      for s in range(0, c["label"].shape[0] - TRAIN_BS + 1, TRAIN_BS)][:SHARD_PARITY_STEPS]
            got = torch.stack([step(smodel, sopt, parallel.shard_batch(b, b_specs, mesh)) for b in parity])
            want = torch.stack([models.train_step(ref, ref_opt, b) for b in parity])
            torch.cuda.synchronize()
            rec["sharded_parity_loss_rel"] = float(((got - want).abs() / want.abs()).max())
            errs = []
            for a, b in ((smodel.table, ref.table), (smodel.mh_tables[0], ref.mh_tables[0])):
                err = (a.detach() - b.detach()).abs()
                errs.append(float(err.max()))
                if not bool((err <= SUM_TOL["rtol"] * b.detach().abs() + SUM_TOL["atol"]).all()):
                    fail(f"multihot dlrm, sharded: tables differ from the unsharded DLRM's by up to {errs[-1]}")
            rec["sharded_parity_table_abs"], rec["sharded_parity_mh_table_abs"] = errs
            if rec["sharded_parity_loss_rel"] > STEP_TOL["bfloat16"][0]:
                fail(f"multihot dlrm, sharded: losses {got.tolist()} differ from the unsharded {want.tolist()}")
            del ref, ref_opt
            slosses, swarm_s, spass_s = run_passes(train, staged, MH_STEPS)
        slaunches = dict(kernels.LAUNCHES)
        sharded_steps = len(parity) + sum(int(l.numel()) for l in slosses)
        check_launches(slaunches, {
            "range_gather_columns": sharded_steps, "range_scatter_grad": sharded_steps, "range_bag": sharded_steps,
            "range_bag_grad": sharded_steps, "embedding_gather": len(parity), "embedding_scatter_grad": len(parity),
            "embedding_bag_fwd": len(parity), "embedding_bag_bwd": len(parity),
            "interaction_fwd": sharded_steps + len(parity), "interaction_bwd": sharded_steps + len(parity),
        }, "multihot dlrm, sharded")
        all_s = torch.cat([got, *slosses])
        if not bool(torch.isfinite(all_s).all()):
            fail(f"multihot dlrm, sharded: non-finite losses {all_s.tolist()}")
        sstep_s = float(np.median(spass_s)) / MH_STEPS
        rec.update(sharded_pass_s=spass_s, sharded_step_ms=1e3 * sstep_s, sharded_steps=sharded_steps,
                   sharded_launches=slaunches, parity_steps=len(parity))
        log(
            f"multihot dlrm, sharded: one-rank {dist.get_backend()} group, vocab_pad_multiple={SHARD_PAD}; "
            f"{len(parity)} steps equal the unsharded DLRM's (losses within rtol "
            f"{rec['sharded_parity_loss_rel']:.2e}, tables within {errs[0]:.2e}, genres within {errs[1]:.2e}); "
            f"{MH_STEPS} steps: median of {TRAIN_REPEATS} passes {rec['sharded_step_ms']:.3f} ms a step (passes "
            f"{[round(x, 4) for x in spass_s]} s; unsharded {rec['step_ms']:.3f} ms in this run); launches {slaunches}"
        )
        sbatch = parallel.shard_batch(batch, b_specs, mesh)
        rec["values"], rec["mask"] = sbatch["genres__values"], sbatch["genres__mask"]
        rec["padded"] = smodel.shard.bag_padded[0]
        del smodel, sopt, staged
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"multihot dlrm: phase 22 took {rec['phase_s']:.1f} s")
    return rec


def layer_entry_path(dev) -> dict:
    """Phase 23's entry points: dot_product_interaction(self_interaction=True)
    on [TRAIN_BS, 27, 16] features and a two-layer CIN (xdeepfm_outer_product,
    26 fields of dim 16, 200 maps a layer) at batch CIN_L2_BATCH, forward and
    backward through autograd, held against the plain layers on the card."""
    from nvtabular_tpu_torch import kernels, models
    from nvtabular_tpu_torch.kernels import cin as kcin
    from nvtabular_tpu_torch.kernels import interaction as kint

    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((TRAIN_BS, SELF_FEATURES, TRAIN_DIM), device=dev, generator=gen)
    x0 = torch.randn((CIN_L2_BATCH, CIN_FIELDS, CIN_DIM), device=dev, generator=gen)
    w1 = torch.randn((CIN_FIELDS * CIN_FIELDS, CIN_MAPS), device=dev, generator=gen) / CIN_FIELDS
    w2 = torch.randn((CIN_MAPS * CIN_FIELDS, CIN_MAPS), device=dev, generator=gen) / (CIN_MAPS * CIN_FIELDS) ** 0.5
    leaves = [t.clone().requires_grad_(True) for t in (x, x0, w1, w2)]

    def forward(fns, xs):
        inter, cin = fns
        xi, xz, a, b = xs
        h1 = cin(xz, xz, a)
        h2 = cin(h1, xz, b)
        return inter(xi).sum() + h1.sum(dim=2).square().mean() + h2.sum(dim=2).square().mean()

    torch.cuda.synchronize()
    kernels.reset_launches()
    with plain_calls_on_card("layer entry points"):
        loss = forward((lambda f: models.dot_product_interaction(f, self_interaction=True),
                        models.xdeepfm_outer_product), leaves)
        loss.backward()
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches(launches, {"interaction_self_fwd": 1, "interaction_self_bwd": 1, "cin_fwd": 2, "cin_bwd": 2},
                   "layer entry points")
    plain = [t.clone().requires_grad_(True) for t in (x, x0, w1, w2)]
    want = forward((lambda f: kint.interaction_fwd_plain(f, True), kcin.cin_fwd_plain), plain)
    want.backward()
    rel = {"loss": abs(float(loss.detach()) - float(want.detach())) / abs(float(want.detach()))}
    for name, got, ref in zip(("x", "x0", "w1", "w2"), leaves, plain):
        if not bool(torch.isfinite(got.grad).all()):
            fail(f"layer entry points: non-finite gradient of {name}")
        rel[name] = float((got.grad - ref.grad).abs().max()) / float(ref.grad.abs().max())
    if not (rel["loss"] <= 1e-5 and max(rel[k] for k in ("x", "x0", "w1", "w2")) <= 1e-4):
        fail(f"layer entry points: kernels vs plain layers differ: {rel} (limits 1e-5 loss, 1e-4 of each "
             "gradient's largest entry)")
    log(f"layer entry points: self-interaction and a two-layer CIN through the kernels equal the plain layers "
        f"(relative errors {rel}); launches {launches}")
    return {"launches": launches, "rel_err": rel}


def layer_kernel_records(dev, mh: dict) -> dict:
    """Phase 23: K15d's bag on model shard 1 of MODEL_SHARDS of phase 22's
    padded genres table with its first batch's values, K13b's self mode at
    [TRAIN_BS, 27, 16] and K13d at xDeepFM's layers 1 and 2, each against
    its plain version on the card, timed beside its bound."""
    from nvtabular_tpu_torch.kernels import cin as kcin
    from nvtabular_tpu_torch.kernels import embedding_bag as kbag
    from nvtabular_tpu_torch.kernels import interaction as kint

    phase_t0 = time.perf_counter()
    records = {}
    gen = torch.Generator(device=dev).manual_seed(23)

    # K15d's bag: the genres shard's rows, the [B, 3, 64] buffer's bag slot as the sharded step passes it
    values, mask, vp = mh["values"], mh["mask"], mh["padded"]
    (B, L), D, m = values.shape, 64, 1
    rows = vp // MODEL_SHARDS
    start = m * rows
    local = torch.randn((rows, D), device=dev, generator=gen)
    buf = torch.zeros((B, 3, D), device=dev)
    out = buf[:, 2]
    got = kbag.range_bag(local, values, mask, start, vp, m, out=out)
    want = kbag.range_bag_plain(local, values, mask, start, vp, m)
    torch.cuda.synchronize()
    if not nan_equal(got, want):
        fail("range_bag differs from plain")
    shard_row, mine, _ = kbag.bag_shard_rows(values, start, rows, vp)
    held = int(mine.sum())
    weights = (mask * mine).contiguous()
    distinct = int(torch.unique(shard_row[mine]).numel())
    rec = {"max_abs_err": 0, "shape": [B, L, rows, D], "in_range": held, "distinct_rows": distinct,
           "bytes": B * L * 8 + distinct * D * 4 + B * D * 4,
           "ms": time_ms(lambda: kbag.range_bag(local, values, mask, start, vp, m, out=out)),
           "plain_ms": time_ms(lambda: kbag.range_bag_plain(local, values, mask, start, vp, m)),
           "library_ms": time_ms(lambda: torch.nn.functional.embedding_bag(shard_row, local, per_sample_weights=weights,
                                                                          mode="sum"))}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], held * D * 2)
    records["range_bag"] = rec

    gbuf = torch.randn((B, 3, D), device=dev, generator=gen)
    grad = gbuf[:, 2]
    got = kbag.range_bag_grad(grad, values, mask, start, rows, vp)
    want = kbag.range_bag_grad_plain(grad, values, mask, start, rows, vp)
    magnitude = kbag.range_bag_grad_plain(grad.abs(), values, mask, start, rows, vp)
    torch.cuda.synchronize()
    # 65,536 x 4 terms on 6 rows, summed in a varying order: 1e-5 of their magnitudes
    if not bool(((got - want).abs() <= SUM_TOL["rtol"] * magnitude + SUM_TOL["atol"]).all()):
        fail(f"range_bag_grad differs from plain: max abs {float((got - want).abs().max())}")
    cnt = kbag.bag_counts(mask)[:, None]
    terms = ((grad / cnt)[:, None, :] * mask[..., None])[mine].contiguous()
    held_rows = shard_row[mine]
    rec = {"max_abs_err": float((got - want).abs().max()), "shape": [B, L, rows, D], "in_range": held,
           "bytes": rows * D * 4 + B * L * 8 + B * D * 4,
           "ms": time_ms(lambda: kbag.range_bag_grad(grad, values, mask, start, rows, vp)),
           "plain_ms": time_ms(lambda: kbag.range_bag_grad_plain(grad, values, mask, start, rows, vp)),
           # the held ids' weighted terms precomputed outside the timing
           "library_ms": time_ms(lambda: torch.zeros((rows, D), device=dev).index_add_(0, held_rows, terms)),
           "hottest_row_hits": int(torch.bincount(held_rows[mask[mine] > 0]).max())}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], held * D * 3)
    records["range_bag_grad"] = rec
    del terms, magnitude

    # K13b's self mode on DLRM's 27 features of dim 16, written after the bottom output
    F, Dx = SELF_FEATURES, TRAIN_DIM
    P = F * (F + 1) // 2
    x = torch.randn((TRAIN_BS, F, Dx), device=dev, generator=gen)
    obuf = torch.empty((TRAIN_BS, Dx + P), device=dev)
    got = kint.interaction_fwd(x, out=obuf[:, Dx:], self_interaction=True)
    want = kint.interaction_fwd_plain(x, True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):  # the same roundings in the same order
        fail(f"interaction self fwd differs from plain: max abs {float((got - want).abs().max())}")
    rec = {"max_abs_err": 0, "shape": [TRAIN_BS, F, Dx, P],
           "bytes": TRAIN_BS * (F * Dx + P) * 4,
           "ms": time_ms(lambda: kint.interaction_fwd(x, out=obuf[:, Dx:], self_interaction=True)),
           "plain_ms": time_ms(lambda: kint.interaction_fwd_plain(x, True)),
           "library_ms": time_ms(lambda: torch.bmm(x, x.transpose(1, 2)))}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], TRAIN_BS * P * Dx * 2)
    records["interaction_self_fwd"] = rec
    gbuf = torch.randn((TRAIN_BS, Dx + P), device=dev, generator=gen)
    g = gbuf[:, Dx:]
    got = kint.interaction_bwd(x, g, self_interaction=True)
    want = kint.interaction_bwd_plain(x, g, True)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, **SUM_TOL):
        fail(f"interaction self bwd differs from plain: max abs {float((got - want).abs().max())}")
    # the library call: the symmetric [F, F] gradient (built outside the timing) times x
    rows_i, cols_i = np.tril_indices(F, 0)
    gsym = torch.zeros((TRAIN_BS, F, F), device=dev)
    gsym[:, rows_i, cols_i] = g
    gsym = gsym + gsym.transpose(1, 2)
    rec = {"max_abs_err": float((got - want).abs().max()), "shape": [TRAIN_BS, F, Dx, P],
           "bytes": TRAIN_BS * (2 * F * Dx + P) * 4,
           "ms": time_ms(lambda: kint.interaction_bwd(x, g, self_interaction=True)),
           "plain_ms": time_ms(lambda: kint.interaction_bwd_plain(x, g, True)),
           "library_ms": time_ms(lambda: torch.bmm(gsym, x))}
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], TRAIN_BS * F * F * Dx * 2)
    records["interaction_self_bwd"] = rec
    del x, obuf, gbuf, gsym

    # K13d at xDeepFM's layers 1 and 2
    for layer, (Bc, Hk) in enumerate(((TRAIN_BS, CIN_FIELDS), (CIN_L2_BATCH, CIN_MAPS)), start=1):
        F, Dc, Hn = CIN_FIELDS, CIN_DIM, CIN_MAPS
        x0 = torch.randn((Bc, F, Dc), device=dev, generator=gen)
        xk = x0 if layer == 1 else torch.randn((Bc, Hk, Dc), device=dev, generator=gen)
        w = torch.randn((Hk * F, Hn), device=dev, generator=gen) / (Hk * F) ** 0.5
        gout = torch.randn((Bc, Hn, Dc), device=dev, generator=gen)
        N, K = Bc * Dc, Hk * F
        got = kcin.cin_fwd(xk, x0, w)
        want = kcin.cin_fwd_plain(xk, x0, w)
        magnitude = kcin.cin_fwd_plain(xk.abs(), x0.abs(), w.abs())
        torch.cuda.synchronize()
        if not bool(((got - want).abs() <= SUM_TOL["rtol"] * magnitude + SUM_TOL["atol"]).all()):
            fail(f"cin_fwd (layer {layer}) differs from plain: max abs {float((got - want).abs().max())}")
        suffix = "" if layer == 1 else "_layer2"
        w3 = w.view(Hk, F, Hn)
        in_bytes = (xk.numel() + (0 if xk is x0 else x0.numel()) + w.numel()) * 4  # layer 1's x_k is x_0
        rec = {"max_abs_err": float((got - want).abs().max()), "shape": [Bc, Hk, F, Dc, Hn],
               "bytes": in_bytes + Bc * Hn * Dc * 4,
               "ms": time_ms(lambda: kcin.cin_fwd(xk, x0, w), iters=5),
               "plain_ms": time_ms(lambda: kcin.cin_fwd_plain(xk, x0, w), iters=5),
               "library_ms": time_ms(lambda: torch.einsum("bid,bjd,ijh->bhd", xk, x0, w3), iters=5)}
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], N * K * (2 * Hn + 1))
        records["cin_fwd" + suffix] = rec
        del got, want, magnitude
        grads = kcin.cin_bwd(xk, x0, w, gout)
        wants = kcin.cin_bwd_plain(xk, x0, w, gout)
        mags = kcin.cin_bwd_plain(xk.abs(), x0.abs(), w.abs(), gout.abs())
        torch.cuda.synchronize()
        errs = []
        for name, got, want, mag in zip(("dx_k", "dx_0", "dw"), grads, wants, mags):
            errs.append(float((got - want).abs().max()))
            if not bool(((got - want).abs() <= SUM_TOL["rtol"] * mag + SUM_TOL["atol"]).all()):
                fail(f"cin_bwd (layer {layer}) {name} differs from plain: max abs {errs[-1]}")
        del grads, wants, mags
        rec = {"max_abs_err": max(errs), "shape": [Bc, Hk, F, Dc, Hn],
               # the inputs and g read, dx_k, dx_0 and dw written
               "bytes": in_bytes + Bc * Hn * Dc * 4 + (xk.numel() + x0.numel() + w.numel()) * 4,
               "ms": time_ms(lambda: kcin.cin_bwd(xk, x0, w, gout), iters=5),
               "plain_ms": time_ms(lambda: kcin.cin_bwd_plain(xk, x0, w, gout), iters=5),
               "library_ms": None}
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], N * K * (4 * Hn + 5))
        records["cin_bwd" + suffix] = rec
        del x0, xk, w, gout
        torch.cuda.empty_cache()
    log(f"layer kernels: phase 23 took {time.perf_counter() - phase_t0:.1f} s")
    return records


# phase 24: the Criteo fields with under 2,000 distinct values in bench.py:99's profile
SMALL_CAT_LIMIT = 2000
# float16 card vs CPU: log1p's float32 ULP between CUDA's log1pf and the CPU's
# can move the cast input one float16 ULP, and the division rounds again
F16_ULPS = 2
# phase 25: ~1% of ts_delta NaN; Groupby's aggregations; ListSlice's last 20 movies
SESSION_NAN_SHARE, SESSION_SLICE = 0.01, 20
SESSION_AGGS = {"movieId": ["list", "count"], "rating": ["list", "sum", "mean", "min", "max"],
                "ts_delta": ["first", "last"]}
SESSION_COLUMNS = ["userId", "movieId_list", "movieId_count", "rating_list", "rating_sum", "rating_mean",
                   "rating_min", "rating_max", "ts_delta_first", "ts_delta_last"]
# K11c's float32 sums against float64 ones: relative to the row's sum of |v|
SEGMENT_SUM_TOL = 1e-5


def alt_graphs(ops, cat_names, cont_names):
    """Phase 24's two workflows: Criteo's alternative continuous chain with
    the small categoricals (24a), and the missing-value indicators (24b)."""
    small = [c for c, card in zip(cat_names, CRITEO_TB_CARDINALITIES) if card < SMALL_CAT_LIMIT]

    def dense():
        return (cont_names >> ops.FillMedian() >> ops.Clip(min_value=0.0) >> ops.LogOp()
                >> ops.NormalizeMinMax(out_dtype="float16"))

    def graph_a():
        cats = (small >> ops.Categorify() >> ops.DropLowCardinality(min_cardinality=4) >> ops.ReduceDtypeSize()
                >> ops.AddTags(["criteo_small"]))
        return dense() + cats

    def graph_b():
        return cont_names >> ops.FillMissing(add_binary_cols=True)

    return small, graph_a, graph_b


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float16 or bfloat16 values apart in ULPs (0 where both are NaN)."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    dist = (ordered(a) - ordered(b)).abs()
    return torch.where(a.isnan() & b.isnan(), 0, dist)


def compare_16bit(got, want, what) -> dict:
    """Card against CPU: column names and dtypes equal, integer and bool
    columns exact, float32 within CPU_TOL, 16-bit floats within F16_ULPS
    ULPs; the count of 16-bit values at each distance."""
    if got.column_names != want.column_names:
        fail(f"{what}: columns {got.column_names} != {want.column_names}")
    counts = {}
    for name in want.column_names:
        g, w = got[name].values.cpu(), want[name].values
        if g.dtype != w.dtype:
            fail(f"{what}: {name} dtype {g.dtype} != {w.dtype}")
        if g.dtype in (torch.float16, torch.bfloat16):
            dist = ulp_distance(g, w)
            for d, c in zip(*torch.unique(dist, return_counts=True)):
                counts[int(d)] = counts.get(int(d), 0) + int(c)
            if int(dist.max()) > F16_ULPS:
                fail(f"{what}: {name} differs by {int(dist.max())} ULPs")
        elif g.is_floating_point():
            if not torch.allclose(g, w, **CPU_TOL, equal_nan=True):
                fail(f"{what}: {name} differs, max abs {float((g - w).abs().nan_to_num().max())}")
        elif not torch.equal(g, w):
            fail(f"{what}: {name} differs in {int((g != w).sum())} rows")
    return counts


def alt_criteo_path(nvt, dev, parts, cat_names, cont_names) -> dict:
    """Phase 24: Criteo's alternative continuous chain (FillMedian → Clip →
    LogOp → NormalizeMinMax(float16): one K5 launch a batch), the small
    categoricals (Categorify → DropLowCardinality → ReduceDtypeSize →
    AddTags) and the missing-value indicators (FillMissing(add_binary_cols):
    K5's mask, one launch a batch) on phase 3's partitions."""
    from nvtabular_tpu_torch import kernels, ops

    phase_t0 = time.perf_counter()
    small, graph_a, graph_b = alt_graphs(ops, cat_names, cont_names)
    rows_total = NUM_PARTS * ROWS_PER_PART
    rec = {"small_columns": small}
    for key, make_graph, want in [
        ("a", graph_a, {"cont_chain_16": NUM_PARTS, "tiny_lookup": 2 * NUM_PARTS}),
        ("b", graph_b, {"cont_chain_mask": NUM_PARTS}),
    ]:
        wf = nvt.Workflow(make_graph(), device=dev)
        dataset = nvt.Dataset(parts)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with plain_calls_on_card(f"phase 24{key}"):
            wf.fit(dataset)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            outs = [wf.transform(b) for b in dataset.to_batches()]
            torch.cuda.synchronize()
        first_pass_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        log(f"phase 24{key}: fit {fit_s:.2f} s, first transform pass {first_pass_s:.2f} s, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        # 24a's tiny lookups: ReduceDtypeSize's fit reads Categorify's codes, then the transform
        check_launches(launches, want, f"phase 24{key}")
        cpu_wf = nvt.Workflow(make_graph(), device="cpu")
        nvt.load_fitted_state(cpu_wf, nvt.fitted_state(wf))
        ulps = compare_16bit(outs[0], cpu_wf.transform(parts[0]), f"phase 24{key} vs cpu")
        schema = {cs.name: cs.dtype.name for cs in wf.output_schema}
        for out in outs:
            for name, col in out.columns.items():
                if col.values.shape[0] != ROWS_PER_PART or col.device != dev:
                    fail(f"phase 24{key}: {name} has shape {tuple(col.values.shape)} on {col.device}")
        with_h2d_all, _ = transform_rates(wf, parts, rows_total)
        on_card = [wf.executor.stage(b) for b in parts]
        torch.cuda.synchronize()
        without_h2d_all, _ = transform_rates(wf, on_card, rows_total)
        rec[key] = {"fit_s": fit_s, "first_pass_s": first_pass_s, "launches": launches, "dtypes": schema,
                    "rows_per_s_with_h2d": with_h2d_all, "rows_per_s_without_h2d": without_h2d_all,
                    "f16_ulps_vs_cpu": ulps, "wf": wf, "staged": on_card[0]}
        log(f"phase 24{key}: no plain version on the card; batch 0 equals the CPU run (codes, masks and dtypes "
            f"exact, float16 values by ULPs apart {ulps}); output dtypes {schema}; "
            f"transform median of {REPEATS} passes {float(np.median(with_h2d_all)):,.0f} rows/s with the "
            f"host-to-device copy, {float(np.median(without_h2d_all)):,.0f} rows/s from batches on the card")
        del outs, on_card
    kept = [c for c in small if c in rec["a"]["dtypes"]]
    log(f"phase 24a: small categoricals {small}, kept by DropLowCardinality {kept}")
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"phase 24 took {rec['phase_s']:.1f} s")
    return rec


def session_graph(ops):
    """Phase 25: sessions — Dropna → Filter(rating >= 3) → Groupby by user,
    sorted by ts_delta; ValueCount of the lists; the last 20 movies padded."""
    g = (["userId", "movieId", "rating", "ts_delta"] >> ops.Dropna()
         >> ops.Filter(lambda b: np.asarray(b["rating"]) >= 3.0)
         >> ops.Groupby("userId", sort_cols=["ts_delta"], aggs=SESSION_AGGS))
    vc = g[SESSION_COLUMNS] >> ops.ValueCount()
    rest = [c for c in SESSION_COLUMNS if c != "movieId_list"]
    return vc[rest] + (vc["movieId_list"] >> ops.ListSlice(-SESSION_SLICE, pad=True))


def session_tables(nvt, ml_parts):
    """Phase 9's partitions with ~1% of ts_delta NaN, drawn from the seed."""
    tables = []
    for s, p in enumerate(ml_parts):
        ts = p["ts_delta"].copy()
        ts[np.random.default_rng(20_000 + s).random(len(ts)) < SESSION_NAN_SHARE] = np.nan
        tables.append(nvt.TableBatch({"userId": nvt.Column(p["userId"]), "movieId": nvt.Column(p["movieId"]),
                                      "rating": nvt.Column(p["rating"]), "ts_delta": nvt.Column(ts)}))
    return tables


def check_segment_reduce(got, lists, ref, combiner, what):
    """K11c against Groupby's own column: min and max exact, sum and mean
    within SEGMENT_SUM_TOL of the row's float64 sum (mean) of |v|."""
    if combiner in ("min", "max"):
        if not torch.equal(got, ref):
            fail(f"{what}: {combiner} differs from Groupby's in {int((got != ref).sum())} rows")
        return 0.0
    from nvtabular_tpu_torch.kernels import ragged as kragged

    scale = kragged.ragged_segment_reduce_plain(lists.values.abs(), lists.offsets, len(lists), combiner).double()
    err = (got.double() - ref.double()).abs()
    if not bool((err <= SEGMENT_SUM_TOL * scale + 1e-6).all()):
        fail(f"{what}: {combiner} beyond {SEGMENT_SUM_TOL} of the rows' |v| sums, max err {float(err.max())}")
    return float(err.max())


def session_path(nvt, dev, ml_parts) -> dict:
    """Phase 25: shuffle_by_keys(["userId"]) on the card (K7), then each
    partition through session_graph (host ops; K11b's ListSlice on the
    card), then K11c over each partition's rating_list, held against
    Groupby's own sum / mean / min / max and every partition against the CPU
    run."""
    from nvtabular_tpu_torch import kernels, ops
    from nvtabular_tpu_torch.kernels import ragged as kragged

    phase_t0 = time.perf_counter()
    tables = session_tables(nvt, ml_parts)
    rows_total = sum(t.num_rows for t in tables)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with plain_calls_on_card("phase 25"):
        t0 = time.perf_counter()
        shuffled = nvt.Dataset(tables).shuffle_by_keys(["userId"], device=dev)
        torch.cuda.synchronize()
        shuffle_s = time.perf_counter() - t0
        wf = nvt.Workflow(session_graph(ops), device=dev)
        t0 = time.perf_counter()
        wf.fit(shuffled)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        ex = wf.executor
        h0, s0 = ex.host_handoffs, ex.host_handoff_seconds
        t0 = time.perf_counter()
        outs = [wf.transform(b) for b in shuffled.to_batches()]
        torch.cuda.synchronize()
        transform_s = time.perf_counter() - t0
        handoff_ms = 1e3 * (ex.host_handoff_seconds - s0) / max(ex.host_handoffs - h0, 1)
        reduced = []
        for out in outs:
            lists = out["rating_list"]
            reduced.append({c: kragged.ragged_segment_reduce(lists.values, lists.offsets, len(lists), c)
                            for c in ("sum", "mean", "min", "max")})
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    nparts = shuffled.npartitions
    check_launches(launches, {"hashed_cross": ML_PARTS, "ragged_slice_padded": nparts,
                              "ragged_segment_reduce": 4 * nparts}, "phase 25")
    # every user in one partition, every row kept by the shuffle
    users = [set(b["userId"].values.tolist()) for b in shuffled.to_batches()]
    if sum(len(u) for u in users) != len(set().union(*users)) or shuffled.num_rows != rows_total:
        fail("phase 25: the shuffle split a user over partitions or lost rows")
    cpu_shuffled = nvt.Dataset(tables).shuffle_by_keys(["userId"], device="cpu")
    for got, want in zip(shuffled.to_batches(), cpu_shuffled.to_batches()):
        for name in want.column_names:
            if not nan_equal(got[name].values, want[name].values):
                fail(f"phase 25: shuffled partitions differ from the CPU shuffle in {name}")
    cpu_wf = nvt.Workflow(session_graph(ops), device="cpu")
    nvt.load_fitted_state(cpu_wf, nvt.fitted_state(wf))
    groups = 0
    max_err = {"sum": 0.0, "mean": 0.0, "min": 0.0, "max": 0.0}
    for i, (batch, out, red) in enumerate(zip(cpu_shuffled.to_batches(), outs, reduced)):
        want = cpu_wf.transform(batch)
        if out.column_names != want.column_names:
            fail(f"phase 25: columns {out.column_names} != {want.column_names}")
        for name in want.column_names:
            g, w = out[name], want[name]
            if g.values.dtype != w.values.dtype or not nan_equal(g.values.cpu().double(), w.values.double()):
                fail(f"phase 25 partition {i}: {name} differs from the CPU run")
            if (g.offsets is None) != (w.offsets is None) or (
                    w.offsets is not None and not torch.equal(g.offsets.cpu(), w.offsets)):
                fail(f"phase 25 partition {i}: {name} offsets differ from the CPU run")
        groups += out.num_rows
        lists = want["rating_list"]
        for c, got in red.items():
            err = check_segment_reduce(got.cpu(), lists, want[f"rating_{c}"].values, c, f"phase 25 partition {i}")
            max_err[c] = max(max_err[c], err)
    lengths = torch.cat([o["rating_list"].row_lengths for o in outs])
    rec = {
        "shuffle_s": shuffle_s, "fit_s": fit_s, "transform_s": transform_s, "rows": rows_total,
        "partitions": nparts, "groups": groups, "rows_per_s": rows_total / transform_s,
        "handoff_ms_a_batch": handoff_ms, "launches": launches, "k11c_vs_groupby_max_err": max_err,
        "longest_list": int(lengths.max()), "values_in_lists": int(lengths.sum()),
        "lists": [o["rating_list"] for o in outs],
    }
    log(f"phase 25: shuffle_by_keys {shuffle_s:.2f} s into {nparts} partitions, fit {fit_s:.2f} s, transform "
        f"{transform_s:.2f} s ({rec['rows_per_s']:,.0f} rows/s, host handoff {handoff_ms:.2f} ms a batch), "
        f"{groups} sessions, {rec['values_in_lists']} ratings in lists (longest {rec['longest_list']}); "
        f"launches { {k: v for k, v in launches.items() if v} } (no plain version on the card); every partition "
        f"equals the CPU run (keys, offsets, lists, counts exact, floats bit-equal); K11c against Groupby: min "
        f"and max exact, sum and mean within {SEGMENT_SUM_TOL} of the rows' |v| (max err {max_err})")
    rec["phase_s"] = time.perf_counter() - phase_t0
    log(f"phase 25 took {rec['phase_s']:.1f} s")
    return rec


def slice11_kernel_records(dev, alt: dict, sess: dict) -> dict:
    """Phase 26: K5's 16-bit and mask modes on phase 24's [13, 262144]
    batch and K11c on all of phase 25's rating lists at once (the zipf head
    user's row among them), each against its plain version on the card."""
    from nvtabular_tpu_torch.dag.device_fuse import extract_chain
    from nvtabular_tpu_torch.kernels import cont_chain as kcc
    from nvtabular_tpu_torch.kernels import ragged as kragged

    phase_t0 = time.perf_counter()
    records = {}
    for key, mode in (("a", "cont_chain_16"), ("b", "cont_chain_mask")):
        wf, staged = alt[key]["wf"], alt[key]["staged"]
        tail = next(n for n in wf.graph.nodes if type(n.op).__name__ in ("NormalizeMinMax", "FillMissing"))
        spec = extract_chain(tail)
        params, flags = spec.kernel_args(dev)
        x = torch.stack([staged[c].values for c in spec.names])
        run = lambda: kcc.cont_chain(x, None, params, flags, spec.out_dtype, spec.mask)  # noqa: E731
        plain = lambda: kcc.cont_chain_plain(x, None, params, flags, spec.out_dtype, spec.mask)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        if spec.mask:
            if not torch.equal(got[1], want[1]) or not torch.equal(got[0], want[0]):
                fail("cont_chain_mask: the kernel differs from its plain version")
            err = 0.0
        else:  # the plain version's log1p on the card is CUDA's log1pf too
            err = float((got.float() - want.float()).abs().nan_to_num().max())
            if int(ulp_distance(got, want).max()) > F16_ULPS:
                fail(f"cont_chain_16: the kernel differs from its plain version by over {F16_ULPS} ULPs")
        C, n = x.shape
        out_bytes = C * n * (2 if spec.out_dtype != torch.float32 else 4) + (C * n if spec.mask else 0)
        rec = {"max_abs_err": err, "ms": time_ms(run), "plain_ms": time_ms(plain), "library_ms": None,
               "shape": [C, n], "bytes": C * n * 4 + out_bytes}
        rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], C * n * 14)
        records[mode] = rec

    lists = [l.to(dev) for l in sess["lists"]]
    values = torch.cat([l.values for l in lists])
    ends = torch.cumsum(torch.tensor([len(l.values) for l in lists], device=dev), 0)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), ends[:-1]])
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev)]
                        + [l.offsets[1:] + s for l, s in zip(lists, starts)])
    R = offsets.shape[0] - 1
    lengths = offsets[1:] - offsets[:-1]
    timings = {}
    for combiner in ("sum", "mean", "min", "max"):
        run = lambda c=combiner: kragged.ragged_segment_reduce(values, offsets, R, c)  # noqa: E731
        plain = lambda c=combiner: kragged.ragged_segment_reduce_plain(values, offsets, R, c)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        if combiner in ("min", "max"):
            if not torch.equal(got, want):
                fail(f"ragged_segment_reduce {combiner}: the kernel differs from its plain version")
            err = 0.0
        else:
            # each within SEGMENT_SUM_TOL of the float64 sum, so within twice that of each other
            scale = kragged.ragged_segment_reduce_plain(values.abs(), offsets, R, combiner).double()
            diff = (got.double() - want.double()).abs()
            err = float(diff.max())
            if not bool((diff <= 2 * SEGMENT_SUM_TOL * scale + 1e-6).all()):
                fail(f"ragged_segment_reduce {combiner}: kernel and plain beyond the tolerance, max abs {err}")
        lib_ms = None
        if hasattr(torch, "segment_reduce"):
            lib_ms = time_ms(lambda c=combiner: torch.segment_reduce(values, c, lengths=lengths))
        timings[combiner] = {"max_abs_err": err, "ms": time_ms(run), "plain_ms": time_ms(plain), "library_ms": lib_ms}
    rec = dict(timings["sum"], shape=[int(values.shape[0]), R], bytes=int(values.shape[0]) * 4 + (R + 1) * 8 + R * 4,
               combiners=timings, head_row=int(lengths.max()))
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], int(values.shape[0]))
    records["ragged_segment_reduce"] = rec
    log(f"phase 26: K11c over {values.shape[0]} values in {R} rows (the longest {rec['head_row']}): "
        + ", ".join(f"{c} {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
                    f"{'none' if t['library_ms'] is None else format(t['library_ms'], '.4f')})"
                    for c, t in timings.items()))
    log(f"phase 26 took {time.perf_counter() - phase_t0:.1f} s")
    return records


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the full record as JSON here")
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace 4 transform batches and 8 training steps with torch.profiler: "
        "device busy share and top device ops",
    )
    opts = parser.parse_args()

    # --- 1. device -------------------------------------------------------------
    run_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    import nvtabular_tpu_torch as nvt
    from nvtabular_tpu_torch import models, ops
    from nvtabular_tpu_torch.dag.device_fuse import extract_chain
    from nvtabular_tpu_torch.kernels import build as kbuild
    from nvtabular_tpu_torch.kernels import cont_chain as kcc
    from nvtabular_tpu_torch.kernels import lookup as klk

    dev = torch.device(DEVICE)
    # DLRM's MLPs multiply bfloat16-rounded values as float32 (mlp_apply's
    # numerics); TF32 would round them again
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # --- 2. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    kbuild.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(kbuild.SOURCES)} libraries in {build_s:.1f} s")
    for name, report in kbuild.PTXAS_REPORT.items():
        for line in report.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line or "Compiling" in line):
                log(f"  [{name}] {line.strip()}")

    # --- 3. main path: the Criteo workflow ---------------------------------------
    t0 = time.perf_counter()
    parts = [nvt.TableBatch.from_pydict(make_part(s)) for s in range(NUM_PARTS)]
    log(f"data: {NUM_PARTS} x {ROWS_PER_PART} rows in {time.perf_counter() - t0:.1f} s")
    cat_names = [f"C{i}" for i in range(NUM_CATS)]
    cont_names = [f"I{i}" for i in range(NUM_CONTS)]

    def criteo_graph():
        cats = cat_names >> ops.Categorify(max_size=10_000_000)
        conts = cont_names >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.Normalize()
        return cats + conts + ["label"]

    wf = nvt.Workflow(criteo_graph(), device=dev)
    fit_s, first_s, main_launches, outs = drive(
        nvt, wf, parts, cont_names, {"tiny_lookup", "cuckoo_lookup", "cont_chain"}, "criteo"
    )
    cat_node = next(n for n in wf.graph.nodes if isinstance(n.op, ops.Categorify))
    cat_op = cat_node.op
    kinds = {k: len(row_index) for k, (_, row_index) in cat_op._get_batched().items()}
    vocab_keys = sum(len(v.values_by_code) for v in cat_op.vocabs.values())
    log(
        f"criteo: fit {fit_s:.2f} s (scan {wf.last_fit_stats['scan_seconds']:.2f} s, finalize "
        f"{wf.last_fit_stats['finalize_seconds']:.2f} s), {vocab_keys} vocabulary keys, "
        f"columns per table kind {kinds}, first transform pass {first_s:.2f} s, "
        f"launches {main_launches}"
    )
    check_against_cpu(nvt, criteo_graph, wf, parts[0], outs[0], cont_names, "criteo vs cpu")
    log("criteo: batch 0 equals the CPU run (codes exact, floats within rtol=1e-5, atol=1e-5)")

    # --- 4. kernels at main-path shapes ---------------------------------------------
    records = {}
    staged = wf.executor.stage(parts[0])
    state = wf.executor.op_state(cat_op, dev)
    jobs = {j["kind"]: j for j in cat_op.lookup_jobs(cat_node.selector, staged, state)}
    if set(jobs) != {"tiny", "cuckoo"}:
        fail(f"criteo: expected tiny and cuckoo tables, got {sorted(jobs)}")
    n = ROWS_PER_PART

    j = jobs["tiny"]
    t = j["table"]
    args = (j["values"], j["validity"], t.keys, t.codes, t.lens, j["sel"], j["col_offsets"])
    rec = lookup_record(j, klk.tiny_lookup_plain, args, lambda: klk.tiny_lookup(*args))
    C = j["values"].shape[0]
    rows = torch.unique(j["sel"].long())
    table_bytes = int(t.lens[rows].sum()) * 8
    probes = int(torch.log2(t.lens[j["sel"].long()].float() + 1).ceil().sum()) * n
    rec.update(shape=[C, n], bytes=C * n * 8 + table_bytes)
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], probes * 2)
    records["tiny_lookup"] = rec

    j = jobs["cuckoo"]
    t = j["table"]
    args = (j["values"], j["validity"], t.table, t.nbs, t.row_offsets, j["sel"], j["col_offsets"])
    rec = lookup_record(j, klk.cuckoo_lookup_plain, args, lambda: klk.cuckoo_lookup(*args))
    C = j["values"].shape[0]
    s = j["sel"].long()
    buckets = torch.cat(
        [
            (klk.bucket_index_plain(j["values"], t.nbs[s][:, None], seed) + t.row_offsets[s][:, None]).flatten()
            for seed in klk.SEEDS
        ]
    )
    sectors = int(torch.unique(buckets).numel())
    rec.update(shape=[C, n], bytes=C * n * 8 + sectors * 32, table_bytes=t.nbytes,
               probe_bytes=C * n * 8 + 2 * C * n * 32)
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], C * n * 40)
    records["cuckoo_lookup"] = rec

    norm_node = next(nd for nd in wf.graph.nodes if isinstance(nd.op, ops.Normalize))
    spec = extract_chain(norm_node)
    if spec is None:
        fail("criteo: the continuous chain is not fused")
    params, flags = spec.kernel_args(dev)
    x = torch.stack([staged[c].values for c in spec.names])
    got = kcc.cont_chain(x, None, params, flags)
    want = kcc.cont_chain_plain(x, None, params, flags)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, **CONT_TOL, equal_nan=False):
        fail(f"cont_chain kernel differs from plain: max abs {float((got - want).abs().max())}")
    C = x.shape[0]
    rec = {
        "max_abs_err": float((got - want).abs().max()),
        "ms": time_ms(lambda: kcc.cont_chain(x, None, params, flags)),
        "plain_ms": time_ms(lambda: kcc.cont_chain_plain(x, None, params, flags)),
        "library_ms": None,
        "shape": [C, n],
        "bytes": C * n * 8,
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], C * n * 12)
    records["cont_chain"] = rec

    # --- 5. throughput, with and without the host-to-device copy --------------------
    rows_total = NUM_PARTS * ROWS_PER_PART
    transform_all(wf, parts[:2])
    with_h2d_all, _ = transform_rates(wf, parts, rows_total)
    on_card = [wf.executor.stage(b) for b in parts]
    torch.cuda.synchronize()
    without_h2d_all, _ = transform_rates(wf, on_card, rows_total)
    with_h2d, without_h2d = float(np.median(with_h2d_all)), float(np.median(without_h2d_all))
    profiles = {}
    if opts.profile:
        profiles = {
            "with_h2d": profile_pass(lambda: transform_all(wf, parts[:4])),
            "without_h2d": profile_pass(lambda: transform_all(wf, on_card[:4])),
        }
        for what, p in profiles.items():
            log(f"profile {what}: wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
                f"({p['busy_share']:.1%}), top device kernels {p['top']}")
    del on_card, outs
    log(
        f"criteo: fit {fit_s:.2f} s; transform median of {REPEATS} passes {with_h2d:,.0f} rows/s "
        f"(min {with_h2d_all[0]:,.0f}, max {with_h2d_all[-1]:,.0f}) with the host-to-device copy, "
        f"{without_h2d:,.0f} rows/s (min {without_h2d_all[0]:,.0f}, max {without_h2d_all[-1]:,.0f}) "
        f"from batches already on the card; {smi}"
    )

    # --- 6. the compact-key path: direct maps -----------------------------------------
    compact = [nvt.TableBatch.from_pydict(make_compact_part(s)) for s in range(4)]
    dnames = list(compact[0].column_names)

    def compact_graph():
        return dnames >> ops.Categorify()

    dwf = nvt.Workflow(compact_graph(), device=dev)
    dfit_s, _, direct_launches, douts = drive(nvt, dwf, compact, [], {"direct_lookup"}, "compact")
    check_against_cpu(nvt, compact_graph, dwf, compact[0], douts[0], [], "compact vs cpu")
    dnode = next(nd for nd in dwf.graph.nodes if isinstance(nd.op, ops.Categorify))
    djobs = {
        j["kind"]: j
        for j in dnode.op.lookup_jobs(
            dnode.selector, dwf.executor.stage(compact[0]), dwf.executor.op_state(dnode.op, dev)
        )
    }
    if set(djobs) != {"direct"}:
        fail(f"compact: expected one direct table, got {sorted(djobs)}")
    j = djobs["direct"]
    t = j["table"]
    args = (j["values"], j["validity"], t.table, t.mins, t.maxs, t.lens, t.offsets, j["sel"], j["col_offsets"])
    rec = lookup_record(j, klk.direct_lookup_plain, args, lambda: klk.direct_lookup(*args))
    C = j["values"].shape[0]
    s = j["sel"].long()
    idx = (j["values"].long() - t.mins[s].long()[:, None]).clamp(min=0)
    idx = torch.minimum(idx, t.lens[s][:, None] - 1) + t.offsets[s][:, None]
    sectors = int(torch.unique(idx // 8).numel())
    keys = sum(len(v.values_by_code) for v in dnode.op.vocabs.values())
    rec.update(shape=[C, n], bytes=C * n * 8 + sectors * 32, table_keys=keys)
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], C * n * 10)
    records["direct_lookup"] = rec
    log(f"compact: fit {dfit_s:.2f} s, {keys} vocabulary keys, launches {direct_launches}; batch 0 equals the CPU run")

    # --- 7. the training path: ETL -> DeviceLoader -> DLRM + Adagrad ------------------
    train = train_path(nvt, wf, parts, cat_names, cont_names, opts.profile)

    # --- 8. the training path's kernels at its shapes -----------------------------------
    records.update(training_kernel_records(nvt, wf, parts, train))
    train_launches = train["launches"]
    train_record = {k: v for k, v in train.items() if k not in ("model", "staged", "loader")}
    feed = train["loader"]  # phase 16 trains DeepFM and DCN-v2 on it
    del train

    # --- 9. the advanced MovieLens path and its kernels ------------------------------------
    t0 = time.perf_counter()
    ml_parts = [make_movielens_part(s) for s in range(ML_PARTS)]
    log(f"movielens: data {ML_PARTS} x {ML_ROWS_PER_PART} rows in {time.perf_counter() - t0:.1f} s")
    movielens = movielens_path(nvt, dev, ml_parts, opts.profile)
    records.update(movielens.pop("kernels"))
    ml_launches = movielens["launches"]
    ml_launches["fold_ids"] = movielens["fit_launches"]["fold_ids"]
    # the direct map runs on phase 6's path and as phase 9's group indexes
    direct_launches["direct_lookup"] += ml_launches["direct_lookup"]

    # --- 10. the MovieLens multihot path: lists, the multihot loader, the tabular MLP ---------
    multihot = multihot_path(nvt, dev, ml_parts, opts.profile)

    # --- 11. its new kernels at its shapes -------------------------------------------------------
    records.update(multihot_kernel_records(multihot))
    mh_train = multihot.pop("train")
    mh_feed, mh_schema = mh_train.pop("loader"), multihot.pop("schema")  # phase 22 trains DLRM on them
    del mh_train["model"], mh_train["batch"], multihot["genres_batch0"]
    multihot["train"] = mh_train
    # every launch of phase 10's path: its transform, its loader and training, its ListSlice
    mh_launches = {k: multihot["launches"][k] + mh_train["launches"][k] + multihot["slice_launches"][k]
                   for k in multihot["launches"]}
    for shared in (main_launches, direct_launches, train_launches):
        for k in shared:
            shared[k] += mh_launches[k]

    # --- 12. crossed features on phase 3's partitions ----------------------------------------------
    crossed = crossed_path(nvt, dev, parts, opts.profile)

    # --- 13. sessions: DifferenceLag on phase 9's partitions ---------------------------------------
    sessions = sessions_path(nvt, dev, ml_parts, opts.profile)

    # --- 14. their kernels at their shapes -------------------------------------------------------------
    records.update(crossed_kernel_records(dev, crossed, sessions))
    for key in ("wf", "staged", "te", "cat"):
        del crossed[key]
    del sessions["staged"]
    # every launch of phases 12-13: the group indexes' probes count with K1/K3,
    # the TE fold ids (fit), epilogue and stat gathers with K7/K10a
    new_launches = {k: crossed["launches"][k] + sessions["launches"][k] for k in crossed["launches"]}
    for k in ("tiny_lookup", "cuckoo_lookup"):
        main_launches[k] += new_launches[k]
    for k in ("te_encode", "stat_gather", "hashed_cross"):
        ml_launches[k] += new_launches[k]
    ml_launches["fold_ids"] += crossed["fit_launches"]["fold_ids"]

    # --- 15. Categorify's hashed OOV buckets and float keys on phase 3's partitions ---------------------
    buckets = buckets_path(nvt, dev, parts, cat_names, cont_names, opts.profile)
    records.update(buckets_kernel_records(dev, buckets))
    for key in ("wf", "staged", "nodes"):
        del buckets[key]
    buckets_launches = buckets["launches"]
    for k in ("tiny_lookup", "cuckoo_lookup"):
        main_launches[k] += buckets_launches[k]
    direct_launches["direct_lookup"] += buckets_launches["direct_lookup"]

    # --- 16. DeepFM and DCN-v2 training on phase 7's feed --------------------------------------------------
    cards = models.DLRMConfig.from_schema(wf.output_schema).cardinalities
    dlrm_step_ms = 1e3 / train_record["steps_per_s"]
    factorized = {f: train_family(f, feed, cards, dlrm_step_ms, smi, opts.profile) for f in ("deepfm", "dcn")}

    # --- 17. their kernels at their shapes -----------------------------------------------------------------------
    records.update(factorized_kernel_records(factorized))
    fm_launches = {k: sum(r["launches"][k] for r in factorized.values()) for k in factorized["deepfm"]["launches"]}
    for k in ("tiny_lookup", "cuckoo_lookup", "cont_chain"):
        main_launches[k] += fm_launches[k]
    for k in ("permute_rows", "embedding_gather", "embedding_scatter_grad"):
        train_launches[k] += fm_launches[k]

    # --- 18. the multi-GPU fit on a one-rank NCCL group, at full width -------------------------------
    sharded = sharded_fit_path(nvt, ops, dev, wf, parts, criteo_graph, cat_names, cont_names)
    sharded_launches = {
        k: sharded[w][k] for w in ("fit_launches", "lookup_launches", "moments_launches") for k in sharded[w]
        if sharded[w][k]
    }

    # --- 19. the K15 kernels against their plain versions; four ranks composed on the card -----------
    sharded_records, compose = sharded_kernel_records(dev, parts, cat_names, sharded)
    records.update(sharded_records)
    for key in ("table", "flat", "values", "mask", "x0", "vocabs"):
        del sharded[key]
    sharded["compose"] = compose

    # --- 20. DLRM training on row-sharded tables on a one-rank NCCL group -----------------------------
    sharded_train = sharded_train_path(feed, wf.output_schema, train_record["steps_per_s"], smi, opts.profile)
    del feed
    st_launches = sharded_train["launches"]
    for k in ("tiny_lookup", "cuckoo_lookup", "cont_chain"):
        main_launches[k] += st_launches[k]
    for k in ("permute_rows", "embedding_gather", "embedding_scatter_grad", "interaction_fwd", "interaction_bwd"):
        train_launches[k] += st_launches[k]

    # --- 21. K15d against its plain versions on model shard 1 of 4 ------------------------------------
    records.update(sharded_step_kernel_records(dev, sharded_train))
    del sharded_train["ids"]

    # --- 22. DLRM with the genres multihot table on phase 10's feed, whole and row-sharded -------------
    mh_dlrm = multihot_dlrm_path(mh_feed, mh_schema, smi, opts.profile)
    del mh_feed
    for launches in (mh_dlrm["launches"], mh_dlrm["sharded_launches"]):
        for k in ("direct_lookup",):
            direct_launches[k] += launches[k]
        for k in ("tiny_lookup", "cont_chain"):
            main_launches[k] += launches[k]
        for k in ("ragged_to_padded", "embedding_bag_fwd", "embedding_bag_bwd"):
            mh_launches[k] += launches[k]
        for k in ("permute_rows", "embedding_gather", "embedding_scatter_grad", "interaction_fwd", "interaction_bwd"):
            train_launches[k] += launches[k]
        for k in ("range_gather_columns", "range_scatter_grad"):
            st_launches[k] += launches[k]
    mh_dlrm_launches = mh_dlrm["sharded_launches"]

    # --- 23. the layer entry points, and K15d's bag, K13b's self mode and K13d at their shapes -------
    entry = layer_entry_path(dev)
    records.update(layer_kernel_records(dev, mh_dlrm))
    for key in ("values", "mask"):
        del mh_dlrm[key]
    entry_launches = entry["launches"]

    # --- 24. Criteo's alternative continuous chain, its indicators and its small categoricals ---------
    alt = alt_criteo_path(nvt, dev, parts, cat_names, cont_names)
    del parts
    main_launches["tiny_lookup"] += alt["a"]["launches"]["tiny_lookup"]
    alt_launches = {"cont_chain_16": alt["a"]["launches"]["cont_chain_16"],
                    "cont_chain_mask": alt["b"]["launches"]["cont_chain_mask"]}

    # --- 25. sessions: shuffle_by_keys, Dropna, Filter, Groupby, ValueCount, ListSlice, K11c ---------
    sess = session_path(nvt, dev, ml_parts)
    del ml_parts
    sess_launches = sess["launches"]
    ml_launches["hashed_cross"] += sess_launches["hashed_cross"]
    mh_launches["ragged_slice_padded"] += sess_launches["ragged_slice_padded"]

    # --- 26. K5's new modes and K11c at their paths' shapes ------------------------------------------------
    records.update(slice11_kernel_records(dev, alt, sess))
    for key in ("a", "b"):
        del alt[key]["wf"], alt[key]["staged"]
    del sess["lists"]

    # --- kernels line and result ---------------------------------------------------
    meta = {
        "tiny_lookup": ("lookup.cu", "nvtabular_tpu/ops/lookup.py:157", main_launches),
        "direct_lookup": ("lookup.cu", "nvtabular_tpu/ops/lookup.py:585", direct_launches),
        "cuckoo_lookup": ("lookup.cu", "nvtabular_tpu/ops/lookup.py:693", main_launches),
        "sorted_lookup": ("lookup.cu", "nvtabular_tpu/ops/categorify.py:570", buckets_launches),
        "cont_chain": ("cont_chain.cu", "nvtabular_tpu/ops/normalize.py:67", main_launches),
        "cont_chain_16": ("cont_chain.cu", "nvtabular_tpu/ops/normalize.py:140", alt_launches),
        "cont_chain_mask": ("cont_chain.cu", "nvtabular_tpu/ops/fill.py:54", alt_launches),
        "permute_rows": ("permute.cu", "nvtabular_tpu/loader/device_loader.py:21", train_launches),
        "embedding_gather": ("embedding.cu", "nvtabular_tpu/models/layers.py:70", train_launches),
        "embedding_scatter_grad": ("embedding.cu", "nvtabular_tpu/models/layers.py:70", train_launches),
        "interaction_fwd": ("interaction.cu", "nvtabular_tpu/models/layers.py:97", train_launches),
        "interaction_bwd": ("interaction.cu", "nvtabular_tpu/models/layers.py:97", train_launches),
        "hashed_cross": ("hash.cu", "nvtabular_tpu/ops/hashed_cross.py:38", ml_launches),
        "fold_ids": ("hash.cu", "nvtabular_tpu/ops/target_encoding.py:39", ml_launches),
        "te_encode": ("groupby.cu", "nvtabular_tpu/ops/target_encoding.py:307", ml_launches),
        "stat_gather": ("groupby.cu", "nvtabular_tpu/ops/join_groupby.py:255", ml_launches),
        "bucketize": ("bucketize.cu", "nvtabular_tpu/ops/bucketize.py:36", ml_launches),
        "ragged_to_padded": ("ragged.cu", "nvtabular_tpu/kernels/ragged.py:22", mh_launches),
        "ragged_slice_padded": ("ragged.cu", "nvtabular_tpu/kernels/ragged.py:35", mh_launches),
        "ragged_segment_reduce": ("ragged.cu", "nvtabular_tpu/kernels/ragged.py:51", sess_launches),
        "embedding_bag_fwd": ("embedding_bag.cu", "nvtabular_tpu/models/layers.py:75", mh_launches),
        "embedding_bag_bwd": ("sharded_embedding.cu", "nvtabular_tpu/models/layers.py:75", mh_launches),
        "hash_pair": ("hash_pair.cu", "nvtabular_tpu/ops/groupby_stats.py:53", new_launches),
        "hash_pair_verify": ("hash_pair.cu", "nvtabular_tpu/ops/groupby_stats.py:611", new_launches),
        "difference_lag": ("difference_lag.cu", "nvtabular_tpu/ops/difference_lag.py:79", new_launches),
        "fm_fwd": ("fm.cu", "nvtabular_tpu/models/deepfm.py:64", fm_launches),
        "fm_bwd": ("fm.cu", "nvtabular_tpu/models/deepfm.py:64", fm_launches),
        "cross_fwd": ("cross.cu", "nvtabular_tpu/models/deepfm.py:134", fm_launches),
        "cross_bwd": ("cross.cu", "nvtabular_tpu/models/deepfm.py:134", fm_launches),
        "exchange_route": ("exchange.cu", "nvtabular_tpu/parallel/sharded_vocab.py:100", sharded_launches),
        "radix_sort": ("exchange.cu", "nvtabular_tpu/parallel/sharded_vocab.py:118", sharded_launches),
        "embedding_range_gather": ("sharded_embedding.cu", "nvtabular_tpu/parallel/embeddings.py:40", sharded_launches),
        "embedding_range_bag": ("sharded_embedding.cu", "nvtabular_tpu/parallel/embeddings.py:73", sharded_launches),
        "column_moments": ("moments.cu", "nvtabular_tpu/parallel/stats.py:50", sharded_launches),
        "range_gather_columns": ("sharded_embedding.cu", "nvtabular_tpu/parallel/train.py:39", st_launches),
        "range_scatter_grad": ("sharded_embedding.cu", "nvtabular_tpu/parallel/train.py:39", st_launches),
        "range_bag": ("sharded_embedding.cu", "nvtabular_tpu/models/dlrm.py:127", mh_dlrm_launches),
        "range_bag_grad": ("sharded_embedding.cu", "nvtabular_tpu/parallel/embeddings.py:73", mh_dlrm_launches),
        "interaction_self_fwd": ("interaction.cu", "nvtabular_tpu/models/layers.py:97", entry_launches),
        "interaction_self_bwd": ("interaction.cu", "nvtabular_tpu/models/layers.py:97", entry_launches),
        "cin_fwd": ("cin.cu", "nvtabular_tpu/models/layers.py:120", entry_launches),
        "cin_bwd": ("cin.cu", "nvtabular_tpu/models/layers.py:120", entry_launches),
    }
    line = []
    for name, rec in records.items():  # the line's kernels, then the same kernels at other shapes
        lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        if name in LIBRARY_WHAT:
            lib += f" ({LIBRARY_WHAT[name]})"
        log(
            f"kernel {name} {rec['shape']}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"library {lib}, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({rec['bytes']} bytes over 3.35 TB/s), max abs err {rec['max_abs_err']}"
        )
    for name, (source, replaces, launches) in meta.items():
        rec = records[name]
        line.append(
            {
                "name": name,
                "route": "cuda",
                "source": "nvtabular_tpu_torch/csrc/" + source,
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                "bytes": rec["bytes"],
                "shape": rec["shape"],
            }
        )
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(
                {
                    "card": smi,
                    "torch": torch.__version__,
                    "build_s": build_s,
                    "criteo": {"fit_s": fit_s, "first_pass_s": first_s, "rows_per_s_with_h2d": with_h2d_all,
                               "rows_per_s_without_h2d": without_h2d_all, "vocab_keys": vocab_keys,
                               "columns_per_kind": kinds, "fit_stats": wf.last_fit_stats},
                    "compact": {"fit_s": dfit_s, "vocab_keys": keys},
                    "train": train_record,
                    "movielens": movielens,
                    "multihot": multihot,
                    "crossed": crossed,
                    "sessions": sessions,
                    "buckets": buckets,
                    "factorized": factorized,
                    "sharded": sharded,
                    "sharded_train": sharded_train,
                    "multihot_dlrm": mh_dlrm,
                    "layer_entry": entry,
                    "alt_criteo": alt,
                    "session": sess,
                    "profiles": profiles,
                    "kernels": records,
                    "ptxas": kbuild.PTXAS_REPORT,
                },
                f,
                indent=1,
            )
    log(f"chip_smoke: all phases passed in {time.perf_counter() - run_t0:.1f} s")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
