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
   same way, and the direct lookup kernel held against its plain version.

The line before the last is {"kernels": [...]} with each kernel's launches,
error, times and bound; the last line is {"ok": true, "device": {...}}.
The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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


def compare_outputs(got, want, conts, what):
    if got.column_names != want.column_names:
        fail(f"{what}: columns {got.column_names} != {want.column_names}")
    for name in want.column_names:
        g, w = got[name].values.cpu(), want[name].values
        if g.dtype != w.dtype:
            fail(f"{what}: {name} dtype {g.dtype} != {w.dtype}")
        if name in conts:
            if not torch.allclose(g, w, **CPU_TOL):
                fail(f"{what}: {name} differs, max abs {float((g - w).abs().max())}")
        elif not torch.equal(g, w):
            fail(f"{what}: {name} codes differ in {int((g != w).sum())} rows")


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
    }


def profile_pass(fn) -> dict:
    """Wall time of ``fn`` under torch.profiler and the device time it saw."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [
        (e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
        for e in prof.key_averages()
    ]
    ops = sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])
    device_ms = sum(o[1] for o in ops)
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "top": [(k[:60], round(ms, 3), n) for k, ms, n in ops[:8]],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the full record as JSON here")
    parser.add_argument(
        "--profile", action="store_true",
        help="also trace 4 batches with torch.profiler: device busy share and top device ops",
    )
    opts = parser.parse_args()

    # --- 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    import nvtabular_tpu_torch as nvt
    from nvtabular_tpu_torch import ops
    from nvtabular_tpu_torch.dag.device_fuse import extract_chain
    from nvtabular_tpu_torch.kernels import build as kbuild
    from nvtabular_tpu_torch.kernels import cont_chain as kcc
    from nvtabular_tpu_torch.kernels import lookup as klk

    dev = torch.device(DEVICE)
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
        "shape": [C, n],
        "bytes": C * n * 8,
    }
    rec["bound_ms"], rec["bound_by"] = bound(rec["bytes"], C * n * 12)
    records["cont_chain"] = rec

    # --- 5. throughput, with and without the host-to-device copy --------------------
    rows_total = NUM_PARTS * ROWS_PER_PART

    def run_all(batches):
        for b in batches:
            wf.transform(b)
        torch.cuda.synchronize()

    def rates(batches):
        """rows/s of REPEATS passes over ``batches``, each ended by a sync."""
        out = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            run_all(batches)
            out.append(rows_total / (time.perf_counter() - t0))
        return sorted(out)

    run_all(parts[:2])
    with_h2d_all = rates(parts)
    on_card = [wf.executor.stage(b) for b in parts]
    torch.cuda.synchronize()
    without_h2d_all = rates(on_card)
    with_h2d, without_h2d = float(np.median(with_h2d_all)), float(np.median(without_h2d_all))
    profiles = {}
    if opts.profile:
        profiles = {
            "with_h2d": profile_pass(lambda: run_all(parts[:4])),
            "without_h2d": profile_pass(lambda: run_all(on_card[:4])),
        }
        for what, p in profiles.items():
            log(f"profile {what}: wall {p['wall_ms']:.2f} ms, device busy {p['device_ms']:.2f} ms "
                f"({p['busy_share']:.1%}), top device ops {p['top']}")
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

    # --- kernels line and result ---------------------------------------------------
    meta = {
        "tiny_lookup": ("nvtabular_tpu/ops/lookup.py:157", main_launches),
        "cuckoo_lookup": ("nvtabular_tpu/ops/lookup.py:693", main_launches),
        "cont_chain": ("nvtabular_tpu/ops/normalize.py:67", main_launches),
        "direct_lookup": ("nvtabular_tpu/ops/lookup.py:585", direct_launches),
    }
    line = []
    for name in ("tiny_lookup", "direct_lookup", "cuckoo_lookup", "cont_chain"):
        rec = records[name]
        replaces, launches = meta[name]
        log(
            f"kernel {name} {rec['shape']}: {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bytes']} bytes over 3.35 TB/s), "
            f"max abs err {rec['max_abs_err']}"
        )
        line.append(
            {
                "name": name,
                "route": "cuda",
                "source": "nvtabular_tpu_torch/csrc/" + ("cont_chain.cu" if name == "cont_chain" else "lookup.cu"),
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": None,
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
                    "profiles": profiles,
                    "kernels": records,
                    "ptxas": kbuild.PTXAS_REPORT,
                },
                f,
                indent=1,
            )
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
