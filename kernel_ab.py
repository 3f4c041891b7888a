"""Times K13b's forward and backward and K13d's forward on the card, from
one or more checkouts of the port, so that two versions of a kernel are
compared in one call at the shapes of chip_smoke.py's main paths:

    python3 kernel_ab.py --tree OLD --tree NEW --tree NEW --tree OLD [--out FILE]

A tree is the root of a checkout (the directory that holds
``nvtabular_tpu_torch/``). Each runs in a process of its own, in the order
given, and builds its kernels from its own ``csrc/`` into its own
``build/``. ``DIR@F,D,G,T,S`` runs a tree with K13b's forward planned as G
samples a group, T threads a block and S stages at [F, D] (several such
plans joined by ``+``; the tree's ``interaction.fwd_plan`` elsewhere).
Every case is first held against the tree's plain version on the same
inputs (the self mode ``torch.equal``, the rest within 1e-5 of the terms'
magnitudes + 1e-5); its time is the median of 5 CUDA-event windows of 25
calls (5 for K13d) behind a device-side sleep, as chip_smoke.py times the
kernels. Prints one JSON line a tree, then a table; ``--out`` writes the
records as JSON. Imports no JAX.
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


def one_tree(tree: str, plans: dict) -> dict:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    import torch

    import nvtabular_tpu_torch
    from nvtabular_tpu_torch.kernels import build
    from nvtabular_tpu_torch.kernels import cin as kcin
    from nvtabular_tpu_torch.kernels import interaction as kint

    if not Path(nvtabular_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {nvtabular_tpu_torch.__file__}, not the package of {root}")
    if plans:
        tree_plan = kint.fwd_plan
        kint.fwd_plan = lambda F, D, self_interaction: plans.get((F, D)) or tree_plan(F, D, self_interaction)
    build.build_all(["interaction", "cin"])
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(16)
    rec = {}

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
            if not torch.equal(got, want):
                raise SystemExit(f"interaction_fwd self [{F}, {D}] is not equal to its plain version")
            err = 0.0
        else:
            err = within(got, want, kint.interaction_fwd_plain(x.abs()))
        rec[f"interaction_fwd {mode} [{BATCH}, {F}, {D}]"] = {
            "ms": time_ms(torch, lambda: kint.interaction_fwd(x, out=out, self_interaction=self_interaction)),
            "max_abs_err": err, "plan": list(kint.fwd_plan(F, D, self_interaction)) if hasattr(kint, "fwd_plan")
            else None}
        got = kint.interaction_bwd(x, g, self_interaction)
        err = within(got, kint.interaction_bwd_plain(x, g, self_interaction),
                     kint.interaction_bwd_plain(x.abs(), g.abs(), self_interaction))
        rec[f"interaction_bwd {mode} [{BATCH}, {F}, {D}]"] = {
            "ms": time_ms(torch, lambda: kint.interaction_bwd(x, g, self_interaction)), "max_abs_err": err}

    interaction(27, 16, 16, False)  # DLRM's Criteo step (phases 7, 20)
    interaction(27, 16, 16, True)   # phase 23's self mode
    interaction(4, 64, 64, False)   # the multihot DLRM step (phase 22)
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
    return {"tree": tree, "plans": {f"{F},{D}": list(p) for (F, D), p in plans.items()}, "cases": rec}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="a checkout's root, or DIR@F,D,G,T,S[+...]")
    ap.add_argument("--out", help="write the card and the trees' records here")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        tree, _, spec = args.one.partition("@")
        plans = {}
        for item in filter(None, spec.split("+")):
            F, D, *plan = (int(v) for v in item.split(","))
            plans[(F, D)] = tuple(plan)
        print(json.dumps(one_tree(tree, plans)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    recs = []
    for tree in args.tree:
        proc = subprocess.run([sys.executable, __file__, "--tree", tree, "--one", tree], capture_output=True,
                              text=True)
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
        print(f"{n:{width}}  " + "  ".join(f"{r['cases'][n]['ms']:.4f}" if n in r["cases"] else "-" for r in recs))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "trees": recs}, indent=1))


if __name__ == "__main__":
    main()
