"""Spawned gloo process groups for the port's multi-process tests.

``run_group(fn, world, tmp_path, *args)`` starts ``world`` processes (the
``spawn`` start method), joins them into one gloo group (or, with
``backend="nccl"``, an NCCL group of one CUDA device a rank) through a
``file://`` store under ``tmp_path``, runs ``fn(rank, world, *args)`` on
each and returns the ranks' results in rank order. ``fn`` must be a
module-level function of a module that imports no JAX: the workers import
it by name. A rank that fails, or a group that outlives ``timeout``
seconds, fails the call with the ranks' tracebacks; every process is
stopped before it returns.
"""

from __future__ import annotations

import pickle
import time
import traceback
from pathlib import Path

import torch
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 45  # a collective waiting on a lost rank raises after this


def _entry(fn, rank, world, store, out, args, backend):
    import torch.distributed as dist

    from nvtabular_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    try:
        initialize_distributed(backend, f"file://{store}", rank, world, timeout=GROUP_TIMEOUT_S)
        result = fn(rank, world, *args)
        Path(out).write_bytes(pickle.dumps(result))
    except BaseException:
        Path(out + ".err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_group(fn, world: int, tmp_path, *args, timeout: float = 55.0, backend: str = "gloo"):
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    stamp = f"{fn.__name__}_{world}_{time.monotonic_ns()}"
    store = tmp / f"store_{stamp}"
    outs = [str(tmp / f"out_{stamp}_{r}") for r in range(world)]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, str(store), outs[r], args, backend)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            time.sleep(0.5)  # the failing rank's traceback is written; the others wait on it
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errors = [Path(o + ".err").read_text() for o in outs if Path(o + ".err").exists()]
    codes = [p.exitcode for p in procs]
    if errors or any(c != 0 for c in codes):
        raise RuntimeError(f"group of {world} failed (exit codes {codes}):\n" + "\n".join(errors))
    return [pickle.loads(Path(o).read_bytes()) for o in outs]


def fill_median_worker(rank, world, parts, columns):
    """FillMedian fitted by the multi-process FitEngine on this rank's
    round-robin shard of ``parts``; the rank's medians."""
    import nvtabular_tpu_torch as nvt
    from nvtabular_tpu_torch import ops

    wf = nvt.Workflow(columns >> ops.FillMedian(), device="cpu")
    wf.fit(nvt.Dataset(parts))
    return next(n.op for n in wf.graph.nodes if isinstance(n.op, ops.FillMedian)).medians
