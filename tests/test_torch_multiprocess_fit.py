"""The port's multi-process fit on gloo groups of spawned ranks.

A small Criteo-shaped workflow (Categorify of three hashed id columns,
FillMissing >> Clip >> LogOp >> Normalize of two count columns,
TargetEncoding of an id by the click label, JoinGroupby of an id over a
count column) is fitted by 2 and 4 ranks, each streaming its round-robin
shard of the partitions, with the exchange thresholds lowered so that the
vocabularies (Categorify's mesh fit and its all_to_all reduction) and the
group tables (the keyed-row exchange) take the all_to_all routes. Every
rank's vocabularies and group statistics must hash (SHA-256) to those of the
port's single-process fit, of its 1-rank mesh fit and of the JAX package's
single-process fit; Normalize's moments, float64 sums of the ranks'
partials in another order, agree within NORM_TOL (JAX_NORM_TOL against the
JAX package, whose float32 log1p differs by ULPs). The ranks' transforms,
concatenated in partition order, equal the single-process transform. The
module imports no JAX at its top: the spawned workers import it by name.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import nvtabular_tpu_torch as pnvt
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.dag.executor import TorchExecutor
from nvtabular_tpu_torch.parallel import local_mesh, sharded_vocab
from torch_groups import run_group

ROWS, PARTS = 3000, 6
CATS = ["C0", "C1", "C2"]
CONTS = ["I0", "I1"]
NORM_TOL = dict(rtol=1e-12, atol=1e-15)  # the port's moments: float64 sums in another order
JAX_NORM_TOL = dict(rtol=1e-6, atol=1e-9)  # against the JAX package's: float32 log1p ULPs too
OUT_TOL = dict(rtol=1e-6, atol=1e-7)  # Normalize's outputs: float32 of those moments
LOW = {"NVT_VOCAB_EXCHANGE_MIN": "16", "NVT_GROUPBY_EXCHANGE_MIN": "16"}


def make_part(seed: int) -> dict:
    """Criteo-shaped: power-law ids hashed into int32 (one with nulls at
    transform time in the reference's sense: a value, here), integer counts
    with ~5% missing, a 0/1 label. Counts and labels are integers, so every
    float64 group sum is exact in any order."""
    r = np.random.default_rng(seed)
    data = {c: ((r.zipf(1.3, ROWS) * 2654435761 + i) % (1 << 21)).astype(np.int32) for i, c in enumerate(CATS)}
    for c in CONTS:
        v = r.poisson(8.0, ROWS).astype(np.float32)
        v[r.random(ROWS) < 0.05] = np.nan
        data[c] = v
    data["label"] = r.integers(0, 2, ROWS).astype(np.int32)
    return data


def graph(ops, **group_kw):
    cats = CATS >> ops.Categorify()
    conts = CONTS >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.Normalize()
    te = ["C0"] >> ops.TargetEncoding("label", **group_kw)
    jg = ["C1"] >> ops.JoinGroupby(cont_cols=["I0"], stats=["count", "sum", "mean", "std", "min", "max"], **group_kw)
    return cats + conts + te + jg + ["label"]


def port_parts():
    return [pnvt.TableBatch.from_pydict(make_part(s)) for s in range(PARTS)]


def _op(wf, cls):
    return next(n.op for n in wf.graph.nodes if isinstance(n.op, cls))


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.asarray(a)
        if a.dtype.kind == "f":
            a = np.where(np.isnan(a), np.nan, a.astype(np.float64))  # one NaN pattern
        elif a.dtype.kind in "iu":
            a = a.astype(np.int64)
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _keyed_digest(keyed) -> str:
    """Rows in ascending key order (the reference's per-key totals keep
    arrow's group_by order), keys as int64, stats as float64 by name."""
    keys = [np.asarray(keyed.key_arrays[k]) for k in keyed.key_cols]
    order = np.lexsort(keys[::-1])
    stats = [np.asarray(keyed.stats[name])[order] for name in sorted(keyed.stats)]
    return _digest(*[k[order] for k in keys], *stats) + ":" + ",".join(sorted(keyed.stats))


def digests(wf, te_cls, jg_cls, cat_cls, norm_cls) -> dict:
    """SHA-256 of every fitted vocabulary and group table of either
    package's workflow, and Normalize's moments and TE's means as numbers."""
    cat, te, jg, norm = (_op(wf, c) for c in (cat_cls, te_cls, jg_cls, norm_cls))
    return {
        "vocab": {k: _digest(v.values_by_code, v.counts, [v.start_index, v.offset]) for k, v in cat.vocabs.items()},
        "te": {t: (_keyed_digest(te.fold_stats[t]), _keyed_digest(te.overall_stats[t])) for t in te.fold_stats},
        "te_means": dict(te.means),
        "jg": {k: _keyed_digest(v) for k, v in jg.keyed.items()},
        "norm": {c: (norm.means[c], norm.stds[c]) for c in CONTS},
    }


def port_digests(wf):
    return digests(wf, pops.TargetEncoding, pops.JoinGroupby, pops.Categorify, pops.Normalize)


def transform_parts(wf, parts, which):
    return {i: {k: c.values.cpu().numpy() for k, c in wf.transform(parts[i]).columns.items()} for i in which}


# --- the spawned ranks ------------------------------------------------------------------
def fit_worker(rank, world, device="cpu"):
    """The workflow fitted on this rank's shard, twice: with the thresholds
    lowered (the all_to_all routes) and at their defaults (the allgather
    route, these tables being small). ``device="cuda"``: the rank's card."""
    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    parts = port_parts()
    out = {}
    for route, env in (("exchange", LOW), ("gather", {})):
        for k in LOW:
            os.environ.pop(k, None)
        os.environ.update(env)
        wf = pnvt.Workflow(graph(pops), executor=TorchExecutor(device, mesh=local_mesh()))
        cat = _op(wf, pops.Categorify)
        mesh_calls = []
        fit_mesh = cat.fit_mesh
        cat.fit_mesh = lambda buffers, *a: mesh_calls.append(sorted(buffers)) or fit_mesh(buffers, *a)
        wf.fit(pnvt.Dataset(parts))
        out[route] = {
            "digests": port_digests(wf),
            "reduce": {c.__name__: getattr(_op(wf, c), "last_fit_reduce", None)
                       for c in (pops.Categorify, pops.TargetEncoding, pops.JoinGroupby)},
            "fit_stats": wf.last_fit_stats,
            "mesh_calls": mesh_calls,
        }
    out["outs"] = transform_parts(wf, parts, range(rank, PARTS, world))
    return out


def mesh_cases_worker(rank, world):
    """fit_mesh on a 1-rank group (test_mesh_executor.py:233-326): a list
    column and a nullable column through the mesh; keys outside int32 or
    equal to the exchange's pad take the host counter; NVT_MESH_FIT=0 turns
    the mesh fit off."""
    rng = np.random.default_rng(4)
    n = 8192
    lens = rng.integers(0, 4, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    batch = pnvt.TableBatch({
        "mh": pnvt.Column(rng.integers(0, 200, int(offsets[-1])).astype(np.int64), offsets),
        "c": pnvt.Column(rng.integers(0, 50, n).astype(np.int64), None, rng.random(n) > 0.1),
    })
    out = {}
    for name, mesh in (("mesh", local_mesh()), ("host", None)):
        wf = pnvt.Workflow(["mh", "c"] >> pops.Categorify(), executor=TorchExecutor("cpu", mesh=mesh))
        wf.fit(pnvt.Dataset([batch]))
        res = wf.transform(batch)
        out[name] = {k: (v.values_by_code, v.counts) for k, v in _op(wf, pops.Categorify).vocabs.items()}
        out[name + "_codes"] = {k: c.values.numpy() for k, c in res.columns.items()}
    # wide and pad keys: the exchange must not run; the counts are the host counter's
    exchanged = []
    owned = sharded_vocab.owned_value_counts
    sharded_vocab.owned_value_counts = lambda *a, **k: exchanged.append(1) or owned(*a, **k)
    cat = pops.Categorify()
    wide = torch.from_numpy(rng.integers(0, 1 << 40, 5000))
    pad = torch.from_numpy(np.append(rng.integers(0, 9, 999), 2**31 - 1).astype(np.int32))
    ok = torch.from_numpy(rng.integers(-9, 9, 1000).astype(np.int32))
    keys = {"wide": wide, "pad": pad, "ok": ok}
    state = cat.fit_mesh({k: [(v, None)] for k, v in keys.items()}, local_mesh())
    out["fit_mesh"] = {k: a.finalize() for k, a in state.items()}
    out["fit_mesh_keys"] = {k: v.numpy() for k, v in keys.items()}
    out["exchanged"] = len(exchanged)
    os.environ["NVT_MESH_FIT"] = "0"
    wf = pnvt.Workflow(["mh", "c"] >> pops.Categorify(), executor=TorchExecutor("cpu", mesh=local_mesh()))
    cat = _op(wf, pops.Categorify)
    cat.fit_mesh = lambda *a: pytest.fail("fit_mesh ran with NVT_MESH_FIT=0")
    wf.fit(pnvt.Dataset([batch]))
    out["opt_out"] = {k: (v.values_by_code, v.counts) for k, v in cat.vocabs.items()}
    return out


def one_rank_worker(rank, world):
    os.environ.update(LOW)
    wf = pnvt.Workflow(graph(pops), executor=TorchExecutor("cpu", mesh=local_mesh()))
    wf.fit(pnvt.Dataset(port_parts()))
    return port_digests(wf), wf.last_fit_stats


@pytest.fixture(scope="module")
def single():
    """The port's single-process fit (no group) and its transform."""
    parts = port_parts()
    wf = pnvt.Workflow(graph(pops), device="cpu")
    wf.fit(pnvt.Dataset(parts))
    return port_digests(wf), transform_parts(wf, parts, range(PARTS))


@pytest.fixture(scope="module")
def jax_digests(tmp_path_factory):
    """The JAX package's single-process FitEngine fit of the same workflow."""
    import nvtabular_tpu as jnvt
    from nvtabular_tpu import ops as jops

    out_path = str(tmp_path_factory.mktemp("jax_stats"))
    wf = jnvt.Workflow(graph(jops, out_path=out_path))
    wf.fit(jnvt.Dataset([jnvt.TableBatch.from_pydict(make_part(s)) for s in range(PARTS)]))
    return digests(wf, jops.TargetEncoding, jops.JoinGroupby, jops.Categorify, jops.Normalize)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit_groups")
    return {world: run_group(fit_worker, world, tmp) for world in (2, 4)}


def _assert_same_fit(got, want, norm_tol=NORM_TOL):
    assert got["vocab"] == want["vocab"]
    assert got["te"] == want["te"]
    assert got["jg"] == want["jg"]
    assert got["te_means"] == want["te_means"]
    for c in CONTS:
        np.testing.assert_allclose(got["norm"][c], want["norm"][c], **norm_tol, err_msg=c)


def test_port_fit_matches_jax(single, jax_digests):
    _assert_same_fit(single[0], jax_digests, JAX_NORM_TOL)


@pytest.mark.parametrize("route", ["exchange", "gather"])
@pytest.mark.parametrize("world", [2, 4])
def test_multiprocess_fit_matches_single_process(groups, single, jax_digests, world, route):
    """Every rank: the same SHA-256 of vocabularies and group tables as the
    single-process fits of both packages."""
    for res in groups[world]:
        _assert_same_fit(res[route]["digests"], single[0])
        _assert_same_fit(res[route]["digests"], jax_digests, JAX_NORM_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_multiprocess_fit_takes_the_exchange(groups, world):
    """Lowered thresholds: every vocabulary counts on the mesh (fit_mesh)
    and reduces through the all_to_all, as do both group tables; at the
    defaults these small tables take the allgather."""
    for rank, res in enumerate(groups[world]):
        ex, ga = res["exchange"], res["gather"]
        assert ex["mesh_calls"] == [CATS] and ga["mesh_calls"] == [CATS]
        assert ex["reduce"]["Categorify"] == {"exchange": CATS, "gather": []}
        assert ex["reduce"]["TargetEncoding"] == {"exchange": ["C0"], "gather": []}
        assert ex["reduce"]["JoinGroupby"] == {"exchange": ["C1"], "gather": []}
        assert ga["reduce"]["Categorify"] == {"exchange": [], "gather": CATS}
        assert ga["reduce"]["TargetEncoding"]["gather"] == ["C0"]
        assert ex["fit_stats"]["reduce_seconds"] > 0
        assert ex["fit_stats"]["rows_scanned"] == ROWS * len(range(rank, PARTS, world))


@pytest.mark.parametrize("world", [2, 4])
def test_multiprocess_transform_matches_single_process(groups, single, world):
    """The ranks' transforms of their own partitions, in partition order:
    codes, TE and JoinGroupby columns equal, Normalize's within OUT_TOL."""
    got = {}
    for res in groups[world]:
        got.update(res["outs"])
    want = single[1]
    assert sorted(got) == list(range(PARTS))
    for i in range(PARTS):
        assert list(got[i]) == list(want[i])
        for name, w in want[i].items():
            if name in CONTS:
                np.testing.assert_allclose(got[i][name], w, **OUT_TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(got[i][name], w, err_msg=name)


def test_one_rank_mesh_fit_matches(tmp_path, single, jax_digests):
    (got, stats), = run_group(one_rank_worker, 1, tmp_path)
    _assert_same_fit(got, single[0])
    _assert_same_fit(got, jax_digests, JAX_NORM_TOL)
    assert stats["reduce_seconds"] == 0.0  # one rank: nothing to reduce


@pytest.fixture(scope="module")
def mesh_cases(tmp_path_factory):
    return run_group(mesh_cases_worker, 1, tmp_path_factory.mktemp("mesh_cases"))[0]


def test_fit_mesh_lists_and_nulls_match_host_fit(mesh_cases):
    for key in ("mh", "c"):
        for got, want in zip(mesh_cases["mesh"][key], mesh_cases["host"][key]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mesh_cases["mesh_codes"][key], mesh_cases["host_codes"][key])
        for got, want in zip(mesh_cases["opt_out"][key], mesh_cases["host"][key]):
            np.testing.assert_array_equal(got, want)


def test_fit_mesh_lists_and_nulls_match_jax():
    """The same columns through the JAX package's host fit."""
    import nvtabular_tpu as jnvt
    from nvtabular_tpu import ops as jops

    rng = np.random.default_rng(4)
    n = 8192
    lens = rng.integers(0, 4, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    batch = jnvt.TableBatch()
    batch["mh"] = jnvt.Column(rng.integers(0, 200, int(offsets[-1])).astype(np.int64), offsets)
    batch["c"] = jnvt.Column(rng.integers(0, 50, n).astype(np.int64), None, rng.random(n) > 0.1)
    wf = jnvt.Workflow(["mh", "c"] >> jops.Categorify())
    wf.fit(jnvt.Dataset(batch))
    want = {k: (v.values_by_code, v.counts) for k, v in _op(wf, jops.Categorify).vocabs.items()}
    port = pnvt.Workflow(["mh", "c"] >> pops.Categorify(), device="cpu")
    port.fit(pnvt.Dataset([pnvt.TableBatch({
        "mh": pnvt.Column(np.asarray(batch["mh"].values), offsets),
        "c": pnvt.Column(np.asarray(batch["c"].values), None, np.asarray(batch["c"].validity)),
    })]))
    for key, (values, counts) in want.items():
        vocab = _op(port, pops.Categorify).vocabs[key]
        np.testing.assert_array_equal(vocab.values_by_code, values)
        np.testing.assert_array_equal(vocab.counts, counts)


def test_fit_mesh_wide_and_pad_keys_take_the_host_count(mesh_cases):
    """Keys outside int32 and the pad value are counted on the host, the
    in-range column through the exchange; each vocabulary is the exact
    count, in (-count, value) order."""
    assert mesh_cases["exchanged"] == 1
    for key, keys in mesh_cases["fit_mesh_keys"].items():
        vals, cnts = np.unique(keys, return_counts=True)
        order = np.lexsort((vals, -cnts))
        got_vals, got_cnts = mesh_cases["fit_mesh"][key]
        assert got_vals.dtype == keys.dtype
        np.testing.assert_array_equal(got_vals, vals[order], err_msg=key)
        np.testing.assert_array_equal(got_cnts, cnts[order], err_msg=key)


@pytest.mark.parametrize("op", ["Categorify", "Normalize", "TargetEncoding", "JoinGroupby"])
def test_fit_merge_of_shards_matches_one_fit(op):
    """Each op's ``fit_merge`` of three shards' states (the allgather
    route), as tests/unit/parallel/test_multihost_fit.py:24-60 does for the
    JAX package: the same state as one fit of every partition."""
    parts = port_parts()
    wf = pnvt.Workflow(graph(pops), device="cpu")
    wf.fit(pnvt.Dataset(parts))
    want = port_digests(wf)
    node = next(n for n in wf.graph.nodes if type(n.op).__name__ == op)
    states = []
    for rank in range(3):
        state = node.op.fit_init(node.selector, node.input_schema)
        for batch in pnvt.Dataset(parts).to_batches(shard=(rank, 3)):
            inp = wf._fit_engine._input_executor.compute_node_input(node, batch, {})
            state = node.op.fit_batch(node.selector, inp, state)
        states.append(state)
    node.op.clear()
    node.op.fit_finalize(node.op.fit_merge(states))
    _assert_same_fit(port_digests(wf), want)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_dataset_shard_deals_round_robin(world):
    """Each rank's partitions and their global row offsets, as the JAX
    package's Dataset deals them (io/dataset.py:446-470)."""
    import nvtabular_tpu as jnvt

    sizes = [5, 3, 7, 2, 4]
    parts = [{"x": np.arange(n, dtype=np.int64) + 100 * i} for i, n in enumerate(sizes)]
    pds = pnvt.Dataset([pnvt.TableBatch.from_pydict(p) for p in parts])
    jds = jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts])
    seen = []
    for rank in range(world):
        got = [(b.row_offset, b["x"].values.numpy().tolist()) for b in pds.to_batches(shard=(rank, world))]
        want = [(b.row_offset, np.asarray(b["x"].values).tolist())
                for b in jds.to_batches(shard=(rank, world), prefetch=0)]
        assert got == want
        seen += [x for _, xs in got for x in xs]
    assert sorted(seen) == sorted(x for p in parts for x in p["x"].tolist())
