"""The advanced MovieLens workflow of nvtabular_tpu_torch against the JAX
reference: TargetEncoding, JoinGroupby, HashedCross, LambdaOp → Bucketize,
and the hashes, group indexes and bucket ids under them.

Both packages see the same seeded numpy data (3 partitions of 4,000 rows).
The port runs on the CPU (``device="cpu"``: the kernels' plain versions);
the reference runs ``Workflow(graph, executor=JitExecutor(jit_min_rows=0))``,
so TargetEncoding, JoinGroupby, HashedCross and Bucketize take its device
path (jitted on CPU-JAX) and the LambdaOp its host path. Codes, counts,
cross ids, bucket ids and ``__fold__`` must be equal; TE values and stat
columns agree within rtol=1e-6 (both compute the same float32 operations
in the same order; the fitted float64 sums differ only in summation
order, within rtol=1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvtabular_tpu as jnvt
import nvtabular_tpu_torch as pnvt
from nvtabular_tpu import dispatch as jdispatch
from nvtabular_tpu import ops as jops
from nvtabular_tpu.dag.executor import JitExecutor
from nvtabular_tpu.ops import groupby_stats as jgs
from nvtabular_tpu.ops import target_encoding as jte
from nvtabular_tpu.selector import ColumnSelector as JSelector
from nvtabular_tpu_torch import dispatch as pdispatch
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.dag.executor import LocalExecutor
from nvtabular_tpu_torch.dag.node import Node
from nvtabular_tpu_torch.kernels import hash as khash
from nvtabular_tpu_torch.ops import groupby_stats as pgs
from nvtabular_tpu_torch.ops.lookup import CuckooLookup, DirectLookup, TinyLookup
from nvtabular_tpu_torch.selector import ColumnSelector as PSelector

ROWS, PARTS = 4000, 3
KEYS = ["userId", "movieId", "tagId"]  # direct map, tiny table, cuckoo table
BOUNDS = [60.0, 3600.0, 43200.0, 86400.0, 604800.0]
FLOAT_TOL = dict(rtol=1e-6, atol=1e-7)
SUM_TOL = dict(rtol=1e-12, atol=0)


def make_part(seed, n=ROWS, shift=0):
    """MovieLens-shaped columns (bench/movielens_bench.py:35-52) at a small
    key space, a sparse third key and ~3% NaN ratings; ``shift`` moves the
    keys out of the fitted vocabulary."""
    r = np.random.default_rng(seed)
    rating = (r.integers(1, 11, n) / 2.0).astype(np.float32)
    rating[r.random(n) < 0.03] = np.nan
    return {
        "userId": (r.zipf(1.2, n).clip(1, 3000) + shift).astype(np.int64),
        "movieId": (r.zipf(1.1, n).clip(1, 400) + shift).astype(np.int64),
        "tagId": (((r.integers(0, 900, n) + shift) * 2654435761) % 2**31).astype(np.int32),
        "rating": rating,
        "ts_delta": r.exponential(86400.0, n).astype(np.float32),
    }


def batch(mod, part, nulls=()):
    """A TableBatch of ``mod`` (either package); the columns in ``nulls``
    get a seeded validity mask with ~10% nulls."""
    r = np.random.default_rng(len(part["rating"]))
    cols = {}
    for name, values in part.items():
        valid = r.random(len(values)) > 0.1 if name in nulls else None
        cols[name] = mod.Column(values, None, valid)
    return mod.TableBatch(cols)


@pytest.fixture(scope="module")
def parts():
    return [make_part(s) for s in range(PARTS)]


def fit_both(graph, parts, tmp_path, nulls=()):
    """(JAX workflow, port workflow), each fitted on ``parts``."""
    jwf = jnvt.Workflow(graph(jops, out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([batch(jnvt, p, nulls) for p in parts]))
    pwf = pnvt.Workflow(graph(pops), device="cpu")
    pwf.fit(pnvt.Dataset([batch(pnvt, p, nulls) for p in parts]))
    return jwf, pwf


def keyed_state(keyed):
    return {
        "key_cols": list(keyed.key_cols),
        "key_arrays": {k: np.asarray(v) for k, v in keyed.key_arrays.items()},
        "stats": {k: np.asarray(v) for k, v in keyed.stats.items()},
    }


def jax_state(jwf):
    """The JAX workflow's fitted group stats in convert's format."""
    state = {"target_encoding": {}, "join_groupby": {}}
    for node in jwf.graph.nodes:
        op = node.op
        if isinstance(op, jops.TargetEncoding):
            for tag, keyed in op.fold_stats.items():
                state["target_encoding"][tag] = {
                    "means": dict(op.means),
                    "fold_stats": keyed_state(keyed),
                    "overall_stats": keyed_state(op.overall_stats[tag]),
                }
        elif isinstance(op, jops.JoinGroupby):
            for name, keyed in op.keyed.items():
                state["join_groupby"][name] = keyed_state(keyed)
    return state


def assert_same_keyed(got, want, sort=False):
    """Keys exact and stats within SUM_TOL; ``sort``: compare in key order
    (the reference's per-group totals keep arrow's group_by order)."""
    assert got["key_cols"] == want["key_cols"]
    order_g = order_w = slice(None)
    if sort:
        order_g = np.lexsort([got["key_arrays"][k] for k in reversed(got["key_cols"])])
        order_w = np.lexsort([want["key_arrays"][k] for k in reversed(want["key_cols"])])
    for k in want["key_cols"]:
        g, w = got["key_arrays"][k][order_g], want["key_arrays"][k][order_w]
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert sorted(got["stats"]) == sorted(want["stats"])
    for name, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][name][order_g], w[order_w], **SUM_TOL, err_msg=name)


def assert_same_output(got, want, exact=()):
    """got: port TableBatch; want: JAX TableBatch (host). Integer columns and
    those in ``exact`` equal, floats within FLOAT_TOL (NaN where NaN)."""
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = got[name].values.numpy(), np.asarray(want[name].values)
        assert g.dtype == w.dtype, name
        if w.dtype.kind == "f" and name not in exact:
            np.testing.assert_allclose(g, w, **FLOAT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def transform_both(jwf, pwf, part, row_offset=0, nulls=()):
    jb, pb = batch(jnvt, part, nulls), batch(pnvt, part, nulls)
    jb.row_offset = pb.row_offset = row_offset
    return pwf.transform(pb), jwf.transform(jb).to_host()


def group_op(wf, cls):
    return next(n.op for n in wf.graph.nodes if isinstance(n.op, cls))


# --- fit ------------------------------------------------------------------------------
@pytest.mark.parametrize("kfold", [3, 1])
def test_target_encoding_fit_matches_jax(parts, tmp_path, kfold):
    """Fold stats keyed (fold, key) ascending and the per-key totals, with
    null keys grouped by their placeholder values and NaN / null targets
    left out of sum and count."""

    def graph(ops, **kw):
        return KEYS >> ops.TargetEncoding("rating", kfold=kfold, **kw)

    jwf, pwf = fit_both(graph, parts, tmp_path, nulls=("userId", "rating"))
    want, got = jax_state(jwf)["target_encoding"], pnvt.fitted_state(pwf)["target_encoding"]
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for tag, ref in want.items():
        np.testing.assert_allclose(got[tag]["means"]["rating"], ref["means"]["rating"], **SUM_TOL)
        assert_same_keyed(got[tag]["fold_stats"], ref["fold_stats"])
        assert_same_keyed(got[tag]["overall_stats"], ref["overall_stats"], sort=True)
    te = group_op(pwf, pops.TargetEncoding)
    kinds = {tag: type(k.lookup_struct()) for tag, k in te.overall_stats.items()}
    assert kinds == {"userId": DirectLookup, "movieId": TinyLookup, "tagId": CuckooLookup}


def test_join_groupby_fit_matches_jax(parts, tmp_path):
    """Every stat of _SUPPORTED over two continuous columns, one with NaN
    and nulls. std and var subtract sum²/n from the sum of squares: the
    summation-order difference of the float64 sums grows by that
    cancellation, so they are held to rtol=1e-9."""
    stats = list(pops.join_groupby._SUPPORTED)

    def graph(ops, **kw):
        return KEYS >> ops.JoinGroupby(cont_cols=["rating", "ts_delta"], stats=stats, **kw)

    jwf, pwf = fit_both(graph, parts, tmp_path, nulls=("movieId", "rating"))
    want, got = jax_state(jwf)["join_groupby"], pnvt.fitted_state(pwf)["join_groupby"]
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for name, ref in want.items():
        loose = {k for k in ref["stats"] if k.endswith((".std", ".var"))}
        exact = {**ref, "stats": {k: v for k, v in ref["stats"].items() if k not in loose}}
        mine = {**got[name], "stats": {k: v for k, v in got[name]["stats"].items() if k not in loose}}
        assert_same_keyed(mine, exact)
        for k in loose:
            np.testing.assert_allclose(got[name]["stats"][k], ref["stats"][k], rtol=1e-9, err_msg=k)


# --- transform ------------------------------------------------------------------------
@pytest.mark.parametrize("p_smooth", [20, 0])
@pytest.mark.parametrize("kfold", [3, 1])
def test_target_encoding_matches_jax(parts, tmp_path, kfold, p_smooth):
    """Out-of-fold TE on a fitted partition, on unseen keys and at a row
    offset just below 2**32 (the fold hash's 32-bit carry), with null keys
    and NaN / null targets; ``__fold__`` kept (drop_folds=False). With
    p_smooth 0 a key seen only in its own fold divides 0 by 0 and reads the
    global mean."""

    def graph(ops, **kw):
        return KEYS >> ops.TargetEncoding("rating", kfold=kfold, p_smooth=p_smooth, drop_folds=False, **kw)

    nulls = ("userId", "tagId", "rating")
    jwf, pwf = fit_both(graph, parts, tmp_path, nulls=nulls)
    probe = make_part(77, shift=150)  # partly unseen keys
    for part, offset in ((parts[1], ROWS), (probe, 2**32 - ROWS // 2), (probe, 0)):
        got, want = transform_both(jwf, pwf, part, offset, nulls)
        assert_same_output(got, want)
        assert ("__fold__" in got.column_names) == (kfold > 1)
    assert [cs.name for cs in pwf.output_schema] == [cs.name for cs in jwf.output_schema]
    assert {k: v.name for k, v in pwf.output_dtypes.items()} == {k: v.name for k, v in jwf.output_dtypes.items()}


def test_target_encoding_out_col_and_multiple_targets(parts, tmp_path):
    def graph(ops, **kw):
        return ["userId", "movieId"] >> ops.TargetEncoding(
            ["rating", "ts_delta"], kfold=2, p_smooth=5, out_col=["a", "b", "c"], **kw
        )

    jwf, pwf = fit_both(graph, parts, tmp_path)
    got, want = transform_both(jwf, pwf, parts[2], 2 * ROWS)
    assert got.column_names == ["a", "b", "c", "TE_movieId_ts_delta"]
    assert_same_output(got, want)


def test_join_groupby_matches_jax(parts, tmp_path):
    """Every stat: counts int32 (0 for a miss or a null key), stats float32
    (NaN for a miss, a null key, or a group without valid values)."""
    stats = list(pops.join_groupby._SUPPORTED)

    def graph(ops, **kw):
        return KEYS >> ops.JoinGroupby(cont_cols=["rating", "ts_delta"], stats=stats, **kw)

    nulls = ("movieId", "rating")
    jwf, pwf = fit_both(graph, parts, tmp_path, nulls=nulls)
    for part in (parts[0], make_part(78, shift=200)):
        got, want = transform_both(jwf, pwf, part, nulls=nulls)
        assert_same_output(got, want)
    assert {k: v.name for k, v in pwf.output_dtypes.items()} == {k: v.name for k, v in jwf.output_dtypes.items()}


def _hash_column(kind, n=5000):
    r = np.random.default_rng(12)
    if kind == "float32":
        v = r.normal(0.0, 1e4, n).astype(np.float32)
        v[:5] = [np.nan, np.inf, -0.0, 0.0, -np.inf]
        return v
    lo, hi = (-(2**31), 2**31 - 1) if kind != "int64_wide" else (-(2**62), 2**62)
    v = r.integers(lo, hi, n, dtype=np.int64)
    v[:3] = [lo, hi, -1]
    return v.astype(np.int32) if kind == "int32" else v


@pytest.mark.parametrize("kind", ["int32", "int64_in", "int64_wide", "float32"])
def test_hashed_cross_matches_jax(kind):
    """int32, int64 inside int32 and float32 equal the reference's device
    path (int32 lanes, f32 bits); int64 outside int32 equals its host path
    (the true high word), where the device path cannot take it."""
    other = _hash_column("int32")[::-1].copy()
    values = _hash_column(kind)
    device = kind != "int64_wide"
    for names in (["a"], ["b", "a"]):
        data = {"a": values, "b": other}
        jb = jnvt.TableBatch({k: jnvt.Column(jnp.asarray(v) if device else v) for k, v in data.items()})
        want = jops.HashedCross(10_007).transform(JSelector(names), jb)
        got = pops.HashedCross(10_007).transform(PSelector(names), pnvt.TableBatch.from_pydict(data))
        assert got.column_names == want.column_names == ["_X_".join(sorted(names))]
        np.testing.assert_array_equal(got[got.column_names[0]].values.numpy(), np.asarray(want[want.column_names[0]].values))


def test_hash_functions_match_jax():
    """dispatch.hash_array / hash_lanes and groupby_stats.hash_multi_key."""
    for kind in ("int32", "int64_in", "float32"):
        v = _hash_column(kind)
        want = np.asarray(jdispatch.hash_array(jnp.asarray(v), seed=5)).astype(np.int64)
        assert torch.equal(pdispatch.hash_array(torch.from_numpy(v), seed=5), torch.from_numpy(want))
    wide = _hash_column("int64_wide")
    want = jdispatch.hash_array(wide, seed=5).astype(np.int64)
    assert torch.equal(pdispatch.hash_array(torch.from_numpy(wide), seed=5), torch.from_numpy(want))
    r = np.random.default_rng(13)
    lo, hi = (r.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    want = jdispatch.hash_lanes(lo, hi, seed=9).astype(np.int64)
    got = pdispatch.hash_lanes(torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(hi.astype(np.int64)), 9)
    assert torch.equal(got, torch.from_numpy(want))
    keys = [_hash_column("int32"), _hash_column("int64_in")[::-1].copy()]
    want = jgs.hash_multi_key(keys, seed=0xA1).astype(np.int64)
    got = pgs.hash_multi_key([torch.from_numpy(k) for k in keys], seed=0xA1)
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("row_offset", [0, 2**32 - 1000, 3 * 2**40 + 17])
@pytest.mark.parametrize("kfold", [3, 7])
def test_fold_ids_match_jax(row_offset, kfold):
    """Host fold ids and the device ones with their 32-bit carry, across the
    2**32 boundary of the global row index."""
    n = 3000
    got = khash.fold_ids(row_offset, n, kfold, 42, "cpu").numpy()
    host = jte._fold_ids(row_offset, n, kfold, 42)
    lanes = (jnp.uint32(row_offset & 0xFFFFFFFF), jnp.uint32(row_offset >> 32))
    dev = np.asarray(jte._fold_ids_dev(lanes, n, kfold, 42))
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, dev)
    assert got.dtype == np.int32 and set(np.unique(got)) == set(range(kfold))


@pytest.mark.parametrize("form", ["list", "dict"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64"])
def test_bucketize_matches_jax(form, dtype):
    """Values on the boundaries, NaN and infinities; boundaries cast to the
    column's dtype as the reference's device path casts them (5.5 → 5 for
    an int column); the validity mask passes through."""
    r = np.random.default_rng(14)
    bounds = [-2.0, 5.5, 60.0, 3600.0, 86400.0]
    x = r.uniform(-10, 1e5, 4000)
    x[:5] = bounds
    x[5:7] = [5.0, 6.0]
    if dtype.startswith("float"):
        x[7:10] = [np.nan, np.inf, -np.inf]
    x = x.astype(dtype)
    valid = r.random(len(x)) > 0.1
    spec = bounds if form == "list" else {"x": bounds, "unused": [1.0]}
    want = jops.Bucketize(spec).transform(JSelector(["x"]), jnvt.TableBatch({"x": jnvt.Column(jnp.asarray(x), None, jnp.asarray(valid))}))
    got = pops.Bucketize(spec).transform(PSelector(["x"]), pnvt.TableBatch({"x": pnvt.Column(x, None, valid)}))
    np.testing.assert_array_equal(got["x"].values.numpy(), np.asarray(want["x"].values))
    np.testing.assert_array_equal(got["x"].validity.numpy(), valid)
    assert got["x"].values.dtype == torch.int32
    if dtype == "float32":  # the reference's host path (np.digitize) agrees
        host = jops.Bucketize(spec).transform(JSelector(["x"]), jnvt.TableBatch({"x": jnvt.Column(x)}))
        np.testing.assert_array_equal(got["x"].values.numpy(), host["x"].values)


def test_lambda_bucketize_runs_the_udf_on_the_host(parts, tmp_path):
    """LambdaOp(np.log1p) → Bucketize: the UDF reads the column through
    numpy (Column.__array__), and the executor's host handoff (a card
    batch's columns to the host and the result back) gives what the op
    gives in place, counting one handoff."""
    seen = []

    def log1p(col):
        seen.append(type(np.asarray(col)))
        return np.log1p(col)

    def graph(ops, **kw):
        return ["ts_delta"] >> ops.LambdaOp(log1p) >> ops.Bucketize([5.0, 8.0, 11.0, 12.0])

    jwf, pwf = fit_both(graph, parts, tmp_path)
    got, want = transform_both(jwf, pwf, parts[0])
    assert_same_output(got, want)
    assert seen and set(seen) == {np.ndarray}
    assert set(np.unique(got["ts_delta"].values.numpy())) == set(range(5))

    lam = next(n for n in pwf.graph.nodes if isinstance(n.op, pops.LambdaOp))
    ex = LocalExecutor()
    pb = batch(pnvt, parts[0])
    handed = ex._apply_on_host(lam, pb)
    torch.testing.assert_close(handed["ts_delta"].values, lam.op.transform(lam.selector, pb)["ts_delta"].values)
    assert ex.host_handoffs == 1 and ex.host_handoff_seconds > 0
    both = pops.LambdaOp(lambda col, b: np.asarray(col) * np.asarray(b["rating"]))
    want = both.transform(PSelector(["ts_delta"]), pb)["ts_delta"].values
    got = ex._apply_on_host(Node(PSelector(["ts_delta"]), both), pb)["ts_delta"].values
    torch.testing.assert_close(got, want, equal_nan=True)  # f(col, batch) sees every column
    meta = pnvt.Column(torch.empty(3, device="meta"))
    with pytest.raises(TypeError, match="host columns only"):
        np.asarray(meta)


def advanced_graph(ops, **kw):
    """BASELINE config 2 (bench/movielens_bench.py:73-85)."""
    te = ["userId", "movieId"] >> ops.TargetEncoding("rating", kfold=3, p_smooth=20, **kw)
    jg = ["movieId"] >> ops.JoinGroupby(cont_cols=["ts_delta"], stats=["mean", "count"], **kw)
    lam = ["ts_delta"] >> ops.LambdaOp(np.log1p) >> ops.Bucketize({"ts_delta": BOUNDS})
    cross = ["userId", "movieId"] >> ops.HashedCross(10_000)
    return te + jg + lam + cross + ["rating"]


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
def test_advanced_workflow_matches_jax(parts, tmp_path, fitted_by):
    """The whole config-2 workflow over every partition at its dataset row
    offset and on an unseen probe: fitted by the port itself, or carried
    from the JAX fit by convert.load_fitted_state."""
    jwf, pwf = fit_both(advanced_graph, parts, tmp_path)
    if fitted_by == "jax_state":
        pwf = pnvt.Workflow(advanced_graph(pops), device="cpu")
        pnvt.load_fitted_state(pwf, jax_state(jwf))
    for i, part in enumerate(parts + [make_part(79, shift=100)]):
        got, want = transform_both(jwf, pwf, part, i * ROWS)
        assert_same_output(got, want)
    assert (got["ts_delta"].values == 0).all()  # log1p(ts_delta) < 60: bucket 0
    assert [cs.name for cs in pwf.output_schema] == [cs.name for cs in jwf.output_schema]
    schema = {cs.name: cs for cs in pwf.output_schema}
    assert schema["movieId_X_userId"].properties["domain"] == {"min": 0, "max": 9999, "name": "movieId_X_userId"}
    out = list(pwf.transform(pnvt.Dataset(parts)).to_batches())
    again, _ = transform_both(jwf, pwf, parts[2], 2 * ROWS)
    for name in again.column_names:
        torch.testing.assert_close(out[2][name].values, again[name].values, rtol=0, atol=0, equal_nan=True)


def test_group_index_maps_misses_and_nulls_to_the_pad_slot():
    keyed = pgs.KeyedStats(["k"], {"x.sum": np.array([1.0, 2.0, 3.0])}, {"k": np.array([5, 9, 2**31 - 1])})
    index = keyed.group_index("cpu")
    col = pnvt.Column(np.array([9, 5, 4, -(2**31), 2**31 - 1, 9]), None, np.array([1, 1, 1, 1, 1, 0], bool))
    assert index(col).tolist() == [1, 0, 3, 3, 2, 3]
    empty = pgs.KeyedStats(["k"], {}, {"k": np.array([], np.int64)}).group_index("cpu")
    assert empty(pnvt.Column(np.array([1, 2]))).tolist() == [0, 0]


def _fit_group_op(make, data):
    pnvt.Workflow(make(), device="cpu").fit(pnvt.Dataset(data))


def _transform_group_op(make, data):
    wf = pnvt.Workflow(make(), device="cpu")
    wf.fit(pnvt.Dataset(data))
    wf.transform(pnvt.TableBatch.from_pydict(data))


def _transform_colliding_pair(make, data):
    """Every tuple hashes to one h1: the pair cannot be built."""
    real = pgs.hash_pair

    def colliding(cols):
        h1, h2 = real(cols)
        return torch.zeros_like(h1), h2

    pgs.hash_pair = colliding
    try:
        _transform_group_op(make, data)
    finally:
        pgs.hash_pair = real


def _transform_wide_keys(make, data):
    wf = pnvt.Workflow(make(), device="cpu")
    wf.fit(pnvt.Dataset(data))
    wf.transform(pnvt.TableBatch.from_pydict(dict(data, a=np.full(10, 2**40))))


_DATA = {"a": np.arange(10), "b": np.arange(10) % 3, "y": np.ones(10, np.float32)}
_STRINGS = dict(_DATA, a=np.array([f"s{i}" for i in range(10)], dtype=object))


@pytest.mark.parametrize(
    "make, run, data, match",
    [
        (lambda: [["a", "b"]] >> pops.TargetEncoding("y"), _transform_group_op, dict(_DATA, b=np.arange(10) << 32),
         "queue 1 item 4"),
        (lambda: [["a", "b"]] >> pops.JoinGroupby(cont_cols=["y"]), _transform_colliding_pair, _DATA, "queue 1 item 4"),
        (lambda: ["a"] >> pops.TargetEncoding("y"), _fit_group_op, _STRINGS, "queue 1 item 4: strings"),
        (lambda: ["a"] >> pops.JoinGroupby(cont_cols=["y"]), _transform_wide_keys, _DATA, "queue 1 item 4: strings"),
        (lambda: pops.TargetEncoding("y", out_path="x"), None, None, "queue 1 item 2: save/load"),
        (lambda: pops.JoinGroupby(cont_cols=["y"], out_path="x"), None, None, "queue 1 item 2: save/load"),
    ],
    ids=["te_multi_key", "join_multi_key", "string_keys", "wide_keys", "te_out_path", "join_out_path"],
)
def test_unported_paths_raise(make, run, data, match):
    """A multi-key group whose verified hash pair cannot be built (keys
    outside int32; a collision among the fitted tuples' h1), string keys,
    keys outside int32 at a group index and the parquet artifacts raise,
    naming their ROADMAP.md item."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {match}"):
        make() if run is None else run(make, data)
