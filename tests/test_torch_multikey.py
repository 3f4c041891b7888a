"""Crossed and session features of nvtabular_tpu_torch against the JAX
reference: multi-column TargetEncoding / JoinGroupby groups (the verified
hash pair, K10b), Categorify(encode_type="combo") (K9), DifferenceLag (K12a)
and HashBucket (K7), and the whole crossed-feature workflow.

Both packages see the same seeded numpy data. The port runs on the CPU
(``device="cpu"``: the kernels' plain versions); the reference runs
``Workflow(graph, executor=JitExecutor(jit_min_rows=0))``, its device path
on CPU-JAX. Group indexes, combo codes, bucket ids and counts must be equal;
TE values and stat columns agree within rtol=1e-6 (the same float32
operations in the same order from float64 sums that differ only in
summation order); DifferenceLag's floats are bit-equal (one float32
subtraction each, or NaN).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvtabular_tpu as jnvt
import nvtabular_tpu_torch as pnvt
from nvtabular_tpu import ops as jops
from nvtabular_tpu.dag.executor import JitExecutor
from nvtabular_tpu.dag.executor import LocalExecutor as JLocalExecutor
from nvtabular_tpu.ops import groupby_stats as jgs
from nvtabular_tpu.selector import ColumnSelector as JSelector
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.kernels import difference_lag as kdl
from nvtabular_tpu_torch.kernels import hash_pair as khp
from nvtabular_tpu_torch.ops import groupby_stats as pgs
from nvtabular_tpu_torch.ops.lookup import CuckooLookup, TinyLookup
from nvtabular_tpu_torch.selector import ColumnSelector as PSelector

ROWS, PARTS = 3000, 3
FLOAT_TOL = dict(rtol=1e-6, atol=1e-7)
SUM_TOL = dict(rtol=1e-12, atol=0)


def make_part(seed, n=ROWS, shift=0):
    """Three low-cardinality keys (a: 5 values, b: 40 spread over int32, c:
    4 values, negative), a wider one (w: 900 values) and two float columns
    with ~3% NaN; ``shift`` moves the keys out of the fitted tuples."""
    r = np.random.default_rng(seed)
    y = (r.integers(1, 11, n) / 2.0).astype(np.float32)
    y[r.random(n) < 0.03] = np.nan
    return {
        "a": (r.integers(0, 5, n) + shift).astype(np.int32),
        "b": (((r.integers(0, 40, n) + shift) * 2654435761) % 2**31).astype(np.int64),
        "c": (r.integers(-4, 0, n) - shift).astype(np.int32),
        "w": (r.zipf(1.3, n) % 900 + shift).astype(np.int32),
        "y": y,
        "x": r.normal(0.0, 5.0, n).astype(np.float32),
    }


def batch(mod, part, nulls=()):
    """A TableBatch of ``mod``; the columns in ``nulls`` get ~10% nulls."""
    r = np.random.default_rng(len(part["a"]) + 1)
    return mod.TableBatch(
        {k: mod.Column(v, None, r.random(len(v)) > 0.1 if k in nulls else None) for k, v in part.items()}
    )


@pytest.fixture(scope="module")
def parts():
    return [make_part(s) for s in range(PARTS)]


def fit_both(graph, parts, tmp_path, nulls=(), fitted_by="port"):
    """(JAX workflow, port workflow) fitted on ``parts``; ``fitted_by`` =
    "jax_state" gives the port the JAX fit through convert."""
    jwf = jnvt.Workflow(graph(jops, out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([batch(jnvt, p, nulls) for p in parts]))
    pwf = pnvt.Workflow(graph(pops), device="cpu")
    if fitted_by == "port":
        pwf.fit(pnvt.Dataset([batch(pnvt, p, nulls) for p in parts]))
    else:
        pnvt.load_fitted_state(pwf, jax_state(jwf))
    return jwf, pwf


def keyed_state(keyed):
    return {
        "key_cols": list(keyed.key_cols),
        "key_arrays": {k: np.asarray(v) for k, v in keyed.key_arrays.items()},
        "stats": {k: np.asarray(v) for k, v in keyed.stats.items()},
    }


def jax_state(jwf):
    """The JAX workflow's fitted state in convert's format."""
    state = {"categorify": {}, "target_encoding": {}, "join_groupby": {}}
    for node in jwf.graph.nodes:
        op = node.op
        if isinstance(op, jops.Categorify):
            for key, v in op.vocabs.items():
                state["categorify"][key] = {
                    "values_by_code": np.asarray(v.values_by_code), "num_buckets": v.num_buckets, "offset": v.offset,
                }
        elif isinstance(op, jops.TargetEncoding):
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


def assert_same_output(got, want):
    """got: port TableBatch; want: JAX TableBatch (host). Integer columns
    equal, floats within FLOAT_TOL (NaN where NaN)."""
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = got[name].values.numpy(), np.asarray(want[name].values)
        assert g.dtype == w.dtype, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, **FLOAT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def transform_both(jwf, pwf, part, row_offset=0, nulls=()):
    jb, pb = batch(jnvt, part, nulls), batch(pnvt, part, nulls)
    jb.row_offset = pb.row_offset = row_offset
    return pwf.transform(pb), jwf.transform(jb).to_host()


def group_op(wf, cls):
    return next(n.op for n in wf.graph.nodes if isinstance(n.op, cls))


# --- the hashes -------------------------------------------------------------------------
def _key_column(kind, r, n=5000):
    v = r.integers(-(2**31), 2**31 - 1, n, dtype=np.int64)
    v[:3] = [-(2**31), 2**31 - 1, -1]
    return v.astype(np.int32) if kind == "int32" else v


@pytest.mark.parametrize(
    "kinds", [["int32", "int32"], ["int64", "int32", "int64"], ["int64"] * 4], ids=["2_int32", "3_mixed", "4_int64"]
)
def test_hash_pair_plain_matches_jax(kinds):
    """h1 and h2 bit for bit against hash_multi_key on the reference's host
    path (numpy int64 lanes) and device path (jnp int32), wrapped to int32
    as its probe wraps h1; dispatch-level hash_multi_key likewise."""
    r = np.random.default_rng(21)
    cols = [_key_column(k, r) for k in kinds]
    h1, h2 = khp.hash_pair([torch.from_numpy(c) for c in cols])
    assert h1.dtype == h2.dtype == torch.int32
    for got, seed in ((h1, 0xA1), (h2, 0xB7)):
        host = jgs.hash_multi_key(cols, seed=seed)
        dev = np.asarray(jgs.hash_multi_key([jnp.asarray(c.astype(np.int32)) for c in cols], seed=seed))
        np.testing.assert_array_equal(host, dev)
        np.testing.assert_array_equal(got.numpy(), host.astype(np.int64).astype(np.int32))
        full = pgs.hash_multi_key([torch.from_numpy(c) for c in cols], seed)
        np.testing.assert_array_equal(full.numpy(), host.astype(np.int64))


def test_group_index_of_tuples_maps_misses_and_nulls_to_the_pad_slot():
    """A hit of h1 whose h2 differs is a miss; a null member is the pad."""
    a, b = np.array([5, 9, 2**31 - 1, -7]), np.array([1, 1, 3, -(2**31)])
    keyed = pgs.KeyedStats(["a", "b"], {"x.sum": np.arange(4.0)}, {"a": a, "b": b})
    index = keyed.group_index("cpu")
    qa = pnvt.Column(np.array([9, 5, -7, 5, 2**31 - 1, 9, 4]), None, np.array([1, 1, 1, 1, 1, 0, 1], bool))
    qb = pnvt.Column(np.array([1, 1, -(2**31), 3, 3, 1, 1]))
    assert index(qa, qb).tolist() == [1, 0, 3, 4, 2, 4, 4]
    rows, found = keyed.row_indices([np.array([9, 5, 4]), np.array([1, 3, 1])])
    assert rows.tolist() == [1, 0, 0] and found.tolist() == [True, False, False]
    pair = keyed.hashed_lookup_struct()
    assert isinstance(pair[0], TinyLookup) and pair[1].dtype == np.int32 and pair[1][-1] == 0
    idx = torch.tensor([1, 4, 0], dtype=torch.int32)
    h2 = torch.from_numpy(pair[1][[1, 0, 2]])  # row 2's h2 does not match group 0's
    out = khp.hash_pair_verify(idx, h2, torch.from_numpy(pair[1]), [torch.tensor([1, 1, 0], dtype=torch.bool)],
                               4, 10, 2, 1)
    assert out.tolist() == [11, 2, 1]


# --- TargetEncoding and JoinGroupby on groups of several columns ---------------------
@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
@pytest.mark.parametrize("p_smooth", [20, 0])
@pytest.mark.parametrize("kfold", [5, 1])
def test_multi_key_target_encoding_matches_jax(parts, tmp_path, kfold, p_smooth, fitted_by):
    """Out-of-fold TE on a 2-column, a 3-column and a one-column group, on a
    fitted partition and on partly unseen tuples, with null keys and NaN /
    null targets; the fold stats of the port's own fit equal the JAX fit's."""

    def graph(ops, **kw):
        return [["a", "b"], ["a", "b", "c"], "w"] >> ops.TargetEncoding(
            "y", kfold=kfold, p_smooth=p_smooth, drop_folds=False, **kw
        )

    nulls = ("a", "c", "y")
    jwf, pwf = fit_both(graph, parts, tmp_path, nulls, fitted_by)
    probe = make_part(77, shift=3)
    for part, offset in ((parts[1], ROWS), (probe, 2**32 - ROWS // 2)):
        got, want = transform_both(jwf, pwf, part, offset, nulls)
        assert_same_output(got, want)
    assert got.column_names[:3] == ["TE_a_b_y", "TE_a_b_c_y", "TE_w_y"]
    te = group_op(pwf, pops.TargetEncoding)
    assert isinstance(te.overall_stats["a_b"].lookup_struct(), TinyLookup)  # 200 tuples
    assert isinstance(te.overall_stats["a_b_c"].lookup_struct(), CuckooLookup)  # 800
    if fitted_by == "port":
        want = jax_state(jwf)["target_encoding"]["a_b_c"]["fold_stats"]
        got = pnvt.fitted_state(pwf)["target_encoding"]["a_b_c"]["fold_stats"]
        assert got["key_cols"] == want["key_cols"]
        for k in want["key_cols"]:
            np.testing.assert_array_equal(got["key_arrays"][k], want["key_arrays"][k].astype(got["key_arrays"][k].dtype))
        np.testing.assert_allclose(got["stats"]["y.sum"], want["stats"]["y.sum"], **SUM_TOL)


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
def test_multi_key_join_groupby_matches_jax(parts, tmp_path, fitted_by):
    """count, mean and std of two continuous columns per 2-column group:
    a tiny (a, c) and a cuckoo (a, w) table of h1; null keys never join."""

    def graph(ops, **kw):
        return [["a", "c"], ["a", "w"]] >> ops.JoinGroupby(cont_cols=["y", "x"], stats=["count", "mean", "std"], **kw)

    nulls = ("w", "y")
    jwf, pwf = fit_both(graph, parts, tmp_path, nulls, fitted_by)
    for part in (parts[0], make_part(78, shift=2)):
        got, want = transform_both(jwf, pwf, part, nulls=nulls)
        assert_same_output(got, want)
    jg = group_op(pwf, pops.JoinGroupby)
    assert isinstance(jg.keyed["a_c"].lookup_struct(), TinyLookup)
    assert isinstance(jg.keyed["a_w"].lookup_struct(), CuckooLookup)
    assert {k: v.name for k, v in pwf.output_dtypes.items()} == {k: v.name for k, v in jwf.output_dtypes.items()}


# --- Categorify combo -------------------------------------------------------------------
def _combo_part(seed, n=2000, shift=0):
    """Crossed pairs with tied counts whose string order is not their tuple
    order ((10, 3) → "10_3" before (1, 30) → "1_30") and negative ids."""
    r = np.random.default_rng(seed)
    a = r.integers(-3, 12, n).astype(np.int32)
    b = (r.integers(0, 31, n) - 2 * (a < 0)).astype(np.int64) + shift
    a[:8], b[:8] = [10, 1, 10, 1, -5, -5, 10, 1], [3, 30, 3, 30, 3, 3, 3, 30]
    return {"a": a, "b": b, "c": r.integers(0, 3, n).astype(np.int32)}


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
@pytest.mark.parametrize("cat_kwargs", [{}, {"freq_threshold": 3}, {"max_size": 60, "single_table": True}],
                         ids=["plain", "freq_threshold", "max_size_single_table"])
def test_combo_codes_match_jax(tmp_path, cat_kwargs, fitted_by):
    """Combo codes exact on fitted, unseen and null-member rows; the port's
    fitted vocabulary is the JAX one's, tuple for string, in code order."""

    def graph(ops, **kw):
        return [["a", "b"], "c", ["c", "a"]] >> ops.Categorify(encode_type="combo", **cat_kwargs, **kw)

    parts = [_combo_part(s) for s in range(3)]
    nulls = ("b",)
    jwf = jnvt.Workflow(graph(jops, out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([batch(jnvt, dict(p, y=p["c"]), nulls) for p in parts]))
    pwf = pnvt.Workflow(graph(pops), device="cpu")
    if fitted_by == "port":
        pwf.fit(pnvt.Dataset([batch(pnvt, dict(p, y=p["c"]), nulls) for p in parts]))
    else:
        pnvt.load_fitted_state(pwf, jax_state(jwf))
    want = jax_state(jwf)["categorify"]
    got = pnvt.fitted_state(pwf)["categorify"]
    assert sorted(got) == sorted(want) == ["a_b", "c", "c_a"]
    for key in ("a_b", "c_a"):
        assert got[key]["values_by_code"].shape[1] == 2
        joined = ["_".join(str(v) for v in t) for t in got[key]["values_by_code"]]
        assert joined == [str(v) for v in want[key]["values_by_code"]], key
        assert got[key]["offset"] == want[key]["offset"]
    for part in (parts[1], _combo_part(9, shift=25)):
        p, j = batch(pnvt, dict(part, y=part["c"]), nulls), batch(jnvt, dict(part, y=part["c"]), nulls)
        assert_same_output(pwf.transform(p), jwf.transform(j).to_host())
    assert [cs.name for cs in pwf.output_schema] == [cs.name for cs in jwf.output_schema]
    sizes = pops.get_embedding_sizes(pwf)
    assert sizes["a_b"][0] == len(got["a_b"]["values_by_code"]) + 3
    assert sizes == jops.get_embedding_sizes(jwf)


def test_combo_tie_order_is_the_string_order(tmp_path):
    """Equal counts order by the "_"-joined string, negative ids included:
    (10, 3) before (1, 30), as the JAX fit orders "10_3" before "1_30"."""
    a = np.array([1, 10, -5, 1, 10, -5, 2, 2, 2], np.int32)
    b = np.array([30, 3, 3, 30, 3, 3, 7, 7, 7], np.int64)
    wf = pnvt.Workflow([["a", "b"]] >> pops.Categorify(encode_type="combo"), device="cpu")
    wf.fit(pnvt.Dataset({"a": a, "b": b}))
    vocab = pnvt.fitted_state(wf)["categorify"]["a_b"]["values_by_code"]
    assert vocab.tolist() == [[2, 7], [-5, 3], [10, 3], [1, 30]]
    jwf = jnvt.Workflow([["a", "b"]] >> jops.Categorify(encode_type="combo", out_path=str(tmp_path)))
    jwf.fit(jnvt.Dataset(jnvt.TableBatch.from_pydict({"a": a, "b": b})))
    assert jax_state(jwf)["categorify"]["a_b"]["values_by_code"].tolist() == ["2_7", "-5_3", "10_3", "1_30"]
    out = wf.transform(pnvt.TableBatch.from_pydict({"a": np.array([10, 1, 2, 3]), "b": np.array([3, 30, 7, 3])}))
    assert out["a_b"].values.tolist() == [5, 6, 3, 2]


# --- DifferenceLag ----------------------------------------------------------------------
def _sessions(seed, n, key_base=1):
    """Rows sorted by (user, day) with two partition columns, an int and a
    float value column with NaN, and a float64 value."""
    r = np.random.default_rng(seed)
    user = np.sort(r.integers(key_base, key_base + n // 6, n)).astype(np.int64)
    day = np.zeros(n, np.int32)
    for u in np.unique(user):
        at = np.nonzero(user == u)[0]
        day[at] = np.sort(r.integers(1, 4, len(at)))
    rating = (r.integers(1, 11, n) / 2.0).astype(np.float32)
    rating[r.random(n) < 0.05] = np.nan
    return {
        "user": user, "day": day, "rating": rating, "count": r.integers(-50, 50, n).astype(np.int64),
        "ts": r.exponential(1e5, n),
    }


def _lag_graph(ops):
    return ["rating", "count", "ts"] >> ops.DifferenceLag(["user", "day"], shift=[1, -1, 2])


@pytest.mark.parametrize("n", [4096, 1024])
def test_difference_lag_matches_jax_device_path(n):
    """Against JitExecutor on batches of a power-of-two length (no pad
    rows): bit-equal floats, NaN where NaN, the first / last |shift| rows of
    the batch NaN."""
    data = _sessions(31, n)
    jwf = jnvt.Workflow(_lag_graph(jops), executor=JitExecutor(jit_min_rows=0))
    pwf = pnvt.Workflow(_lag_graph(pops), device="cpu")
    want = jwf.transform(jnvt.TableBatch.from_pydict(data)).to_host()
    got = pwf.transform(pnvt.TableBatch.from_pydict(data))
    names = [f"{c}_difference_lag_{s}" for s in (1, -1, 2) for c in ("rating", "count", "ts")]
    assert got.column_names == names == want.column_names
    for name in names:
        g, w = got[name].values.numpy(), np.asarray(want[name].values)
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w, err_msg=name)  # NaN equals NaN here
    assert np.isnan(got["rating_difference_lag_2"].values.numpy()[:2]).all()
    assert np.isnan(got["count_difference_lag_-1"].values.numpy()[-1])
    assert [cs.name for cs in pwf.output_schema] == [cs.name for cs in jwf.output_schema]


def test_difference_lag_follows_the_host_path_at_the_batch_end():
    """The pad case: a batch of 1,000 rows whose last partition key is 0.
    JitExecutor pads to 1,024 zero rows, so the reference's device path
    reads x - 0 for the last row's lead; its host path (LocalExecutor) and
    the port read NaN there."""
    data = _sessions(32, 1000, key_base=0)
    data["user"][-3:] = 0
    data["day"][-3:] = 0
    host = jnvt.Workflow(_lag_graph(jops), executor=JLocalExecutor())
    dev = jnvt.Workflow(_lag_graph(jops), executor=JitExecutor(jit_min_rows=0))
    pwf = pnvt.Workflow(_lag_graph(pops), device="cpu")
    want = host.transform(jnvt.TableBatch.from_pydict(data))
    padded = dev.transform(jnvt.TableBatch.from_pydict(data)).to_host()
    got = pwf.transform(pnvt.TableBatch.from_pydict(data))
    for name in want.column_names:
        np.testing.assert_array_equal(got[name].values.numpy(), np.asarray(want[name].values), err_msg=name)
    lead = "count_difference_lag_-1"
    assert np.isnan(got[lead].values.numpy()[-1])
    assert np.asarray(padded[lead].values)[-1] == data["count"][-1]  # x - 0 against the pad row


def test_difference_lag_keys_compare_raw_values():
    """A NaN float key equals nothing; null keys compare their values."""
    keys = [torch.tensor([1.0, 1.0, float("nan"), float("nan"), 2.0], dtype=torch.float64),
            torch.tensor([3, 3, 3, 3, 3], dtype=torch.int16)]
    x = torch.tensor([1.0, 4.0, 2.0, 8.0, 5.0])
    out = kdl.difference_lag(keys, [x], [1, 0, 9])
    np.testing.assert_array_equal(out[0, 0].numpy(), [np.nan, 3.0, np.nan, np.nan, np.nan])
    np.testing.assert_array_equal(out[1, 0].numpy(), [0, 0, np.nan, np.nan, 0])
    assert torch.isnan(out[2]).all()
    assert kdl.difference_lag([], [x], [-2])[0, 0].tolist()[:3] == [-1.0, -4.0, -3.0]


# --- HashBucket -------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["int32", "int64", "int64_wide", "list"])
def test_hash_bucket_matches_jax(kind):
    """int32, int64 inside int32 and a list column against the reference's
    device path; int64 outside int32 against its host path (the true high
    word). Codes drop validity; a list keeps its offsets."""
    r = np.random.default_rng(41)
    n = 5000
    wide = kind == "int64_wide"
    v = r.integers(-(2**62) if wide else -(2**31), 2**62 if wide else 2**31 - 1, n, dtype=np.int64)
    if kind == "int32":
        v = v.astype(np.int32)
    nb = {"v": 10_000_000, "u": 7}
    u = r.integers(0, 100, n).astype(np.int32)
    valid = r.random(n) > 0.1
    if kind == "list":
        offsets = np.concatenate([[0], np.cumsum(r.integers(0, 4, n // 4))]).astype(np.int64)
        v = v[: offsets[-1]].astype(np.int32)
        pcol, jcol = pnvt.Column(v, offsets), jnvt.Column(jnp.asarray(v), jnp.asarray(offsets.astype(np.int32)))
        u, valid = u[: n // 4], valid[: n // 4]
    else:
        pcol = pnvt.Column(v, None, valid)
        jcol = jnvt.Column(v if wide else jnp.asarray(v), None, valid if wide else jnp.asarray(valid))
    jb = jnvt.TableBatch({"v": jcol, "u": jnvt.Column(u if wide else jnp.asarray(u))})
    pb = pnvt.TableBatch({"v": pcol, "u": pnvt.Column(u)})
    want = jops.HashBucket(nb).transform(JSelector(["v", "u"]), jb)
    got = pops.HashBucket(nb).transform(PSelector(["v", "u"]), pb)
    for name in ("v", "u"):
        assert got[name].values.dtype == torch.int32 and got[name].validity is None
        np.testing.assert_array_equal(got[name].values.numpy(), np.asarray(want[name].values))
    if kind == "list":
        np.testing.assert_array_equal(got["v"].offsets.numpy(), offsets)
    assert got["v"].values.max() < 10_000_000 and got["u"].values.max() < 7


def test_hash_bucket_schema_matches_jax():
    data = {"v": np.arange(10, dtype=np.int32), "u": np.arange(10, dtype=np.int64)}
    jwf = jnvt.Workflow(["v", "u"] >> jops.HashBucket({"v": 1000, "u": 10_000_000}))
    pwf = pnvt.Workflow(["v", "u"] >> pops.HashBucket({"v": 1000, "u": 10_000_000}), device="cpu")
    jwf.fit(jnvt.Dataset(jnvt.TableBatch.from_pydict(data)))
    pwf.fit(pnvt.Dataset(data))
    for j, p in zip(jwf.output_schema, pwf.output_schema):
        assert (p.name, p.dtype.name) == (j.name, j.dtype.name)
        assert p.properties["domain"] == j.properties["domain"]
        assert p.properties["embedding_sizes"] == j.properties["embedding_sizes"]
    assert pops.get_embedding_sizes(pwf) == jops.get_embedding_sizes(jwf) == {"v": (1000, 77), "u": (10_000_000, 512)}


# --- the crossed-feature workflow (chip_smoke.py phase 12) at a small size ---------------
CRITEO_CARDS = {"C0": 227605432, "C5": 3, "C8": 63, "C9": 130229467, "C12": 10, "C15": 155, "C16": 4,
                "C18": 14, "C19": 292775614, "C24": 108, "C25": 36}


def criteo_part(seed, n=8192):
    """Criteo-shaped columns as chip_smoke.py's make_part draws them."""
    r = np.random.default_rng(seed)
    data = {}
    for name, card in CRITEO_CARDS.items():
        raw = (card * r.random(n) ** 2.5).astype(np.int64)
        data[name] = ((raw * np.int64(2654435761)) % np.int64(2**31)).astype(np.int32)
    x = r.normal(1.0, 3.0, n).astype(np.float32)
    x[r.random(n) < 0.05] = np.nan
    data["I0"] = x
    data["label"] = r.integers(0, 2, n).astype(np.int32)
    return data


def crossed_graph(ops, **kw):
    """chip_smoke.py phase 12's workflow."""
    te = [["C5", "C8"], ["C12", "C16", "C18"], ["C15", "C24"]] >> ops.TargetEncoding(
        "label", kfold=5, p_smooth=20, **kw
    )
    jg = [["C5", "C8"], ["C15", "C24"]] >> ops.JoinGroupby(cont_cols=["I0"], stats=["count", "mean"], **kw)
    combo = [["C8", "C15"], ["C12", "C25"]] >> ops.Categorify(encode_type="combo", **kw)
    hb = ["C0", "C9", "C19"] >> ops.HashBucket(10_000_000)
    return te + jg + combo + hb + ["label"]


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
def test_crossed_workflow_matches_jax(tmp_path, fitted_by):
    """The phase-12 workflow over 4 x 8,192 Criteo-shaped rows, each batch at
    its dataset row offset, and a fifth unseen one."""
    cparts = [criteo_part(s) for s in range(4)]
    jwf = jnvt.Workflow(crossed_graph(jops, out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in cparts]))
    pwf = pnvt.Workflow(crossed_graph(pops), device="cpu")
    if fitted_by == "port":
        pwf.fit(pnvt.Dataset(cparts))
    else:
        pnvt.load_fitted_state(pwf, jax_state(jwf))
    for i, part in enumerate(cparts + [criteo_part(99)]):
        jb, pb = jnvt.TableBatch.from_pydict(part), pnvt.TableBatch.from_pydict(part)
        jb.row_offset = pb.row_offset = i * 8192
        assert_same_output(pwf.transform(pb), jwf.transform(jb).to_host())
    te = group_op(pwf, pops.TargetEncoding)
    kinds = {t: type(k.lookup_struct()).__name__ for t, k in te.overall_stats.items()}
    assert kinds == {"C5_C8": "TinyLookup", "C12_C16_C18": "CuckooLookup", "C15_C24": "CuckooLookup"}
    assert [cs.name for cs in pwf.output_schema] == [cs.name for cs in jwf.output_schema]


def test_fitted_state_round_trips_combo_and_multi_key_stats(tmp_path):
    """JAX fit → port → fitted_state → port: the combo tuples, the multi-key
    KeyedStats and the transform are unchanged."""

    def graph(ops, **kw):
        te = [["a", "b"]] >> ops.TargetEncoding("y", kfold=3, **kw)
        jg = [["a", "c"]] >> ops.JoinGroupby(cont_cols=["x"], stats=["count", "mean"], **kw)
        combo = [["a", "w"]] >> ops.Categorify(encode_type="combo", **kw)
        return te + jg + combo

    parts = [make_part(s) for s in range(2)]
    jwf = jnvt.Workflow(graph(jops, out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts]))
    first = pnvt.Workflow(graph(pops), device="cpu")
    pnvt.load_fitted_state(first, jax_state(jwf))
    state = pnvt.fitted_state(first)
    second = pnvt.Workflow(graph(pops), device="cpu")
    pnvt.load_fitted_state(second, state)
    again = pnvt.fitted_state(second)
    tuples = state["categorify"]["a_w"]["values_by_code"]
    assert tuples.dtype == np.int64 and tuples.shape[1] == 2
    np.testing.assert_array_equal(again["categorify"]["a_w"]["values_by_code"], tuples)
    for kind, tag in (("target_encoding", "a_b"), ("join_groupby", "a_c")):
        entry, back = state[kind][tag], again[kind][tag]
        for keyed in ("fold_stats", "overall_stats") if kind == "target_encoding" else (None,):
            e, b = (entry, back) if keyed is None else (entry[keyed], back[keyed])
            assert e["key_cols"] == b["key_cols"]
            for k in e["key_cols"]:
                np.testing.assert_array_equal(e["key_arrays"][k], b["key_arrays"][k])
            for name in e["stats"]:
                np.testing.assert_array_equal(e["stats"][name], b["stats"][name])
    pb = pnvt.TableBatch.from_pydict(make_part(5, shift=1))
    out1, out2 = first.transform(pb), second.transform(pb)
    for name in out1.column_names:
        torch.testing.assert_close(out1[name].values, out2[name].values, rtol=0, atol=0, equal_nan=True)
