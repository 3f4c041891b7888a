"""The session path against the JAX reference: Dataset.shuffle_by_keys,
Dropna → Filter → Groupby (host ops whose row counts change), ValueCount,
ListSlice, and K11c (``kernels.ragged_segment_reduce``) through its plain
version, on seeded numpy inputs. Integer outputs (partitions, group keys,
offsets, counts, row counts) are held bit for bit; floats as each test
states.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp
import nvtabular_tpu as jnvt
import nvtabular_tpu_torch as pnvt
from nvtabular_tpu import ops as jops
from nvtabular_tpu.dag.executor import FitEngine as JFitEngine
from nvtabular_tpu.dag.executor import JitExecutor
from nvtabular_tpu.dag.executor import LocalExecutor as JLocalExecutor
from nvtabular_tpu.kernels import ragged_segment_reduce as jax_segment_reduce
from nvtabular_tpu_torch import kernels as pkernels
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.kernels.ragged import ragged_segment_reduce_plain
from nvtabular_tpu_torch.ops.groupby import stable_order

ROWS, PARTS = 8192, 4
AGGS = {"movieId": ["list", "count"], "rating": ["list", "sum", "mean", "min", "max"],
        "ts_delta": ["first", "last"]}
NAMES = ["userId", "movieId_list", "movieId_count", "rating_list", "rating_sum", "rating_mean", "rating_min",
         "rating_max", "ts_delta_first", "ts_delta_last"]
# K11c's float32 sums against the reference's: relative to the row's float64 sum of |v|
SUM_TOL = 1e-6


def make_part(seed, n=ROWS):
    """chip_smoke's phase 25 partition at test size: zipf(1.2) users (one
    holds a fifth of the rows), ~1% of ts_delta NaN, and keys beyond int32."""
    r = np.random.default_rng(seed)
    ts = r.exponential(86400.0, n).astype(np.float32)
    ts[r.random(n) < 0.01] = np.nan
    users = r.zipf(1.2, n).clip(1, 3000).astype(np.int64)
    users[r.random(n) < 0.05] += 2**33  # the true high word routes these
    return {"userId": users, "movieId": r.zipf(1.1, n).clip(1, 9000).astype(np.int64),
            "rating": (r.integers(1, 11, n) / 2.0).astype(np.float32), "ts_delta": ts}


@pytest.fixture(scope="module")
def parts():
    return [make_part(s) for s in range(PARTS)]


def jax_dataset(parts):
    return jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts])


def port_dataset(parts):
    return pnvt.Dataset([pnvt.TableBatch.from_pydict(p) for p in parts])


def as_np(values):
    return values.numpy() if isinstance(values, torch.Tensor) else np.asarray(values)


def assert_same(got, want):
    """Names, dtypes, values (NaN for NaN) and offsets exact."""
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got[name], want[name]
        gv, wv = as_np(g.values), as_np(w.values)
        assert gv.dtype == wv.dtype, name
        np.testing.assert_array_equal(gv, wv, err_msg=name)
        assert (g.offsets is None) == (w.offsets is None), name
        if w.offsets is not None:
            np.testing.assert_array_equal(as_np(g.offsets), as_np(w.offsets), err_msg=name)


# --- shuffle_by_keys ----------------------------------------------------------------------------
@pytest.mark.parametrize("npartitions", [None, 7])
@pytest.mark.parametrize("keys", [["userId"], ["ts_delta"], ["userId", "movieId"]],
                         ids=["int64_key", "float_key", "two_keys"])
def test_shuffle_by_keys_matches_jax(parts, keys, npartitions):
    """Every partition holds the same rows in the same order as the
    reference's: h = h * 31 + hash_array(key, seed=17) in uint32, int64 keys
    by their true high word, float keys by their float64 bits (NaN and -0.0
    included), a stable sort of h % npartitions; empty partitions dropped."""
    parts = [dict(p) for p in parts]
    parts[0]["ts_delta"][:4] = [-0.0, 0.0, np.nan, 1e-40]
    want = list(jax_dataset(parts).shuffle_by_keys(keys, npartitions).to_batches())
    got = list(port_dataset(parts).shuffle_by_keys(keys, npartitions, device="cpu").to_batches())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w)


def test_shuffle_keeps_every_key_in_one_partition(parts):
    out = list(port_dataset(parts).shuffle_by_keys(["userId"], device="cpu").to_batches())
    users = [set(b["userId"].values.tolist()) for b in out]
    assert sum(len(u) for u in users) == len(set().union(*users))
    assert sum(b.num_rows for b in out) == PARTS * ROWS


def test_shuffle_past_memory_limit_raises_naming_item_1(parts):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 1:"):
        port_dataset(parts).shuffle_by_keys(["userId"], memory_limit=1024, device="cpu")


# --- Groupby --------------------------------------------------------------------------------------
def _groupby_part(seed, n=3000):
    """Keys with ties, sort keys with ties and NaN."""
    r = np.random.default_rng(seed)
    t = r.integers(0, 40, n).astype(np.float32)
    t[r.random(n) < 0.05] = np.nan
    x = r.normal(size=n).astype(np.float32)
    x[r.random(n) < 0.02] = np.nan
    return {"s": r.integers(0, 60, n).astype(np.int64), "s2": r.integers(0, 3, n).astype(np.int32), "t": t,
            "t2": r.integers(0, 4, n).astype(np.int64), "x": x, "y": r.integers(-5, 50, n).astype(np.int32)}


ALL_AGGS = ["count", "sum", "mean", "std", "var", "min", "max", "list", "first", "last"]


@pytest.mark.parametrize("executor", ["local", "jit"])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("groupby_cols, sort_cols", [("s", ["t"]), (["s", "s2"], ["t", "t2"]), ("s", None)],
                         ids=["one_key", "two_keys_two_sorts", "no_sort"])
def test_groupby_matches_jax(groupby_cols, sort_cols, ascending, executor):
    """Every aggregation: keys, offsets, lists, counts and AGG_DTYPES
    exact, floats bit-equal (the same float64 prefix sums). Descending sort
    columns keep ties in input order and NaN last, as pandas'
    sort_values(kind="stable") gives the reference."""
    data = [_groupby_part(s) for s in range(2)]

    def graph(ops):
        return ["s", "s2", "t", "t2", "x", "y"] >> ops.Groupby(groupby_cols, sort_cols=sort_cols, aggs=ALL_AGGS,
                                                              ascending=ascending)

    ex = JitExecutor(jit_min_rows=0) if executor == "jit" else JLocalExecutor()
    jwf = jnvt.Workflow(graph(jops))
    jwf.executor, jwf._fit_engine = ex, JFitEngine(ex)
    want = list(jwf.fit_transform(jax_dataset(data)).to_batches())
    pwf = pnvt.Workflow(graph(pops), device="cpu")
    got = list(pwf.fit_transform(port_dataset(data)).to_batches())
    assert [(c.name, c.dtype.name) for c in pwf.output_schema] == [(c.name, c.dtype.name) for c in jwf.output_schema]
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("seed", range(4))
def test_stable_order_matches_pandas(seed):
    """Keys ascending and sort columns descending, ties in input order, NaN
    last in every column."""
    d = _groupby_part(seed, 500)
    cols, asc = ["s", "t", "x"], [True, False, False]
    want = pd.DataFrame({c: d[c] for c in cols}).sort_values(cols, ascending=asc, kind="stable").index.to_numpy()
    np.testing.assert_array_equal(stable_order([d[c] for c in cols], asc), want)
    neg = {"u": np.array([3, 1, 3, 0, 1], np.uint32), "i": np.array([-(2**63), 5, 2**63 - 1, 5, 0], np.int64)}
    for name, col in neg.items():
        want = pd.DataFrame({name: col}).sort_values(name, ascending=False, kind="stable").index.to_numpy()
        np.testing.assert_array_equal(stable_order([col], [False]), want)


# --- rows that change in the executor -----------------------------------------------------------
def session_graph(ops, slice_len=20):
    g = (["userId", "movieId", "rating", "ts_delta"] >> ops.Dropna()
         >> ops.Filter(lambda b: np.asarray(b["rating"]) >= 3.0)
         >> ops.Groupby("userId", sort_cols=["ts_delta"], aggs=AGGS))
    vc = g[NAMES] >> ops.ValueCount()
    rest = [c for c in NAMES if c != "movieId_list"]
    return vc[rest] + (vc["movieId_list"] >> ops.ListSlice(-slice_len, pad=True))


def jax_session_graph(ops, slice_len=20):
    """The reference's Groupby, ValueCount and ListSlice over batches that
    Dropna and Filter have cut already (its composed graph cannot run them:
    ROADMAP.md queue 3)."""
    g = ["userId", "movieId", "rating", "ts_delta"] >> ops.Groupby("userId", sort_cols=["ts_delta"], aggs=AGGS)
    vc = g[NAMES] >> ops.ValueCount()
    rest = [c for c in NAMES if c != "movieId_list"]
    return vc[rest] + (vc["movieId_list"] >> ops.ListSlice(-slice_len, pad=True))


def jax_cut(dataset):
    """The reference's Dropna → Filter over each batch (LocalExecutor)."""
    ex = JLocalExecutor()
    wf = jnvt.Workflow(["userId", "movieId", "rating", "ts_delta"] >> jops.Dropna()
                       >> jops.Filter(lambda b: np.asarray(b["rating"].values) >= 3.0))
    wf.executor, wf._fit_engine = ex, JFitEngine(ex)
    return list(wf.fit_transform(dataset).to_batches())


def test_dropna_filter_then_groupby_reads_the_cut_rows(parts):
    """Groupby depends on its key and sort columns. After Dropna and Filter
    the root batch's copies of them have other rows, so the port takes them
    from the op's input; it equals the reference's Groupby over the cut
    batches."""
    shuffled_j = jax_dataset(parts).shuffle_by_keys(["userId"])
    cut = jax_cut(shuffled_j)
    jwf = jnvt.Workflow(jax_session_graph(jops))
    want = list(jwf.fit_transform(jnvt.Dataset(cut)).to_batches())
    pwf = pnvt.Workflow(session_graph(pops), device="cpu")
    got = list(pwf.fit_transform(port_dataset(parts).shuffle_by_keys(["userId"], device="cpu")).to_batches())
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    for g, w in zip(got, want):
        assert_same(g, w)


def test_a_dependency_lost_to_a_row_change_raises():
    graph = ["a"] >> pops.Filter(lambda b: np.asarray(b["a"]) > 1) >> pops.Groupby("k", aggs=["count"])
    batch = pnvt.TableBatch.from_pydict({"a": np.arange(5, dtype=np.int64), "k": np.zeros(5, dtype=np.int64)})
    with pytest.raises(ValueError, match="changed the row count"):
        pnvt.Workflow(graph, device="cpu").transform(batch)


# --- K11c's plain version against jax -----------------------------------------------------------
SEGMENT_CASES = ["plain", "nan", "signed_zeros", "tail_values", "offset_start"]


def _segment_case(name):
    r = np.random.default_rng(70 + SEGMENT_CASES.index(name))
    lengths = r.integers(0, 9, 300)
    lengths[[0, 7, 299]] = 0  # empty rows, the last one too
    lengths[150] = 4000  # one row holds most values
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    values = r.normal(size=int(offsets[-1])).astype(np.float32)
    if name == "nan":
        values[r.random(len(values)) < 0.01] = np.nan
    if name == "signed_zeros":
        values[::3] = -0.0
        values[1::3] = 0.0
    if name == "tail_values":
        values = np.concatenate([values, r.normal(size=50).astype(np.float32)])  # past offsets[-1]
    if name == "offset_start":
        offsets = offsets + 5  # values before offsets[0] belong to row 0
        values = np.concatenate([r.normal(size=5).astype(np.float32), values])
    return values, offsets


@pytest.mark.parametrize("rows_delta", [0, 1, -2], ids=["R", "R+1", "R-2"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "min", "max"])
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_ragged_segment_reduce_plain_matches_jax(case, combiner, rows_delta):
    """min and max bit for bit (+inf / -inf for an empty row, NaN propagated
    as XLA does, -0.0 the min and 0.0 the max of signed zeros); sum and mean
    within 1e-6 of the row's float64 sum (mean) of |v|; num_rows other than
    len(offsets) - 1 drops rows or gives the values past offsets[-1] a row;
    a mean then raises, as the reference's shapes do."""
    values, offsets = _segment_case(case)
    num_rows = len(offsets) - 1 + rows_delta
    pv, po = torch.from_numpy(values), torch.from_numpy(offsets)
    if combiner == "mean" and rows_delta:
        with pytest.raises(TypeError):
            jax_segment_reduce(jnp.asarray(values), jnp.asarray(offsets), num_rows, combiner)
        with pytest.raises(ValueError, match="num_rows"):
            pkernels.ragged_segment_reduce(pv, po, num_rows, combiner)
        return
    want = np.asarray(jax_segment_reduce(jnp.asarray(values), jnp.asarray(offsets), num_rows, combiner))
    got = pkernels.ragged_segment_reduce(pv, po, num_rows, combiner).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if combiner in ("min", "max"):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
        return
    scale = ragged_segment_reduce_plain(pv.abs(), po, num_rows, combiner).double().numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert (np.abs(got.astype(np.float64) - want)[~nan] <= SUM_TOL * scale[~nan] + 1e-7).all()


def test_ragged_segment_reduce_checks_its_arguments():
    v, off = torch.ones(4), torch.tensor([0, 2, 4])
    with pytest.raises(TypeError):
        pkernels.ragged_segment_reduce(v.double(), off, 2)
    with pytest.raises(ValueError, match="combiner"):
        pkernels.ragged_segment_reduce(v, off, 2, "median")
    with pytest.raises(ValueError, match="num_rows"):
        pkernels.ragged_segment_reduce(v, off, -1)


# --- phase 25's workflow at 4 × 8,192 rows, end to end -------------------------------------------------
@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
def test_phase25_workflow_matches_jax(parts, fitted_by):
    """shuffle → Dropna → Filter → Groupby → ValueCount → ListSlice(-20,
    pad=True): keys, offsets, lists, counts, row counts and the schema's
    value counts exact, floats bit-equal; fitted by the port or with the
    reference's ValueCount stats carried over by convert. Then K11c over
    each partition's rating lists: min and max equal Groupby's own columns,
    sum and mean within 1e-6 of the rows' |v|."""
    cut = jax_cut(jax_dataset(parts).shuffle_by_keys(["userId"]))
    jwf = jnvt.Workflow(jax_session_graph(jops))
    jwf.fit(jnvt.Dataset(cut))
    want = list(jwf.transform(jnvt.Dataset(cut)).to_batches())
    pwf = pnvt.Workflow(session_graph(pops), device="cpu")
    shuffled = port_dataset(parts).shuffle_by_keys(["userId"], device="cpu")
    if fitted_by == "port":
        pwf.fit(shuffled)
    else:
        vc = next(n.op for n in jwf.graph.nodes if isinstance(n.op, jops.ValueCount))
        pnvt.load_fitted_state(pwf, {"value_count": vc.stats})
    got = list(pwf.transform(shuffled).to_batches())
    assert pwf.output_schema["movieId_list"].properties == jwf.output_schema["movieId_list"].properties
    assert pwf.output_schema["rating_list"].properties["value_count"] == \
        jwf.output_schema["rating_list"].properties["value_count"]
    for g, w in zip(got, want):
        assert_same(g, w)
        lists = g["rating_list"]
        for c in ("sum", "mean", "min", "max"):
            red = pkernels.ragged_segment_reduce(lists.values, lists.offsets, len(lists), c)
            ref = g[f"rating_{c}"].values
            if c in ("min", "max"):
                assert torch.equal(red, ref)
            else:
                scale = ragged_segment_reduce_plain(lists.values.abs(), lists.offsets, len(lists), c).double()
                assert bool(((red.double() - ref.double()).abs() <= SUM_TOL * scale + 1e-7).all())
