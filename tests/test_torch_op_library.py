"""The rest of the op library against the JAX reference.

Every public name of the JAX package is in the port or raises naming its
ROADMAP item. The new ops (FillMedian, NormalizeMinMax, the ``_filled``
columns and ``out_dtype``, ReduceDtypeSize, Rename, the AddMetadata family,
DropLowCardinality, ValueCount, DataStats, Dropna, Filter, JoinExternal,
ColumnSimilarity) run on the CPU (``device="cpu"``: the continuous chains
through K5's plain version) on the same seeded numpy inputs as the
reference's ``JitExecutor(jit_min_rows=0)`` and ``LocalExecutor``; fitted
by the port and with the reference's fit carried over by ``convert``. Each
test states its tolerance.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

import nvtabular_tpu as jnvt
import nvtabular_tpu_torch as pnvt
from nvtabular_tpu import ops as jops
from nvtabular_tpu.dag.executor import FitEngine as JFitEngine
from nvtabular_tpu.dag.executor import JitExecutor
from nvtabular_tpu.dag.executor import LocalExecutor as JLocalExecutor
from nvtabular_tpu.ops.moments import ReservoirSample as JReservoir
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.dag.device_fuse import extract_chain
from nvtabular_tpu_torch.kernels import cont_chain as kcc
from nvtabular_tpu_torch.ops.moments import ReservoirSample as PReservoir
from nvtabular_tpu_torch.ops.normalize import affine, round_to
from torch_groups import fill_median_worker, run_group

ROWS, PARTS = 8192, 4
CONTS = ["I0", "I1", "I2"]
SMALL = ["C0", "C1", "C2", "C3"]
# log1p differs by a few float32 ULPs between XLA's, numpy's and PyTorch's CPU versions
CONT_TOL = dict(rtol=1e-5, atol=1e-5)
F16_ULP = {"float16": 2.0**-10, "bfloat16": 2.0**-7}


def make_part(seed, n=ROWS):
    """3 floats with ~5% NaN (the last one constant: a zero span), 4 small
    categoricals of 3-1,500 values, an int64 key beyond int32."""
    r = np.random.default_rng(seed)
    d = {}
    for name in CONTS:
        x = (r.normal(1.0, 3.0, n) * 1.7).astype(np.float32)
        x[r.random(n) < 0.05] = np.nan
        d[name] = x
    d["I2"][~np.isnan(d["I2"])] = 2.5
    for name, card in zip(SMALL, [3, 60, 1500, 4]):
        d[name] = ((r.integers(0, card, n) * 2654435761) % 2**31).astype(np.int32)
    d["big"] = r.integers(-(2**40), 2**40, n).astype(np.int64)
    d["label"] = r.integers(0, 2, n).astype(np.int32)
    return d


@pytest.fixture(scope="module")
def parts():
    return [make_part(s) for s in range(PARTS)]


def jax_batches(parts):
    return [jnvt.TableBatch.from_pydict(p) for p in parts]


def jax_run(graph, parts, executor="jit"):
    """The JAX workflow fitted and transformed under ``executor``."""
    ex = JitExecutor(jit_min_rows=0) if executor == "jit" else JLocalExecutor()
    wf = jnvt.Workflow(graph)
    wf.executor, wf._fit_engine = ex, JFitEngine(ex)
    wf.fit(jnvt.Dataset(jax_batches(parts)))
    return wf, list(wf.transform(jnvt.Dataset(jax_batches(parts))).to_batches())


def jax_state(wf):
    """The JAX workflow's fitted state in convert's format."""
    state = {"categorify": {}, "fill_median": {}, "normalize_minmax": {}, "reduce_dtype_size": {},
             "value_count": {}, "data_stats": {}, "normalize": {}}
    for node in wf.graph.nodes:
        op = node.op
        if isinstance(op, jops.Categorify):
            for key, v in op.vocabs.items():
                state["categorify"][key] = {"values_by_code": np.asarray(v.values_by_code),
                                            "num_buckets": v.num_buckets, "offset": v.offset}
        elif isinstance(op, jops.FillMedian):
            state["fill_median"].update(op.medians)
        elif isinstance(op, jops.NormalizeMinMax):
            state["normalize_minmax"].update({n: {"min": op.mins[n], "max": op.maxs[n]} for n in op.mins})
        elif isinstance(op, jops.Normalize):
            state["normalize"].update({n: {"mean": op.means[n], "std": op.stds[n]} for n in op.means})
        elif isinstance(op, jops.ReduceDtypeSize):
            state["reduce_dtype_size"].update(
                {n: {"range": list(op.ranges[n]), "dtype": str(op._dtypes[n])} for n in op._dtypes})
        elif isinstance(op, jops.ValueCount):
            state["value_count"].update(op.stats)
        elif isinstance(op, jops.DataStats):
            state["data_stats"].update(op.output)
    return state


def port_run(graph, parts, jwf=None):
    """The port's workflow on the CPU, fitted by the port or (``jwf``) with
    the JAX fit carried over; its transformed batches."""
    wf = pnvt.Workflow(graph, device="cpu")
    if jwf is None:
        wf.fit(pnvt.Dataset([pnvt.TableBatch.from_pydict(p) for p in parts]))
    else:
        pnvt.load_fitted_state(wf, jax_state(jwf))
    return wf, list(wf.transform(pnvt.Dataset([pnvt.TableBatch.from_pydict(p) for p in parts])).to_batches())


def as_numpy(values):
    if isinstance(values, torch.Tensor):
        return values.float().numpy() if values.dtype == torch.bfloat16 else values.numpy()
    arr = np.asarray(values)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def assert_same(got, want, conts=(), ulp=None):
    """Port batch against JAX batch: names, dtypes, offsets and non-float
    columns exact; ``conts`` within CONT_TOL, or within ``ulp`` relative
    (16-bit stores); other floats bit-equal (NaN for NaN)."""
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = got[name], want[name]
        assert g.dtype.name == jnvt.dtypes.normalize(np.asarray(w.values).dtype).name, name
        gv, wv = as_numpy(g.values), as_numpy(w.values)
        if name in conts and ulp is not None:
            np.testing.assert_allclose(gv.astype(np.float64), wv.astype(np.float64), rtol=ulp, atol=2.0**-24,
                                       err_msg=name)
        elif name in conts:
            np.testing.assert_allclose(gv, wv, **CONT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=name)
        assert (g.offsets is None) == (w.offsets is None), name
        if w.offsets is not None:
            np.testing.assert_array_equal(g.offsets.numpy(), np.asarray(w.offsets), err_msg=name)


# --- the reference's public names -----------------------------------------------------------
JAX_MODULES = ["", ".dag", ".ops", ".ops.operator", ".ops.stat_operator", ".kernels", ".parallel", ".models",
               ".framework_utils", ".serving", ".tools", ".workflow", ".io", ".loader"]


@pytest.mark.parametrize("module", JAX_MODULES, ids=[m.lstrip(".") or "top" for m in JAX_MODULES])
def test_every_jax_public_name_is_ported_or_names_its_item(module):
    """Each name of each ``__all__`` of the JAX package is an attribute of
    the port's module of the same path, or raises NotImplementedError
    naming its ROADMAP.md item."""
    jmod = importlib.import_module("nvtabular_tpu" + module)
    pmod = importlib.import_module("nvtabular_tpu_torch" + module)
    for name in jmod.__all__:
        try:
            getattr(pmod, name)
        except NotImplementedError as e:
            assert "ROADMAP.md queue 1 item " in str(e), (module, name, str(e))


def test_ops_init_exports_every_jax_op():
    assert sorted(pops.__all__) == sorted(jops.__all__)


# --- table.py: take, filter, concat_rows ------------------------------------------------------
def _lists_table(mod, seed):
    r = np.random.default_rng(seed)
    lengths = r.integers(0, 4, 50)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    data = {"x": r.normal(size=50).astype(np.float32), "k": r.integers(0, 9, 50).astype(np.int64)}
    b = mod.TableBatch.from_pydict(data)
    b["l"] = mod.Column(r.integers(0, 99, int(offsets[-1])).astype(np.int64), offsets)
    b["v"] = mod.Column(data["x"], None, r.random(50) > 0.3)
    return b


def test_take_filter_concat_rows_match_jax():
    """Rows, list offsets and validity exact (table.py:140, 356, 370, 596)."""
    from nvtabular_tpu.table import concat_rows as jconcat
    from nvtabular_tpu_torch.table import concat_rows as pconcat

    idx = np.array([5, 0, 49, 5, 17], dtype=np.int64)
    mask = np.random.default_rng(3).random(50) > 0.5
    for jb_, pb_ in [(_lists_table(jnvt, s), _lists_table(pnvt, s)) for s in (1, 2)]:
        assert_same(pb_.take(idx), jb_.take(idx))
        assert_same(pb_.filter(mask), jb_.filter(mask))
        for name in ("v",):
            np.testing.assert_array_equal(pb_.filter(mask)[name].validity.numpy(),
                                          np.asarray(jb_.filter(mask)[name].validity))
    j = [_lists_table(jnvt, s).take(np.arange(s * 5)) for s in (1, 0, 3)]
    p = [_lists_table(pnvt, s).take(np.arange(s * 5)) for s in (1, 0, 3)]
    assert_same(pconcat(p), jconcat(j))
    np.testing.assert_array_equal(pconcat(p)["v"].validity.numpy(), np.asarray(jconcat(j)["v"].validity))


# --- FillMedian: the reservoir sample, one process and several ---------------------------------
@pytest.mark.parametrize("capacity", [131072, 1000])
def test_reservoir_sample_matches_jax_draw_for_draw(capacity):
    """Buffers equal element for element after updates past capacity and
    after a merge; medians exactly equal."""
    r = np.random.default_rng(9)
    chunks = [r.normal(size=n) for n in (700, 50_000, 90_000, 3, 120_000)]
    chunks[1][::7] = np.nan
    j, p = JReservoir(capacity), PReservoir(capacity)
    j2, p2 = JReservoir(capacity), PReservoir(capacity)
    for i, c in enumerate(chunks):
        (j if i % 2 else j2).update(c)
        (p if i % 2 else p2).update(c)
    np.testing.assert_array_equal(p.buf, j.buf)
    jm, pm = j.merge(j2), p.merge(p2)
    np.testing.assert_array_equal(pm.buf, jm.buf)
    assert pm.seen == jm.seen and pm.quantile(0.5) == jm.quantile(0.5)


def _median_parts():
    """4 × 50,000 rows: more values than the reservoir holds, one process or two."""
    return [{k: v for k, v in make_part(100 + s, 50_000).items() if k in CONTS} for s in range(4)]


def _jax_medians(parts, world):
    """The reference's FillMedian fit on ``world`` round-robin shards of the
    partitions, merged as its multi-process FitEngine merges them."""
    op = jops.FillMedian()
    sel = jnvt.ColumnSelector(CONTS)
    states = []
    for rank in range(world):
        state = op.fit_init(sel, None)
        for p in parts[rank::world]:
            state = op.fit_batch(sel, jnvt.TableBatch.from_pydict(p), state)
        states.append(state)
    op.fit_finalize(op.fit_merge(states))
    return op.medians


def test_fill_median_medians_equal_jax_one_process():
    parts = _median_parts()
    wf = pnvt.Workflow(CONTS >> pops.FillMedian(), device="cpu")
    wf.fit(pnvt.Dataset(parts))
    got = next(n.op for n in wf.graph.nodes if isinstance(n.op, pops.FillMedian)).medians
    jwf, _ = jax_run(CONTS >> jops.FillMedian(), parts, "local")
    assert got == next(n.op for n in jwf.graph.nodes if isinstance(n.op, jops.FillMedian)).medians
    assert got == _jax_medians(parts, 1)


def test_fill_median_medians_equal_jax_across_processes(tmp_path):
    """Two ranks of the multi-process FitEngine (gloo): every rank's medians
    equal the reference's merge of the two shards' samples, exactly."""
    parts = _median_parts()
    got = run_group(fill_median_worker, 2, tmp_path, parts, CONTS)
    want = _jax_medians(parts, 2)
    assert got[0] == got[1] == want


# --- fills, normalizations and K5's new modes against the reference ----------------------------
def chain(ops, fill="median", norm="minmax", out_dtype=None, log=True, binary=False):
    node = CONTS >> (ops.FillMedian(add_binary_cols=binary) if fill == "median"
                     else ops.FillMissing(0.5, add_binary_cols=binary))
    node = node >> ops.Clip(min_value=0.0)
    if log:
        node = node >> ops.LogOp()
    return node >> (ops.NormalizeMinMax(out_dtype=out_dtype) if norm == "minmax" else ops.Normalize(out_dtype=out_dtype))


@pytest.mark.parametrize("executor", ["local", "jit"])
@pytest.mark.parametrize("out_dtype", [None, "float16", "bfloat16", "float64"])
@pytest.mark.parametrize("norm", ["minmax", "zscore"])
def test_chain_out_dtypes_match_jax(parts, norm, out_dtype, executor):
    """Without log1p the port equals the reference's LocalExecutor bit for
    bit in float32, float16 and bfloat16 (casts first, per-operation
    rounding, the span taken in float64), and in float64 where the
    constants are the data's own (min-max); a float64 z-score within
    rtol=1e-12 (the mean's float64 sums in another order). XLA rewrites a
    division by a constant as a product with its rounded reciprocal, so
    JitExecutor's float32 and float16 are held within the store type's
    relative spacing (2^-23, 2^-10: one to two ULPs; a recorded
    difference); its bfloat16 is bit-equal; its float64 is
    computed in float32 (x64 is off), within rtol=1e-6 of the port's."""
    jwf, want = jax_run(chain(jops, norm=norm, out_dtype=out_dtype, log=False), parts, executor)
    _, got = port_run(chain(pops, norm=norm, out_dtype=out_dtype, log=False), parts)
    for g, w in zip(got, want):
        if executor == "jit" and out_dtype == "float64":
            for c in CONTS:  # computed in float32, then cast back to the schema's float64
                assert g[c].values.dtype == torch.float64 and np.asarray(w[c].values).dtype == np.float64
                np.testing.assert_allclose(g[c].values.numpy(), np.asarray(w[c].values), rtol=1e-6, atol=1e-7)
        elif executor == "jit" and out_dtype in (None, "float16"):
            assert_same(g, w, conts=CONTS, ulp=2.0**-23 if out_dtype is None else F16_ULP["float16"])
        elif out_dtype == "float64" and norm == "zscore":
            for c in CONTS:
                np.testing.assert_allclose(g[c].values.numpy(), np.asarray(w[c].values), rtol=1e-12, atol=1e-12)
        else:
            assert_same(g, w)


@pytest.mark.parametrize("out_dtype", [None, "float16", "bfloat16"])
@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
def test_chain_with_log1p_matches_jax(parts, out_dtype, fitted_by):
    """With log1p: float32 within CONT_TOL, 16-bit within the store type's
    relative spacing (2^-10 or 2^-7: one to two ULPs; log1p's float32 ULPs
    can cross a 16-bit rounding edge)."""
    jwf, want = jax_run(chain(jops, out_dtype=out_dtype), parts, "local")
    _, got = port_run(chain(pops, out_dtype=out_dtype), parts, jwf if fitted_by == "jax_state" else None)
    for g, w in zip(got, want):
        assert_same(g, w, conts=CONTS, ulp=F16_ULP.get(out_dtype))


def test_minmax_span_is_a_float64_difference():
    """span = hi - lo in float64, cast once (normalize.py:141): not the
    difference of the 16-bit lo and hi. With lo = 1.0004 and hi = 1.0009 in
    float16 the two differ; the port's constants are the reference's."""
    lo, hi = 1.0004, 1.0009
    assert round_to(hi - lo, "float16") != float(np.float16(hi) - np.float16(lo))
    x = torch.tensor([1.0004, 1.0006, 1.0009], dtype=torch.float32)
    want = (x.numpy().astype(np.float16) - np.float16(lo)) / np.asarray(hi - lo).astype(np.float16)
    np.testing.assert_array_equal(affine(x, lo, hi - lo, "float16").numpy(), want)


def test_zero_span_gives_zeros_nan_included():
    data = {"a": np.array([3.0, np.nan, 3.0], np.float32)}
    for out_dtype in (None, "float16"):
        wf = pnvt.Workflow(["a"] >> pops.NormalizeMinMax(out_dtype=out_dtype), device="cpu")
        out = list(wf.fit_transform(pnvt.Dataset(data)).to_batches())[0]["a"].values
        assert out.float().tolist() == [0.0, 0.0, 0.0]
        jwf, jout = jax_run(["a"] >> jops.NormalizeMinMax(out_dtype=out_dtype), [data], "local")
        assert np.asarray(jout[0]["a"].values).astype(np.float32).tolist() == [0.0, 0.0, 0.0]


def test_span_above_zero_keeps_nan():
    wf = pnvt.Workflow(["a"] >> pops.NormalizeMinMax(), device="cpu")
    out = list(wf.fit_transform(pnvt.Dataset({"a": np.array([1.0, np.nan, 3.0], np.float32)})).to_batches())
    assert np.isnan(out[0]["a"].values.numpy()).tolist() == [False, True, False]


def test_float64_out_dtype_runs_outside_k5(parts):
    """out_dtype="float64" keeps float64 with the host path's values and is
    no fused chain (the chain stops at LogOp)."""
    wf, got = port_run(chain(pops, out_dtype="float64"), parts)
    norm = next(n for n in wf.graph.nodes if isinstance(n.op, pops.NormalizeMinMax))
    assert extract_chain(norm) is None and extract_chain(norm.parents[0]) is not None
    _, want = jax_run(chain(jops, out_dtype="float64"), parts, "local")
    for g, w in zip(got, want):
        assert_same(g, w, conts=CONTS)


@pytest.mark.parametrize("fill", ["median", "missing"])
@pytest.mark.parametrize("executor", ["local", "jit"])
def test_binary_cols_match_jax(parts, fill, executor):
    """A fill that ends its branch adds ``c_filled`` (bool) after each ``c``;
    K5's mask chain of the one fill stage; exact."""
    def graph(ops):
        return (CONTS >> (ops.FillMedian(add_binary_cols=True) if fill == "median"
                          else ops.FillMissing(0.5, add_binary_cols=True))) + ["label"]

    _, want = jax_run(graph(jops), parts, executor)
    wf, got = port_run(graph(pops), parts)
    node = next(n for n in wf.graph.nodes if "Fill" in type(n.op).__name__)
    spec = extract_chain(node)
    assert spec is not None and spec.mask
    assert got[0].column_names == ["I0", "I0_filled", "I1", "I1_filled", "I2", "I2_filled", "label"]
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("executor", ["local", "jit"])
def test_binary_cols_of_a_fill_inside_a_chain_never_reach_the_output(parts, executor):
    """The reference passes no ``_filled`` column on from a fill that is not
    the last op of its branch (the next op selects the filled columns only)."""
    _, want = jax_run(chain(jops, binary=True), parts, executor)
    _, got = port_run(chain(pops, binary=True), parts)
    assert got[0].column_names == want[0].column_names == CONTS
    for g, w in zip(got, want):
        assert_same(g, w, conts=CONTS)


@pytest.mark.parametrize("store", [torch.float16, torch.bfloat16])
def test_cont_chain_plain_16bit_equals_the_op_path(store):
    """K5's plain version in its 16-bit mode equals the ops' own transform
    (``normalize.affine``), and its mask mode the inputs' null mask."""
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.normal(0, 30, (3, 5000)).astype(np.float32))
    x[:, :3] = torch.tensor([65504.0, 1e-8, float("nan")])
    name = "float16" if store == torch.float16 else "bfloat16"
    consts = [(0.37, 2.9), (-1.1, 0.013), (5.0, 1.0)]
    params = torch.tensor([[0.0, 0.0, 0.0, round_to(s, name), round_to(d, name)] for s, d in consts])
    flags = torch.tensor([kcc.NORM, kcc.NORM, kcc.ZERO], dtype=torch.int32)
    got = kcc.cont_chain(x, None, params, flags, store)
    for i, (s, d) in enumerate(consts):
        want = affine(x[i], s, d, name, zero=i == 2)
        assert torch.equal(got[i].isnan(), want.isnan()) and torch.equal(got[i].nan_to_num(), want.nan_to_num())
    y, mask = kcc.cont_chain(x, None, params, torch.full((3,), kcc.FILL, dtype=torch.int32), with_mask=True)
    assert torch.equal(mask, x.isnan()) and not bool(y.isnan().any())


# --- the schema ops ---------------------------------------------------------------------------
def small_graph(ops, min_cardinality=4):
    """Phase 24a's small categoricals. A DropLowCardinality that drops a
    column fails the ops after it in the reference (their selectors still
    name it: ROADMAP.md queue 3), so where it drops one it comes last."""
    cats = SMALL >> ops.Categorify()
    if min_cardinality > 4:
        return cats >> ops.ReduceDtypeSize() >> ops.AddTags(["criteo_small"]) >> ops.DropLowCardinality(
            min_cardinality=min_cardinality)
    return (cats >> ops.DropLowCardinality(min_cardinality=min_cardinality) >> ops.ReduceDtypeSize()
            >> ops.AddTags(["criteo_small"]))


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
@pytest.mark.parametrize("min_cardinality", [4, 7])
def test_small_categoricals_match_jax(parts, min_cardinality, fitted_by):
    """Codes, the columns DropLowCardinality keeps (C0's 3 values and 3
    reserved codes give a domain max of 5: dropped at 7) and
    ReduceDtypeSize's dtypes exact; the tag in the output schema."""
    jwf, want = jax_run(small_graph(jops, min_cardinality), parts)
    pwf, got = port_run(small_graph(pops, min_cardinality), parts, jwf if fitted_by == "jax_state" else None)
    assert [c.name for c in pwf.output_schema] == [c.name for c in jwf.output_schema]
    assert {c.name: c.dtype.name for c in pwf.output_schema} == {c.name: c.dtype.name for c in jwf.output_schema}
    assert all("criteo_small" in c.tags for c in pwf.output_schema)
    assert ("C0" in pwf.output_schema.column_names) == (min_cardinality <= 5)
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("float_dtype", [np.float32, np.float16])
def test_reduce_dtype_size_ladder_matches_jax(float_dtype):
    r = np.random.default_rng(5)
    data = {"i8": r.integers(-128, 128, 500).astype(np.int64), "i16": r.integers(-200, 30000, 500).astype(np.int32),
            "i32": r.integers(-(2**20), 2**20, 500).astype(np.int64), "i64": r.integers(-(2**40), 2**40, 500),
            "f": r.normal(size=500).astype(np.float64)}
    jwf, want = jax_run(list(data) >> jops.ReduceDtypeSize(float_dtype), [data], "local")
    pwf, got = port_run(list(data) >> pops.ReduceDtypeSize(float_dtype), [data])
    assert [g.dtype.name for g in got[0].columns.values()] == ["int8", "int16", "int32", "int64", np.dtype(float_dtype).name]
    assert_same(got[0], want[0])
    pop = next(n.op for n in pwf.graph.nodes if isinstance(n.op, pops.ReduceDtypeSize))
    jop = next(n.op for n in jwf.graph.nodes if isinstance(n.op, jops.ReduceDtypeSize))
    assert pop.ranges == jop.ranges and pop._dtypes == jop._dtypes


@pytest.mark.parametrize("kwargs", [{"postfix": "_r"}, {"f": str.upper}, {"name": "renamed"}],
                         ids=["postfix", "f", "name"])
def test_rename_matches_jax(parts, kwargs):
    cols = ["I0"] if "name" in kwargs else CONTS
    _, want = jax_run(cols >> jops.Rename(**kwargs), parts[:1], "local")
    _, got = port_run(cols >> pops.Rename(**kwargs), parts[:1])
    assert_same(got[0], want[0])
    with pytest.raises(ValueError):
        pops.Rename()


@pytest.mark.parametrize("op", ["AddMetadata", "AddTags", "AddProperties", "TagAsUserID", "TagAsItemID",
                                "TagAsUserFeatures", "TagAsItemFeatures"])
def test_metadata_ops_match_jax_schema(parts, op):
    kwargs = {"AddMetadata": {"tags": ["x"], "properties": {"p": 1}}, "AddTags": {"tags": ["y"]},
              "AddProperties": {"properties": {"q": 2}}}.get(op, {})
    jwf, want = jax_run(["C0", "C1"] >> getattr(jops, op)(**kwargs), parts[:1], "local")
    pwf, got = port_run(["C0", "C1"] >> getattr(pops, op)(**kwargs), parts[:1])
    assert_same(got[0], want[0])
    for pc, jc in zip(pwf.output_schema, jwf.output_schema):
        assert sorted(map(str, pc.tags)) == sorted(map(str, jc.tags))
        assert pc.properties == jc.properties


# --- fit-only stat ops --------------------------------------------------------------------------
def _list_parts():
    out = []
    for s in range(3):
        r = np.random.default_rng(60 + s)
        lengths = r.integers(0 if s else 2, 7, 300)
        offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
        x = r.normal(size=300).astype(np.float32)
        x[r.random(300) < 0.1] = np.nan
        out.append({"mh": (r.integers(0, 50, int(offsets[-1])).astype(np.int64), offsets), "x": x,
                    "k": r.integers(0, 40, 300).astype(np.int32)})
    return out


def _tables(mod, parts):
    return [mod.TableBatch({k: mod.Column(*v) if isinstance(v, tuple) else mod.Column(v) for k, v in p.items()})
            for p in parts]


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
def test_value_count_matches_jax(fitted_by):
    parts = _list_parts()
    jwf = jnvt.Workflow(["mh", "x"] >> jops.ValueCount())
    jwf.fit(jnvt.Dataset(_tables(jnvt, parts)))
    pwf = pnvt.Workflow(["mh", "x"] >> pops.ValueCount(), device="cpu")
    if fitted_by == "port":
        pwf.fit(pnvt.Dataset(_tables(pnvt, parts)))
    else:
        pnvt.load_fitted_state(pwf, jax_state(jwf))
        pwf.transform(_tables(pnvt, parts)[0])  # builds the schema
    pop = next(n.op for n in pwf.graph.nodes if isinstance(n.op, pops.ValueCount))
    jop = next(n.op for n in jwf.graph.nodes if isinstance(n.op, jops.ValueCount))
    assert pop.stats == jop.stats == {"mh": {"min": 0, "max": 6}}
    assert pwf.output_schema["mh"].properties["value_count"] == jwf.output_schema["mh"].properties["value_count"]
    assert pwf.output_schema["mh"].shape.as_tuple() == jwf.output_schema["mh"].shape.as_tuple()


def test_data_stats_match_jax():
    """Cardinality (distinct float64-bit hashes, as the host path hashes),
    null share, min and max exact; mean and std within rtol=1e-12 (float64
    sums in another order); list mean length exact."""
    parts = _list_parts()
    jwf = jnvt.Workflow(["mh", "x", "k"] >> jops.DataStats())
    jwf.fit(jnvt.Dataset(_tables(jnvt, parts)))
    pwf = pnvt.Workflow(["mh", "x", "k"] >> pops.DataStats(), device="cpu")
    pwf.fit(pnvt.Dataset(_tables(pnvt, parts)))
    got = next(n.op for n in pwf.graph.nodes if isinstance(n.op, pops.DataStats)).output
    want = next(n.op for n in jwf.graph.nodes if isinstance(n.op, jops.DataStats)).output
    assert sorted(got) == sorted(want)
    for col in want:
        assert sorted(got[col]) == sorted(want[col]), col
        for key, w in want[col].items():
            if key in ("mean", "std"):
                np.testing.assert_allclose(got[col][key], w, rtol=1e-12, err_msg=f"{col} {key}")
            else:
                assert got[col][key] == w, (col, key)


# --- row-changing host ops ------------------------------------------------------------------------
def _null_part(seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=2000).astype(np.float32)
    x[r.random(2000) < 0.1] = np.nan
    return {"x": x, "y": r.integers(0, 10, 2000).astype(np.int64), "z": r.normal(size=2000).astype(np.float32)}


@pytest.mark.parametrize("executor", ["local", "jit"])
def test_dropna_and_filter_match_jax(executor):
    """Rows kept, in order, exact; the row count changes batch by batch."""
    parts = [_null_part(s) for s in range(3)]

    def graph(ops):
        return ["x", "y", "z"] >> ops.Dropna() >> ops.Filter(lambda b: np.asarray(b["y"]) % 3 != 0)

    _, want = jax_run(graph(jops), parts, executor)
    _, got = port_run(graph(pops), parts)
    for g, w in zip(got, want):
        assert g.num_rows < 2000
        assert_same(g, w)


def test_filter_takes_masks_columns_and_batches():
    data = {"a": np.arange(10, dtype=np.int64), "b": np.arange(10, dtype=np.float32)}
    for f in (lambda b: b["a"].values > 4, lambda b: pnvt.Column(np.asarray(b["a"]) > 4),
              lambda b: b.filter(np.asarray(b["a"]) > 4)):
        out = pnvt.Workflow(["a", "b"] >> pops.Filter(f), device="cpu").transform(pnvt.TableBatch.from_pydict(data))
        assert out["a"].values.tolist() == [5, 6, 7, 8, 9]
    with pytest.raises(ValueError, match="boolean"):
        pnvt.Workflow(["a"] >> pops.Filter(lambda b: np.asarray(b["a"])), device="cpu").transform(
            pnvt.TableBatch.from_pydict(data))


def test_dropna_reads_validity():
    batch = pnvt.TableBatch({"a": pnvt.Column(np.arange(5, dtype=np.int32), None, np.array([1, 0, 1, 1, 0], bool))})
    out = pnvt.Workflow(["a"] >> pops.Dropna(), device="cpu").transform(batch)
    assert out["a"].values.tolist() == [0, 2, 3]


def test_row_offset_after_a_row_change_follows_jax():
    """A row-changing op keeps the row offset it carries (the root's, through
    take); the executor sets the root's only where the row count is the
    root's (executor.py:89)."""
    from nvtabular_tpu_torch.dag.executor import LocalExecutor

    batch = pnvt.TableBatch.from_pydict(_null_part(1))
    batch.row_offset = 4096
    wf = pnvt.Workflow(["x", "y"] >> pops.Dropna(), device="cpu")
    wf.fit(pnvt.Dataset([batch]))
    out = LocalExecutor().transform_batch(batch, wf.graph.output_node)
    assert out.num_rows < batch.num_rows and out.row_offset == 4096


# --- JoinExternal and ColumnSimilarity -----------------------------------------------------------
def _ext():
    return {"key": np.array([3, 1, 3, 7, 1, 9], dtype=np.int64), "key2": np.array([0, 0, 1, 0, 0, 0], np.int64),
            "val": np.array([10.0, 11.0, 12.0, 13.0, 14.0, 15.0], np.float32)}


@pytest.mark.parametrize("how", ["left", "inner"])
@pytest.mark.parametrize("drop_duplicates_ext", [False, True])
@pytest.mark.parametrize("on", ["key", ["key", "key2"]], ids=["one_key", "two_keys"])
def test_join_external_matches_jax(how, drop_duplicates_ext, on):
    """The first occurrence of a duplicate external key wins, as with
    pyarrow's index_in; left joins mark misses invalid. Exact."""
    data = {"key": np.array([1, 3, 5, 7, 3, 9, 2], np.int64), "key2": np.zeros(7, np.int64),
            "x": np.arange(7, dtype=np.float32)}
    ext = _ext()
    kw = dict(on=on, how=how, drop_duplicates_ext=drop_duplicates_ext)
    cols = ["key", "key2", "x"]
    _, want = jax_run(cols >> jops.JoinExternal(jnvt.TableBatch.from_pydict(ext), **kw), [data], "local")
    for source in (pnvt.TableBatch.from_pydict(ext), ext, pnvt.Dataset([ext])):
        _, got = port_run(cols >> pops.JoinExternal(source, **kw), [data])
        assert_same(got[0], want[0])
        gv, wv = got[0]["val"].validity, want[0]["val"].validity
        assert (gv is None) == (wv is None)
        if wv is not None:
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_join_external_from_pandas_and_paths(tmp_path):
    """A pandas DataFrame, a parquet path and a list of paths (read by the
    port's reader) join as the reference joins the same table read by its
    Dataset."""
    pd = pytest.importorskip("pandas")
    import pyarrow as pa
    import pyarrow.parquet as pq

    data = {"key": np.array([1, 9, 3, 4], np.int64)}
    ext = _ext()
    out = pnvt.Workflow(["key"] >> pops.JoinExternal(pd.DataFrame(ext), on="key"), device="cpu").transform(
        pnvt.TableBatch.from_pydict(data))
    assert out["val"].values.tolist()[:3] == [11.0, 15.0, 10.0]
    whole, first, second = (str(tmp_path / f) for f in ("ext.parquet", "a.parquet", "b.parquet"))
    pq.write_table(pa.table(ext), whole, use_dictionary=False, compression="NONE")
    pq.write_table(pa.table({k: v[:3] for k, v in ext.items()}), first, use_dictionary=False, compression="zstd")
    pq.write_table(pa.table({k: v[3:] for k, v in ext.items()}), second, use_dictionary=False, compression="NONE")
    _, want = jax_run(["key"] >> jops.JoinExternal(whole, on="key"), [data], "local")
    for path in (whole, [first, second]):
        _, got = port_run(["key"] >> pops.JoinExternal(path, on="key"), [data])
        assert_same(got[0], want[0])
        np.testing.assert_array_equal(got[0]["val"].validity.numpy(), np.asarray(want[0]["val"].validity))


@pytest.mark.parametrize("metric", ["inner", "cosine", "tfidf"])
@pytest.mark.parametrize("form", ["scipy", "tuple"])
def test_column_similarity_matches_jax(metric, form):
    """rtol=1e-6: the same float64 arithmetic, cast to float32."""
    sp = pytest.importorskip("scipy.sparse")
    r = np.random.default_rng(8)
    left = sp.random(40, 30, density=0.2, random_state=1, format="csr")
    right = sp.random(50, 30, density=0.15, random_state=2, format="csr")
    if form == "tuple":
        left, right = (left.indptr, left.indices, left.data, 30), (right.indptr, right.indices, right.data)
    data = {"a": r.integers(-2, 42, 300).astype(np.int64), "b": r.integers(0, 52, 300).astype(np.int64)}
    _, want = jax_run(["a", "b"] >> jops.ColumnSimilarity(left, right, metric=metric, on_device=True), [data], "local")
    _, got = port_run(["a", "b"] >> pops.ColumnSimilarity(left, right, metric=metric, on_device=True), [data])
    assert got[0].column_names == want[0].column_names == ["a_b_sim"]
    np.testing.assert_allclose(got[0]["a_b_sim"].values.numpy(), np.asarray(want[0]["a_b_sim"].values), rtol=1e-6)


# --- phase 24's workflows at 4 × 8,192 rows, end to end ---------------------------------------------
def phase24_graphs(ops):
    dense = CONTS >> ops.FillMedian() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.NormalizeMinMax(
        out_dtype="float16")
    cats = SMALL >> ops.Categorify() >> ops.DropLowCardinality(min_cardinality=4) >> ops.ReduceDtypeSize() >> ops.AddTags(
        ["criteo_small"])
    return dense + cats, CONTS >> ops.FillMissing(add_binary_cols=True)


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
@pytest.mark.parametrize("which", [0, 1], ids=["24a", "24b"])
def test_phase24_workflows_match_jax(parts, which, fitted_by):
    """Codes, masks, dtypes and kept columns exact; float16 within rtol=2^-10
    (one to two ULPs) of the reference's JitExecutor (XLA's reciprocal
    product) and of its LocalExecutor (log1p's ULPs)."""
    for executor in ("jit", "local"):
        jwf, want = jax_run(phase24_graphs(jops)[which], parts, executor)
        _, got = port_run(phase24_graphs(pops)[which], parts, jwf if fitted_by == "jax_state" else None)
        for g, w in zip(got, want):
            assert_same(g, w, conts=CONTS, ulp=F16_ULP["float16"] if which == 0 else None)


# --- the rest of the reference's surface (ROADMAP.md queue 3's faults) -------------------------------
def test_transformed_dataset_to_batches_takes_jax_parameters(parts):
    """JAX's (columns, prefetch, shard, host, hetero), in JAX's order:
    ``columns`` selects output columns, ``shard`` streams a rank's
    partitions, ``prefetch`` is accepted, ``hetero`` names item 11."""
    jsig = inspect.signature(jnvt.workflow.workflow.TransformedDataset.to_batches).parameters.values()
    psig = inspect.signature(pnvt.workflow.TransformedDataset.to_batches).parameters.values()
    assert [(p.name, p.default) for p in psig] == [(p.name, p.default) for p in jsig]
    wf = pnvt.Workflow(CONTS >> pops.FillMissing(0.0), device="cpu")
    ds = pnvt.Dataset([pnvt.TableBatch.from_pydict(p) for p in parts])
    out = list(wf.fit_transform(ds).to_batches(["I1"], 0, (1, 2)))
    assert len(out) == 2 and all(b.column_names == ["I1"] for b in out)
    np.testing.assert_array_equal(out[0]["I1"].values.numpy(), np.nan_to_num(parts[1]["I1"], nan=0.0))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 11:"):
        next(wf.transform(ds).to_batches(hetero=0.5))


def test_dataset_to_batches_takes_prefetch():
    jsig = inspect.signature(jnvt.Dataset.to_batches).parameters.values()
    psig = inspect.signature(pnvt.Dataset.to_batches).parameters.values()
    assert [(p.name, p.default) for p in psig] == [(p.name, p.default) for p in jsig]
    ds = pnvt.Dataset([{"a": np.arange(3)}, {"a": np.arange(4)}, {"a": np.arange(5)}])
    out = list(ds.to_batches(["a"], 0, (1, 2)))  # a JAX-style positional call: shard is the third argument
    assert [b.num_rows for b in out] == [4] and out[0].row_offset == 3


def test_workflow_names_of_the_reference(parts):
    graph = CONTS >> pops.FillMissing(0.0)
    wf = pnvt.Workflow(graph, device="cpu")
    ds = pnvt.Dataset([pnvt.TableBatch.from_pydict(p) for p in parts])
    td = wf.fit_transform(ds)
    assert wf.output_node is graph
    jwf = jnvt.Workflow(CONTS >> jops.FillMissing(0.0))
    jwf.fit(jnvt.Dataset(jax_batches(parts)))
    assert {k: v.name for k, v in wf.input_dtypes.items()} == {k: v.name for k, v in jwf.input_dtypes.items()}
    assert td.infer_schema() is wf.output_schema
    assert pnvt.WorkflowNode is pnvt.dag.Node and pnvt.Shuffle.PER_WORKER.value == "per_worker"
    assert [n.op for n in pnvt.dag.iter_nodes([graph])][0] is graph.op
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 2:"):
        pnvt.dag.Subgraph


def test_process_epoch_reads_label_key():
    from nvtabular_tpu_torch.models import process_epoch

    class Model(torch.nn.Module):
        def forward(self, batch):
            return batch["x"]

    batches = [{"x": torch.tensor([2.0, -1.0, 0.5, -3.0]), "click": torch.tensor([1.0, 0.0, 1.0, 0.0])}]
    assert process_epoch(batches, Model(), label_key="click")["auc"] == 1.0
    with pytest.raises(KeyError):
        process_epoch(batches, Model())
