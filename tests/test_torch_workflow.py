"""The nvtabular_tpu_torch slice as a whole against the JAX reference.

The Criteo-shaped workflow (Categorify over int columns of every table kind,
FillMissing → Clip → LogOp → Normalize over float columns, a passthrough
label) is fitted and transformed by both packages on the same numpy inputs.
The port runs on the CPU (``device="cpu"``), i.e. through the kernels' plain
PyTorch versions; the reference runs its device path on CPU-JAX
(``JitExecutor(jit_min_rows=0)``: smaller batches would take its host path).
"""

import inspect
import warnings

import numpy as np
import pytest
import torch

import nvtabular_tpu as jnvt
import nvtabular_tpu_torch as pnvt
from nvtabular_tpu import ops as jops
from nvtabular_tpu.dag.executor import JitExecutor
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.dag.executor import LocalExecutor
from nvtabular_tpu_torch.ops.lookup import CuckooLookup, DirectLookup, TinyLookup

CATS = ["t0", "t1", "d0", "w0", "w1"]
CONTS = ["I0", "I1", "I2"]
ROWS_PER_PART, PARTS = 5000, 4

# float tolerance: log1p differs by a few float32 ULPs between XLA's and
# PyTorch's CPU implementations, and (x - mean) / std carries that through
CONT_TOL = dict(rtol=1e-5, atol=1e-5)
# fitted moments: both reduce in float64 but in different orders, from
# inputs that differ by those ULPs
MOMENT_TOL = dict(rtol=1e-6, atol=1e-9)


def make_part(seed, n=ROWS_PER_PART, shift=0):
    """2 tiny columns, 1 compact column > 4096 keys (direct), 2 wide-key
    columns > 4096 keys (cuckoo), 3 floats with ~5% NaN, an int32 label."""
    r = np.random.default_rng(seed)
    spread = lambda x, m: ((x.astype(np.int64) * m) % 2**31).astype(np.int32)  # noqa: E731
    d = {
        "t0": (r.integers(0, 40, n) + shift).astype(np.int32),
        "t1": spread(r.integers(0, 3000, n) + shift, 7919),
        "d0": (100_000 + r.integers(0, 8000, n) + shift).astype(np.int32),
        "w0": spread(r.zipf(1.3, n) % 12_000 + shift, 2654435761),
        "w1": (spread(r.integers(0, 9000, n) + shift, 40503).astype(np.int64) - 2**30).astype(np.int32),
    }
    for i, name in enumerate(CONTS):
        x = r.normal(1.0, 3.0, n).astype(np.float32)
        x[r.random(n) < 0.05] = np.nan
        d[name] = x
    d["label"] = r.integers(0, 2, n).astype(np.int32)
    return d


@pytest.fixture(scope="module")
def parts():
    return [make_part(s) for s in range(PARTS)]


def build(ops, cat_kwargs=None, **extra):
    cats = CATS >> ops.Categorify(**(cat_kwargs or {}), **extra)
    conts = CONTS >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.Normalize()
    return cats + conts + ["label"]


def jax_workflow(parts, tmp_path, **cat_kwargs):
    wf = jnvt.Workflow(
        build(jops, cat_kwargs, out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0)
    )
    wf.fit(jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts]))
    return wf


def jax_state(wf):
    """The JAX workflow's fitted state as numpy arrays and floats."""
    state = {"categorify": {}, "normalize": {}}
    for node in wf.graph.nodes:
        if isinstance(node.op, jops.Categorify):
            for key, v in node.op.vocabs.items():
                state["categorify"][key] = {
                    "values_by_code": np.asarray(v.values_by_code),
                    "num_buckets": v.num_buckets,
                    "offset": v.offset,
                }
        elif isinstance(node.op, jops.Normalize):
            for name in node.op.means:
                state["normalize"][name] = {"mean": node.op.means[name], "std": node.op.stds[name]}
    return state


def port_categorify(wf):
    return next(n.op for n in wf.graph.nodes if isinstance(n.op, pops.Categorify))


@pytest.mark.parametrize(
    "cat_kwargs",
    [{}, {"freq_threshold": 2}, {"max_size": 3000}, {"max_size": {"w0": 500, "d0": 6000}}],
    ids=["plain", "freq_threshold", "max_size", "max_size_per_column"],
)
def test_fit_matches_jax(parts, tmp_path, cat_kwargs):
    jwf = jax_workflow(parts, tmp_path, **cat_kwargs)
    pwf = pnvt.Workflow(build(pops, cat_kwargs), device="cpu")
    pwf.fit(pnvt.Dataset(parts))

    want = jax_state(jwf)
    got = pnvt.fitted_state(pwf)
    assert sorted(got["categorify"]) == sorted(want["categorify"])
    for key, ref in want["categorify"].items():
        np.testing.assert_array_equal(got["categorify"][key]["values_by_code"], ref["values_by_code"])
        assert got["categorify"][key]["offset"] == ref["offset"]
    for name, ref in want["normalize"].items():
        np.testing.assert_allclose(got["normalize"][name]["mean"], ref["mean"], **MOMENT_TOL)
        np.testing.assert_allclose(got["normalize"][name]["std"], ref["std"], **MOMENT_TOL)
    if not cat_kwargs:  # every table kind is on the path
        kinds = {type(v.lookup_struct()) for v in port_categorify(pwf).vocabs.values()}
        assert kinds == {TinyLookup, DirectLookup, CuckooLookup}


def _assert_same_output(got, want):
    """got: port TableBatch; want: JAX TableBatch (host)."""
    assert got.column_names == want.column_names
    host = got.to_host()
    for name in want.column_names:
        g = host[name]
        w = np.asarray(want[name].values)
        assert g.dtype == w.dtype, name
        if name in CONTS:
            np.testing.assert_allclose(g, w, **CONT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert got[name].validity is None


@pytest.mark.parametrize(
    "cat_kwargs", [{}, {"single_table": True}], ids=["per_column", "single_table"]
)
def test_transform_matches_jax_with_same_state(parts, tmp_path, cat_kwargs):
    jwf = jax_workflow(parts, tmp_path, **cat_kwargs)
    pwf = pnvt.Workflow(build(pops, cat_kwargs), device="cpu")
    pnvt.load_fitted_state(pwf, jax_state(jwf))

    probe = make_part(99, shift=7)  # unseen values too → OOV code 2
    probe["t0"][:5] = [-1, 2**31 - 1, -(2**31), 0, 39]
    for part in (parts[1], probe):
        got = pwf.transform(pnvt.TableBatch.from_pydict(part))
        want = jwf.transform(jnvt.TableBatch.from_pydict(part)).to_host()
        _assert_same_output(got, want)
    assert [cs.name for cs in pwf.output_schema] == [cs.name for cs in jwf.output_schema]
    assert {k: v.name for k, v in pwf.output_dtypes.items()} == {
        k: v.name for k, v in jwf.output_dtypes.items()
    }


def test_transform_nulls_through_validity(parts, tmp_path):
    """Null categorical rows (validity mask) encode to 1 on both sides; the
    continuous chain fills masked rows and drops the mask."""
    jwf = jax_workflow(parts, tmp_path)
    pwf = pnvt.Workflow(build(pops), device="cpu")
    pnvt.load_fitted_state(pwf, jax_state(jwf))
    part = parts[2]
    rng = np.random.default_rng(8)
    valid = {n: rng.random(len(part["label"])) > 0.2 for n in ["t1", "d0", "w0", "I1"]}

    def columns(mod):
        return {
            n: mod.Column(v, None, valid[n]) if n in valid else mod.Column(v) for n, v in part.items()
        }

    got = pwf.transform(pnvt.TableBatch(columns(pnvt)))
    want = jwf.transform(jnvt.TableBatch(columns(jnvt))).to_host()
    _assert_same_output(got, want)
    assert (got["d0"].values.numpy()[~valid["d0"]] == 1).all()


def test_dataset_transform_matches_fit_transform(parts):
    pwf = pnvt.Workflow(build(pops), device="cpu")
    out = list(pwf.fit_transform(pnvt.Dataset(parts)).to_batches())
    assert len(out) == PARTS
    again = pwf.transform(pnvt.TableBatch.from_pydict(parts[3]))
    for name in again.column_names:
        assert torch.equal(out[3][name].values, again[name].values)
    # the op-by-op executor gives the same result as the fused device path
    # (float tolerance: the fused chain and the ops may take PyTorch's
    # vectorized and scalar log1p on different elements)
    op_by_op = LocalExecutor().transform_batch(
        pnvt.TableBatch.from_pydict(parts[3]), pwf.graph.output_node
    )
    for name in again.column_names:
        torch.testing.assert_close(op_by_op[name].values, again[name].values, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["clip_both_bounds", "no_fill", "float64_inputs"])
def test_continuous_variants_match_jax(tmp_path, variant):
    """Chains the Criteo path does not take: Clip with an upper bound (fused),
    a chain without FillMissing (fused; NaN and the validity mask pass
    through), and float64 inputs (outside the kernel's contract: op by op)."""
    rng = np.random.default_rng(11)
    n = 6000
    x = rng.normal(1.0, 3.0, (2, n))
    x[rng.random(x.shape) < 0.05] = np.nan
    x = x.astype(np.float64 if variant == "float64_inputs" else np.float32)
    valid = rng.random(n) > 0.1

    def graph(ops):
        node = ["a", "b"] >> ops.FillMissing(fill_val=0.5) if variant != "no_fill" else ["a", "b"]
        hi = 4.0 if variant == "clip_both_bounds" else None
        return node >> ops.Clip(min_value=0.0, max_value=hi) >> ops.LogOp() >> ops.Normalize()

    def batch(mod):
        return mod.TableBatch({"a": mod.Column(x[0]), "b": mod.Column(x[1], None, valid)})

    jwf = jnvt.Workflow(graph(jops), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([batch(jnvt)]))
    pwf = pnvt.Workflow(graph(pops), device="cpu")
    pwf.fit(pnvt.Dataset([batch(pnvt)]))
    for name, ref in jax_state(jwf)["normalize"].items():
        got = pnvt.fitted_state(pwf)["normalize"][name]
        np.testing.assert_allclose(got["mean"], ref["mean"], **MOMENT_TOL)
        np.testing.assert_allclose(got["std"], ref["std"], **MOMENT_TOL)
    pnvt.load_fitted_state(pwf, jax_state(jwf))
    got = pwf.transform(batch(pnvt))
    want = jwf.transform(batch(jnvt)).to_host()
    for name in ["a", "b"]:
        g, w = got[name], want[name]
        assert g.values.dtype == torch.float32 and np.asarray(w.values).dtype == np.float32
        np.testing.assert_allclose(g.values.numpy(), np.asarray(w.values), **CONT_TOL)
        if variant == "no_fill" and name == "b":
            np.testing.assert_array_equal(g.validity.numpy(), np.asarray(w.validity))
        else:
            assert g.validity is None and w.validity is None


def test_refit_serves_new_tables(parts):
    """Refit on disjoint data: the next transform uses the new vocabularies
    (the executor's table cache is keyed on fit_generation), as
    tests/unit/test_jit_executor.py::test_refit_replaces_device_tables does
    for the JAX device path."""
    pwf = pnvt.Workflow(build(pops), device="cpu")
    pwf.fit(pnvt.Dataset(parts))
    batch_b = pnvt.TableBatch.from_pydict(make_part(50, shift=20_000))
    stale = pwf.transform(batch_b)
    assert (stale["w1"].values == 2).float().mean() > 0.9  # mostly OOV before the refit

    pwf.fit(pnvt.Dataset([make_part(s, shift=20_000) for s in range(50, 52)]))
    fresh = pwf.transform(batch_b)
    ref = pnvt.Workflow(build(pops), device="cpu")
    ref.fit(pnvt.Dataset([make_part(s, shift=20_000) for s in range(50, 52)]))
    want = ref.transform(batch_b)
    for name in CATS:
        assert torch.equal(fresh[name].values, want[name].values), name
    assert (fresh["w1"].values == 2).float().mean() < 0.1


def test_joint_group_shares_one_vocab(tmp_path):
    rng = np.random.default_rng(9)
    data = {
        "a": rng.integers(0, 6000, 8000).astype(np.int32),
        "b": rng.integers(3000, 9000, 8000).astype(np.int32),
    }
    jwf = jnvt.Workflow(
        [["a", "b"]] >> jops.Categorify(out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0)
    )
    jwf.fit(jnvt.Dataset(jnvt.TableBatch.from_pydict(data)))
    pwf = pnvt.Workflow([["a", "b"]] >> pops.Categorify(), device="cpu")
    pwf.fit(pnvt.Dataset(data))
    assert list(pnvt.fitted_state(pwf)["categorify"]) == ["a_b"]
    np.testing.assert_array_equal(
        pnvt.fitted_state(pwf)["categorify"]["a_b"]["values_by_code"],
        jax_state(jwf)["categorify"]["a_b"]["values_by_code"],
    )
    got = pwf.transform(pnvt.TableBatch.from_pydict(data))
    want = jwf.transform(jnvt.TableBatch.from_pydict(data)).to_host()
    _assert_same_output(got, want)


def test_default_device_is_cuda():
    node = ["a"] >> pops.Categorify()
    if torch.cuda.is_available():
        assert pnvt.Workflow(node).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pnvt.Workflow(node)


@pytest.mark.parametrize(
    "make",
    [
        lambda: pops.Categorify(encode_type="combo", num_buckets=4),
    ],
    ids=["combo"],
)
def test_unported_options_raise(make):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make()


@pytest.mark.parametrize(
    "data",
    [
        {"a": np.array(["x", "y"], dtype=object)},
        {"a": np.array([1, 2**40], dtype=np.int64)},
        {"a": [[1, 2**40], [3]]},  # list columns are ported (test_torch_lists.py); their wide keys are not
    ],
    ids=["strings", "wide_keys", "lists"],
)
def test_unported_columns_raise(data):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pnvt.Workflow(["a"] >> pops.Categorify(), device="cpu").fit(pnvt.Dataset(data))


# --- the reference's constructor signatures and its facade ----------------------------
OPS_IN_BOTH = sorted(
    n for n in set(pops.__all__) & set(jops.__all__) if isinstance(getattr(pops, n), type) and n != "ColumnSelector"
)
REQUIRED = {"Bucketize": [[1.0]], "DifferenceLag": ["a"], "HashBucket": [10], "HashedCross": [10],
            "LambdaOp": [abs], "ListSlice": [0], "TargetEncoding": ["y"], "Filter": [abs],
            "ColumnSimilarity": [(np.array([0, 1]), np.array([0]), np.array([1.0]))],
            "JoinExternal": [{"a": np.array([1], dtype=np.int32)}, "a"]}
# both packages refuse a Clip with neither bound, and a Rename with no new name
NOT_DEFAULT = {"Clip": {"min_value": 0.0}, "Rename": {"postfix": "_x"}}


def test_op_signatures_match_jax():
    """Every op both packages export takes the reference's parameters: the
    same names, kinds, order and defaults."""
    assert len(OPS_IN_BOTH) >= 14
    for name in OPS_IN_BOTH:
        want = inspect.signature(getattr(jops, name).__init__).parameters.values()
        got = inspect.signature(getattr(pops, name).__init__).parameters.values()
        assert [(p.name, p.kind, p.default) for p in got] == [(p.name, p.kind, p.default) for p in want], name


@pytest.mark.parametrize("name", OPS_IN_BOTH)
def test_ops_take_every_jax_keyword_at_its_default(name):
    """Each keyword of the reference's constructor, passed by name at the
    reference's default, constructs the port's op."""
    params = inspect.signature(getattr(jops, name).__init__).parameters.values()
    kwargs = {p.name: p.default for p in params if p.default is not inspect.Parameter.empty}
    getattr(pops, name)(*REQUIRED.get(name, []), **dict(kwargs, **NOT_DEFAULT.get(name, {})))


# (op, keywords, what the port does: "accept", "warn" or the ROADMAP item it names)
JAX_OPTIONS = [
    ("Categorify", {"out_path": "cats"}, "item 2"),
    ("Categorify", {"cat_cache": "device"}, "item 14"),
    ("Categorify", {"cat_cache": {"a": "disk"}}, "item 14"),
    ("Categorify", {"dtype": "int64"}, "item 14"),
    ("Categorify", {"vocabs": {"a": [1, 2]}}, "item 14"),
    ("Categorify", {"cardinality_memory_limit": 1 << 20}, "item 14"),
    ("Categorify", {"encode_type": "combo", "num_buckets": 4}, "item 4"),
    ("Categorify", {"on_host": False, "split_out": 4, "split_every": 2, "other": 1}, "accept"),
    ("Categorify", {"cat_cache": {"a": "host"}, "num_buckets": {"a": 8}, "single_table": True}, "accept"),
    ("Categorify", {"search_sorted": True}, "warn"),
    ("TargetEncoding", {"out_path": "stats"}, "item 2"),
    ("TargetEncoding", {"cat_cache": "device"}, "item 14"),
    ("TargetEncoding", {"on_host": False, "split_out": 4, "split_every": 2, "other": 1}, "accept"),
    ("JoinGroupby", {"out_path": "stats"}, "item 2"),
    ("JoinGroupby", {"cat_cache": "disk"}, "item 14"),
    ("JoinGroupby", {"on_host": False, "split_out": 4, "split_every": 2, "other": 1}, "accept"),
    ("FillMissing", {"add_binary_cols": True}, "accept"),
    ("Normalize", {"out_dtype": "float16"}, "accept"),
]


@pytest.mark.parametrize("name, kwargs, outcome", JAX_OPTIONS,
                         ids=[f"{n}-{'-'.join(k)}" for n, k, _ in JAX_OPTIONS])
def test_jax_only_options(name, kwargs, outcome):
    """An option the reference acts on and the port does not raises
    NotImplementedError naming its ROADMAP item; one the reference accepts
    and ignores is accepted (``search_sorted`` warns, as there)."""
    make = lambda: getattr(pops, name)(*REQUIRED.get(name, []), **kwargs)  # noqa: E731
    if outcome == "accept":
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            make()
    elif outcome == "warn":
        with pytest.warns(UserWarning, match="no effect"):
            make()
    else:
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {outcome}:"):
            make()


@pytest.mark.parametrize(
    "call, item",
    [
        (lambda wf, ds: wf.save("wf"), "item 2"),
        (lambda wf, ds: type(wf).load("wf"), "item 2"),
        (lambda wf, ds: wf.fit_schema(ds.schema), "item 2"),
        (lambda wf, ds: wf.remove_inputs(["a"]), "item 2"),
        (lambda wf, ds: wf.get_subworkflow("a"), "item 2"),
        (lambda wf, ds: wf.clear_stats(), "item 2"),
        (lambda wf, ds: wf.input_schema, "item 2"),
        (lambda wf, ds: wf.transform(ds).to_parquet("out"), "item 1"),
        (lambda wf, ds: wf.transform(ds).num_rows, "item 1"),
    ],
    ids=["save", "load", "fit_schema", "remove_inputs", "get_subworkflow", "clear_stats", "input_schema",
         "to_parquet", "num_rows"],
)
def test_jax_only_methods_raise(call, item):
    """The reference's Workflow and TransformedDataset methods the port has
    not ported raise NotImplementedError naming their ROADMAP item, never
    AttributeError."""
    ds = pnvt.Dataset({"a": np.array([1, 2, 2], dtype=np.int32)})
    wf = pnvt.Workflow(["a"] >> pops.Categorify(), device="cpu").fit(ds)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1 {item}:"):
        call(wf, ds)
