"""Categorify's vocabulary memory of nvtabular_tpu_torch against the JAX
reference: the parquet artifacts, the ``cat_cache`` tiers, the
``cardinality_memory_limit`` LRU and ``cache_stats``, ``dtype=`` and
``vocabs=``, the refit rule, and K8's solo-table branch (K1-K3 launched on
one vocabulary's own table) through its plain versions.

The port runs on the CPU. The JAX side runs its device path
(``JitExecutor(jit_min_rows=0)``) and its host path (``LocalExecutor``); the
codes are held bit for bit against both. ``cache_stats`` are held against the
device path on one partition: there the reference runs its transform once,
as the port runs it once a batch, and it counts ``host_nbytes`` as the port
does (its host path adds a C++ table the port does not have).
"""

import os

import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest

import nvtabular_tpu as jnvt
import nvtabular_tpu_torch as pnvt
from nvtabular_tpu import ops as jops
from nvtabular_tpu.dag.executor import JitExecutor
from nvtabular_tpu.dag.executor import LocalExecutor as JLocalExecutor
from nvtabular_tpu.ops import lookup as jlookup
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.ops import lookup as plookup


def make_part(seed, n=10_000, ncols=4, card=2000):
    """Column i draws from ``card * (i + 1)**3`` int64 keys: tiny, direct and
    cuckoo-sized vocabularies side by side."""
    r = np.random.default_rng(seed)
    return {f"c{i}": r.integers(0, card * (i + 1) ** 3, n).astype(np.int64) for i in range(ncols)}


def cols(ncols):
    return [f"c{i}" for i in range(ncols)]


def run_jax(parts, out_path, executor="jit", ncols=4, **kwargs):
    op = jops.Categorify(out_path=out_path, **kwargs)
    ex = JitExecutor(jit_min_rows=0) if executor == "jit" else JLocalExecutor()
    wf = jnvt.Workflow(cols(ncols) >> op, executor=ex)
    wf.fit(jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts]))
    out = list(wf.transform(jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts])).to_batches())
    return op, out


def run_port(parts, out_path, ncols=4, **kwargs):
    op = pops.Categorify(out_path=out_path, **kwargs)
    wf = pnvt.Workflow(cols(ncols) >> op, device="cpu")
    wf.fit(pnvt.Dataset(parts))
    out = list(wf.transform(pnvt.Dataset(parts)).to_batches())
    return op, out, wf


def assert_same_codes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.column_names == w.column_names
        for name in w.column_names:
            gv, wv = g[name].values.numpy(), np.asarray(w[name].values)
            assert gv.dtype == wv.dtype, name
            np.testing.assert_array_equal(gv, wv, err_msg=name)


TIERS = [
    {"cat_cache": "disk"},
    {"cat_cache": "host"},
    {"cat_cache": "device"},
    {"cat_cache": {"c0": "disk", "c1": "device", "c2": "host"}},
    {"cardinality_memory_limit": 100 * 1024},
    {"cardinality_memory_limit": "300KB", "cat_cache": {"c3": "disk"}},
    {"cat_cache": "disk", "num_buckets": 7, "single_table": True},
]
TIER_IDS = ["disk", "host", "device", "per_column", "budget", "budget_str_disk", "disk_buckets_single_table"]


@pytest.mark.parametrize("executor", ["jit", "local"])
@pytest.mark.parametrize("kwargs", TIERS, ids=TIER_IDS)
def test_codes_match_jax_under_every_tier(tmp_path, kwargs, executor):
    """The tiers and the budget change no code: bit for bit against the
    reference's device and host paths, on two partitions."""
    parts = [make_part(s) for s in range(2)]
    # the reference's host path fails under a budget: the LRU releases a
    # vocabulary its queued host encodes hold (ROADMAP.md queue 3); there
    # the port's codes are held against the host path's unconstrained ones
    jax_kwargs = {} if executor == "local" and "cardinality_memory_limit" in kwargs else kwargs
    _, want = run_jax(parts, str(tmp_path / "j"), executor, **jax_kwargs)
    _, got, _ = run_port(parts, str(tmp_path / "p"), **kwargs)
    if "num_buckets" not in kwargs and "single_table" not in kwargs:
        _, plain, _ = run_port(parts, str(tmp_path / "u"))  # no tier, no budget
        assert_same_codes(got, [b.to("cpu") for b in plain])
    assert_same_codes(got, want)


@pytest.mark.parametrize("kwargs", TIERS, ids=TIER_IDS)
def test_cache_stats_and_host_nbytes_match_jax(tmp_path, kwargs):
    """After a transform of one partition: the same hits, reloads and
    releases, the same vocabularies resident, each holding the same
    ``host_nbytes`` (values, counts, the ascending copy and its codes, the
    lookup table)."""
    parts = [make_part(0)]
    jop, _ = run_jax(parts, str(tmp_path / "j"), **kwargs)
    pop, _, _ = run_port(parts, str(tmp_path / "p"), **kwargs)
    assert pop.cache_stats == jop.cache_stats
    assert {k: v.resident for k, v in pop.vocabs.items()} == {k: v.resident for k, v in jop.vocabs.items()}
    assert {k: v.host_nbytes() for k, v in pop.vocabs.items()} == {k: v.host_nbytes() for k, v in jop.vocabs.items()}


def test_artifacts_match_jax(tmp_path):
    """``<out_path>/categories/unique.<key>.parquet``, read back with
    pyarrow: the same columns (values in code order, ``<key>_size``
    counts), types and values as the reference's, floats and a joint group
    included."""
    r = np.random.default_rng(5)
    parts = [{"a": r.integers(0, 500, 4000).astype(np.int32), "b": r.integers(0, 900, 4000),
              "f": r.normal(size=4000).round(1).astype(np.float32)} for _ in range(2)]
    sel = ["a", "f", ["a", "b"]]
    jop = jops.Categorify(out_path=str(tmp_path / "j"))
    jnvt.Workflow(sel >> jop, executor=JitExecutor(jit_min_rows=0)).fit(
        jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts]))
    pop = pops.Categorify(out_path=str(tmp_path / "p"))
    pnvt.Workflow(sel >> pop, device="cpu").fit(pnvt.Dataset(parts))
    assert sorted(pop.categories) == sorted(jop.categories)
    for key, path in jop.categories.items():
        assert os.path.basename(pop.categories[key]) == os.path.basename(path)
        assert pop.categories[key] == str(tmp_path / "p" / "categories" / os.path.basename(path))
        want, got = pq.read_table(path), pq.read_table(pop.categories[key])
        assert got.column_names == want.column_names == [key, f"{key}_size"]
        for name in want.column_names:
            assert got[name].type == want[name].type, name
            np.testing.assert_array_equal(got[name].to_numpy(), want[name].to_numpy(), err_msg=name)


def test_disk_tier_releases_between_transforms_and_reloads(tmp_path):
    """tests/unit/ops/test_vocab_memory.py:27-45: after the fit and after each
    transform no disk-tier vocabulary is resident; each transform reloads
    them; two transforms give the same codes."""
    parts = [make_part(s) for s in range(2)]
    op, out1, wf = run_port(parts, str(tmp_path), cat_cache="disk")
    assert all(v.artifact_path for v in op.vocabs.values())
    assert not any(v.resident for v in op.vocabs.values())
    assert op.cache_stats == {"hits": 0, "reloads": 8, "releases": 12}
    out2 = list(wf.transform(pnvt.Dataset(parts)).to_batches())
    assert_same_codes(out2, [b for b in out1])
    assert op.cache_stats["reloads"] == 16 and not any(v.resident for v in op.vocabs.values())


def test_memory_limit_lru_spills(tmp_path):
    """:48-67: releases happen, the resident bytes stay within the budget
    plus one vocabulary in use, and the codes equal an unconstrained fit's."""
    parts = [make_part(s, ncols=6) for s in range(2)]
    op, out, _ = run_port(parts, str(tmp_path / "b"), ncols=6, cardinality_memory_limit=100 * 1024)
    assert op.cache_stats["releases"] > 0
    resident = [v.host_nbytes() for v in op.vocabs.values() if v.resident]
    assert sum(resident) <= 100 * 1024 + max(resident + [0])
    _, want, _ = run_port(parts, str(tmp_path / "u"), ncols=6)
    assert_same_codes(out, want)


def test_host_tier_stays_resident_and_per_column_tiers(tmp_path):
    """:70-84."""
    parts = [make_part(s) for s in range(2)]
    op, _, _ = run_port(parts, str(tmp_path / "h"))
    assert all(v.resident for v in op.vocabs.values()) and op.cache_stats["releases"] == 0
    op, _, _ = run_port(parts, str(tmp_path / "t"), cat_cache={"c0": "disk", "c1": "device", "c2": "host"})
    assert [op.vocabs[c].resident for c in ("c0", "c1", "c2", "c3")] == [False, True, True, True]
    assert [op._tier(c) for c in ("c0", "c1", "c2", "c3")] == ["disk", "device", "host", "host"]


@pytest.mark.parametrize("tier", ["device", "host", "disk"])
def test_cat_cache_tiers_match_jax_on_a_full_workflow(tmp_path, tier):
    """tests/unit/test_engine_matrix.py:194: a tier changes no output of a
    workflow with a multihot column, TargetEncoding, JoinGroupby and the
    continuous chain; against the reference's host path, bit for bit for
    the codes."""
    r = np.random.default_rng(11)
    n = 6000
    lengths = r.integers(0, 4, n)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)

    def part(mod):
        return mod.TableBatch({
            "cat_tiny": mod.Column(r2.integers(0, 30, n).astype(np.int64)),
            "cat_big": mod.Column(r2.integers(0, 50_000, n).astype(np.int64)),
            "genres": mod.Column(gvals, offsets),
            "user": mod.Column(r2.integers(0, 300, n).astype(np.int64)),
            "label": mod.Column(r2.integers(0, 2, n).astype(np.int64)),
        })

    r2 = np.random.default_rng(12)
    gvals = r.integers(0, 20, int(offsets[-1])).astype(np.int64)
    jpart = part(jnvt)
    r2 = np.random.default_rng(12)
    ppart = part(pnvt)

    def graph(ops, out):
        cats = ["cat_tiny", "cat_big", "genres"] >> ops.Categorify(cat_cache=tier, out_path=out)
        te = ["user"] >> ops.TargetEncoding(target="label", kfold=3, p_smooth=20, cat_cache=tier)
        return cats + te + ["label"]

    jwf = jnvt.Workflow(graph(jops, str(tmp_path / "j")), executor=JLocalExecutor())
    jwf.fit(jnvt.Dataset([jpart]))
    want = list(jwf.transform(jnvt.Dataset([jpart])).to_batches())[0]
    pwf = pnvt.Workflow(graph(pops, str(tmp_path / "p")), device="cpu")
    pwf.fit(pnvt.Dataset([ppart]))
    got = list(pwf.transform(pnvt.Dataset([ppart])).to_batches())[0]
    assert got.column_names == want.column_names
    for name in ("cat_tiny", "cat_big", "genres", "label"):
        np.testing.assert_array_equal(got[name].values.numpy(), np.asarray(want[name].values), err_msg=name)
    np.testing.assert_array_equal(got["genres"].offsets.numpy(), np.asarray(want["genres"].offsets))
    te = "TE_user_label"
    np.testing.assert_allclose(got[te].values.numpy(), np.asarray(want[te].values), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", ["int64", "int16", "int32"])
def test_dtype_casts_the_codes_as_jax(tmp_path, dtype):
    parts = [make_part(s) for s in range(2)]
    _, want = run_jax(parts, str(tmp_path / "j"), dtype=dtype)
    op, got, wf = run_port(parts, str(tmp_path / "p"), dtype=dtype)
    assert_same_codes(got, want)
    assert {k: v.name for k, v in wf.output_dtypes.items()} == {k: np.dtype(dtype).name for k in cols(4)}


@pytest.mark.parametrize("form", ["array", "list", "column", "path"])
def test_vocabs_match_jax_and_write_their_artifacts_at_construction(tmp_path, form):
    """``vocabs=``: values in code order, from an array, a list, a Column or
    a parquet path (its first column); the artifact is written at
    construction; the codes equal the reference's, misses and nulls
    included."""
    vocab = np.array([30, 7, 1000, -5, 12], dtype=np.int64)
    source = {"array": vocab, "list": vocab.tolist(), "column": pnvt.Column(vocab)}.get(form)
    if form == "path":
        import pyarrow as pa

        pq.write_table(pa.table({"v": vocab}), str(tmp_path / "v.parquet"), use_dictionary=False,
                       compression="NONE")
        source = str(tmp_path / "v.parquet")
    jsource = jnvt.Column(vocab) if form == "column" else source
    jop = jops.Categorify(vocabs={"a": jsource}, out_path=str(tmp_path / "j"))
    pop = pops.Categorify(vocabs={"a": source}, out_path=str(tmp_path / "p"))
    assert pop.fitted and pop.fit_generation == 0
    assert pq.read_table(pop.categories["a"])["a"].to_pylist() == vocab.tolist()
    data = {"a": pnvt.Column(np.array([7, 30, 99, -5, 12, 1000, 7], np.int64), None,
                             np.array([True, True, True, True, False, True, True]))}
    jdata = {"a": jnvt.Column(np.array([7, 30, 99, -5, 12, 1000, 7], np.int64), None,
                              np.array([True, True, True, True, False, True, True]))}
    want = jnvt.Workflow(["a"] >> jop, executor=JitExecutor(jit_min_rows=0)).transform(jnvt.TableBatch(jdata))
    got = pnvt.Workflow(["a"] >> pop, device="cpu").transform(pnvt.TableBatch(data))
    np.testing.assert_array_equal(got["a"].values.numpy(), np.asarray(want["a"].values))
    assert got["a"].values.tolist() == [4, 3, 2, 6, 1, 5, 4]


def test_refit_keeps_supplied_vocabs_and_refits_fitted_ops(tmp_path):
    """``Workflow.fit`` clears only stat ops a fit filled (fit_generation > 0,
    workflow.py:177-195): a ``vocabs=`` op survives every fit, a fitted one
    is refitted on the new data."""
    supplied = pops.Categorify(vocabs={"a": np.array([5, 6])}, out_path=str(tmp_path / "s"))
    fitted = pops.Categorify(out_path=str(tmp_path / "f"))
    wf = pnvt.Workflow((["a"] >> supplied) + (["b"] >> fitted), device="cpu")
    for data in ({"a": np.array([1, 1, 2]), "b": np.array([3, 3, 4])},
                 {"a": np.array([9, 9, 9]), "b": np.array([8, 8, 7])}):
        wf.fit(pnvt.Dataset(data))
        out = wf.transform(pnvt.TableBatch.from_pydict(data))
        assert supplied.vocabs["a"].values_by_code.tolist() == [5, 6] and supplied.fit_generation == 0
        assert fitted.vocabs["b"].values_by_code.tolist() == data["b"][[0, 2]].tolist()
        assert out["a"].values.tolist() == [2, 2, 2] and out["b"].values.tolist() == [3, 3, 4]


def test_combo_groups_stay_resident_under_the_disk_tier(tmp_path):
    """A combo group's tuples are strings in the reference's artifact; the
    port writes none for them and never releases them (item 16), and the
    codes still equal the reference's."""
    r = np.random.default_rng(2)
    part = {"a": r.integers(0, 20, 3000), "b": r.integers(0, 30, 3000)}
    kw = dict(encode_type="combo", cat_cache="disk")
    jop = jops.Categorify(out_path=str(tmp_path / "j"), **kw)
    jwf = jnvt.Workflow([["a", "b"]] >> jop, executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([jnvt.TableBatch.from_pydict(part)]))
    pop = pops.Categorify(out_path=str(tmp_path / "p"), **kw)
    pwf = pnvt.Workflow([["a", "b"]] >> pop, device="cpu")
    pwf.fit(pnvt.Dataset([part]))
    want = jwf.transform(jnvt.TableBatch.from_pydict(part))["a_b"].values
    got = pwf.transform(pnvt.TableBatch.from_pydict(part))["a_b"].values
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pop.vocabs["a_b"].resident and pop.vocabs["a_b"].artifact_path is None


# --- K8's solo-table branch: the one-row plain versions of K1, K2, K3 ----------------------------------
SOLO_VOCABS = {
    "tiny": np.random.default_rng(1).choice(np.arange(-2**31, 2**31 - 1, 7919, dtype=np.int64), 3000,
                                             replace=False),
    "direct": np.random.default_rng(2).choice(np.arange(100_000, 160_000), 9000, replace=False),
    "cuckoo": np.random.default_rng(3).choice(np.arange(-2**31, 2**31 - 1, 104729, dtype=np.int64), 20000,
                                               replace=False),
}
JAX_KINDS = {"tiny": jlookup.TinyLookup, "direct": jlookup.DirectLookup, "cuckoo": jlookup.CuckooLookup}


@pytest.mark.parametrize("offset", [0, 1000])
@pytest.mark.parametrize("num_buckets", [1, 5])
@pytest.mark.parametrize("kind", ["tiny", "direct", "cuckoo"])
def test_solo_plain_versions_match_jax_encode_dev(tmp_path, kind, num_buckets, offset):
    """One column through its own table, launched with one table row, against
    the reference's ``TinyLookup`` / ``DirectLookup`` / ``CuckooLookup.
    encode_dev`` with ``encode_device``'s OOV (hashed into ``num_buckets``),
    null and offset epilogue (categorify.py:552-585). Keys, misses, nulls
    and the int32 extremes."""
    vocab = SOLO_VOCABS[kind]
    r = np.random.default_rng(7)
    n = 5000
    values = np.where(r.random(n) < 0.3, r.integers(-2**31, 2**31 - 1, n), r.choice(vocab, n)).astype(np.int64)
    values[:3] = [2**31 - 1, -(2**31), 0]
    validity = r.random(n) > 0.1
    jop = jops.Categorify(vocabs={"k": vocab}, num_buckets=num_buckets, out_path=str(tmp_path / "j"))
    pop = pops.Categorify(vocabs={"k": vocab}, num_buckets=num_buckets, out_path=str(tmp_path / "p"),
                          cat_cache="disk")
    jvocab = jop.vocabs["k"]
    jvocab.offset = pop.vocabs["k"].offset = offset
    assert isinstance(jvocab.lookup_struct(), JAX_KINDS[kind])
    want = jvocab.encode_device(jnp.asarray(values.astype(np.int32)), jnp.asarray(validity))
    pop.vocabs["k"].ensure_resident()
    assert plookup.kind_of(pop.vocabs["k"].lookup_struct()) == kind
    got = pop.encode_solo("k", pnvt.Column(values.astype(np.int32), None, validity))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert pop.cache_stats["hits"] == 1


def test_solo_table_is_built_once_per_resident_vocabulary(tmp_path):
    """The one-row table is kept while the vocabulary is resident and
    rebuilt after a reload (the disk tier rebuilds it each batch)."""
    parts = [make_part(s, n=2000) for s in range(3)]
    op, _, wf = run_port(parts, str(tmp_path), cardinality_memory_limit=1 << 40)
    tables = {k: v._solo[2] for k, v in op.vocabs.items()}
    list(wf.transform(pnvt.Dataset(parts)).to_batches())
    assert all(op.vocabs[k]._solo[2] is t for k, t in tables.items())
    op.vocabs["c3"].release_host()
    assert op.vocabs["c3"]._solo is None
    list(wf.transform(pnvt.Dataset(parts[:1])).to_batches())
    assert op.vocabs["c3"]._solo is not None and op.vocabs["c3"]._solo[2] is not tables["c3"]
