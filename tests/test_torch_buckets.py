"""Categorify's hashed out-of-vocabulary buckets (``num_buckets > 1``, K4's
hashed branch) and float keys (the sorted table, K8) in nvtabular_tpu_torch
against the JAX reference.

Both packages see the same seeded numpy data. The port runs on the CPU
(``device="cpu"``: the kernels' plain versions); the reference runs
``JitExecutor(jit_min_rows=0)``, its device path on CPU-JAX, where float
keys and values are float32 (x64 is off). Each workflow case is fitted by
the port and, separately, carried over from the JAX fit by ``convert``.
Codes must be equal bit for bit; so must the fitted vocabularies.
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
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.kernels import lookup as klk
from nvtabular_tpu_torch.ops.lookup import BatchedSorted, CuckooLookup, DirectLookup, SortedLookup, TinyLookup

ROWS, PARTS = 3000, 3
COLUMNS = ["t", "d", "w", "f32", "f64"]
NULLS = ("d", "f32", "f64")  # columns that carry a validity mask


def make_part(seed, n=ROWS, shift=0):
    """A tiny int column (t: 40 values), a compact one (d: ~5,500 keys, a
    direct map), a wide one (w: ~5,000 keys spread over int32, a cuckoo
    table), float32 and float64 columns with repeats and ~5% NaN, a multihot
    list column; ``shift`` moves the ints out of the fitted keys."""
    r = np.random.default_rng(seed)
    f32 = (r.normal(0.0, 3.0, n).round(1) + 0.1 * shift).astype(np.float32)
    f32[r.random(n) < 0.05] = np.nan
    f64 = r.normal(0.0, 3.0, n).round(2) + 0.001 * shift
    f64[r.random(n) < 0.05] = np.nan
    lengths = r.integers(0, 5, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return {
        "t": (r.integers(0, 40, n) + shift).astype(np.int32),
        "d": (100_000 + r.integers(0, 8000, n) + shift).astype(np.int32),
        "w": (((r.integers(0, 9000, n) + shift) * 2654435761) % 2**31 - 2**30).astype(np.int32),
        "f32": f32,
        "f64": f64,
        "l": ((r.zipf(1.5, int(offsets[-1])) % 300 + shift).astype(np.int64), offsets),
    }


def batch(mod, part, columns, nulls=NULLS):
    """A TableBatch of ``mod`` (either package) holding ``columns``; those in
    ``nulls`` get ~10% invalid rows, (values, offsets) pairs are lists."""
    out = {}
    for k in columns:
        v = part[k]
        if isinstance(v, tuple):
            out[k] = mod.Column(*v)
        else:
            valid = np.random.default_rng(len(v) + len(k)).random(len(v)) > 0.1 if k in nulls else None
            out[k] = mod.Column(v, None, valid)
    return mod.TableBatch(out)


@pytest.fixture(scope="module")
def parts():
    return [make_part(s) for s in range(PARTS)]


def jax_state(jwf):
    """The JAX workflow's fitted Categorify state in convert's format."""
    state = {"categorify": {}}
    for node in jwf.graph.nodes:
        if isinstance(node.op, jops.Categorify):
            for key, v in node.op.vocabs.items():
                state["categorify"][key] = {
                    "values_by_code": np.asarray(v.values_by_code), "num_buckets": v.num_buckets, "offset": v.offset,
                }
    return state


def fit_both(graph, parts, columns, tmp_path, fitted_by):
    """(JAX workflow, port workflow) fitted on ``parts``; ``fitted_by`` =
    "jax_state" gives the port the JAX fit through convert."""
    jwf = jnvt.Workflow(graph(jops, out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([batch(jnvt, p, columns) for p in parts]))
    pwf = pnvt.Workflow(graph(pops), device="cpu")
    if fitted_by == "port":
        pwf.fit(pnvt.Dataset([batch(pnvt, p, columns) for p in parts]))
    else:
        pnvt.load_fitted_state(pwf, jax_state(jwf))
    return jwf, pwf


def assert_same_codes(pwf, jwf, part, columns):
    got = pwf.transform(batch(pnvt, part, columns))
    want = jwf.transform(batch(jnvt, part, columns)).to_host()
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = got[name].values.numpy(), np.asarray(want[name].values)
        assert g.dtype == w.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        if want[name].offsets is not None:
            np.testing.assert_array_equal(got[name].offsets.numpy(), np.asarray(want[name].offsets))
    return got


def assert_same_vocabs(pwf, jwf):
    want, got = jax_state(jwf)["categorify"], pnvt.fitted_state(pwf)["categorify"]
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key]["values_by_code"], ref["values_by_code"], err_msg=key)
        assert got[key]["num_buckets"] == ref["num_buckets"], key
        assert got[key]["offset"] == ref["offset"], key


def port_categorify(wf):
    return next(n.op for n in wf.graph.nodes if isinstance(n.op, pops.Categorify))


# --- whole workflows ---------------------------------------------------------------
CASES = {
    "buckets": dict(num_buckets=7),
    "buckets_per_column": dict(num_buckets={"t": 3, "w": 1000, "f32": 5}),
    "freq_max_size": dict(freq_threshold=2, max_size={"w": 500, "f64": 300, "t": 20}, num_buckets=6),
    "single_table": dict(num_buckets=4, single_table=True),
    "floats_one_bucket": dict(),
}


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
@pytest.mark.parametrize("case", list(CASES))
def test_categorify_matches_jax(parts, tmp_path, case, fitted_by):
    """Integer columns of every table kind and float32 / float64 columns
    (NaN and validity), with one or several OOV buckets, held against
    JitExecutor: seen rows and a probe of unseen values."""
    kw = CASES[case]

    def graph(ops, **extra):
        return COLUMNS >> ops.Categorify(**kw, **extra)

    jwf, pwf = fit_both(graph, parts, COLUMNS, tmp_path, fitted_by)
    assert_same_vocabs(pwf, jwf)
    for part in (parts[1], make_part(99, shift=3)):
        got = assert_same_codes(pwf, jwf, part, COLUMNS)
    if case == "buckets":  # every table kind is on the path, and misses spread over the buckets
        kinds = {type(v.lookup_struct()) for v in port_categorify(pwf).vocabs.values()}
        assert kinds == {TinyLookup, DirectLookup, CuckooLookup, SortedLookup}
        for name in ("w", "f64"):  # the probe's keys are all unseen there
            codes = got[name].values.numpy()
            assert len(np.unique(codes[(codes >= 2) & (codes < 9)])) == 7, name


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
def test_joint_group_and_lists_match_jax(parts, tmp_path, fitted_by):
    """A joint group of an int32 and a list column, one of two float64
    columns, each with its vocabulary's buckets; the list column keeps its
    offsets and takes the hashed miss with no null epilogue."""
    cols = ["t", "l", "f64", "g64", "w"]
    data = [dict(p, g64=p["f64"][::-1].copy()) for p in parts]

    def graph(ops, **extra):
        return [["t", "l"], ["f64", "g64"], "w"] >> ops.Categorify(num_buckets={"t_l": 5, "f64_g64": 9}, **extra)

    jwf, pwf = fit_both(graph, data, cols, tmp_path, fitted_by)
    assert sorted(port_categorify(pwf).vocabs) == ["f64_g64", "t_l", "w"]
    assert_same_vocabs(pwf, jwf)
    probe = make_part(7, shift=5)
    probe["g64"] = probe["f64"] * 2
    assert_same_codes(pwf, jwf, probe, cols)


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
@pytest.mark.parametrize("nb", [1, 5])
def test_float64_keys_that_share_a_float32(tmp_path, fitted_by, nb):
    """Two float64 keys that round to one float32: the reference's device
    path narrows its sorted vocabulary and the values to float32, so both
    take the code of the smaller key (a left search). The port narrows the
    same way after sorting in float64."""
    lo, hi = 1.0, 1.0 + 2.0**-40  # one float32, two float64 keys
    assert np.float32(lo) == np.float32(hi)
    vals = np.array([hi] * 5 + [lo] * 3 + [2.5] * 4 + [np.nan] * 2)
    part = {"x": vals}

    def graph(ops, **extra):
        return ["x"] >> ops.Categorify(num_buckets=nb, **extra)

    jwf, pwf = fit_both(graph, [part], ["x"], tmp_path, fitted_by)
    assert_same_vocabs(pwf, jwf)
    got = assert_same_codes(pwf, jwf, {"x": np.array([lo, hi, 2.5, np.nan, 7.0])}, ["x"])
    codes = got["x"].values.numpy()
    start = 2 + nb  # hi (5 rows) has the first code, 2.5 the second, lo the third
    assert codes[0] == codes[1] == start + 2
    assert codes[3] == 1


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
def test_signed_zeros(tmp_path, fitted_by):
    """-0.0 and 0.0 are two keys of the fit (arrow's value_counts counts
    bit patterns; the port counts by bits too) but one at the search: both
    take the code of the one first in value order, the more frequent 0.0
    (the stable sort keeps code order between equal keys)."""
    part = {"x": np.array([0.0] * 5 + [-0.0] * 2 + [1.0] * 3, dtype=np.float32)}

    def graph(ops, **extra):
        return ["x"] >> ops.Categorify(num_buckets=3, **extra)

    jwf, pwf = fit_both(graph, [part], ["x"], tmp_path, fitted_by)
    assert_same_vocabs(pwf, jwf)
    vocab = port_categorify(pwf).vocabs["x"].values_by_code
    assert vocab.tolist() == [0.0, 1.0, 0.0] and np.signbit(vocab).tolist() == [False, False, True]
    probe = np.array([-0.0, 0.0, 1.0, 1e-40, -1e-40, 2.0], dtype=np.float32)
    got = assert_same_codes(pwf, jwf, {"x": probe}, ["x"])
    assert got["x"].values.numpy()[:5].tolist() == [5, 5, 6, 5, 5]  # subnormals compare as zero (XLA)


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
@pytest.mark.parametrize("nb", [1, 5])
def test_empty_vocabularies(parts, tmp_path, fitted_by, nb):
    """No key reaches freq_threshold, and a float column is all NaN: every
    value misses (the hashed bucket of an int32 or float32 key) or is null."""
    cols = ["t", "f32", "nan"]
    data = [dict(p, nan=np.full(ROWS, np.nan, dtype=np.float32)) for p in parts]

    def graph(ops, **extra):
        return cols >> ops.Categorify(freq_threshold={"t": 10**6, "f32": 10**6}, num_buckets=nb, **extra)

    jwf, pwf = fit_both(graph, data, cols, tmp_path, fitted_by)
    assert all(len(v.values_by_code) == 0 for v in port_categorify(pwf).vocabs.values())
    got = assert_same_codes(pwf, jwf, data[0], cols)
    assert (got["nan"].values.numpy() == 1).all()


def test_schema_properties_match_jax(parts, tmp_path):
    """num_buckets (None for one bucket), domain and embedding sizes follow
    the vocabulary size 2 + nb + V."""

    def graph(ops, **extra):
        return ["t", "w", "f64"] >> ops.Categorify(num_buckets={"t": 1, "w": 12, "f64": 30}, **extra)

    jwf, pwf = fit_both(graph, parts, ["t", "w", "f64"], tmp_path, "port")
    want = {cs.name: cs.properties for cs in jwf.output_schema}
    for cs in pwf.output_schema:
        for prop in ("num_buckets", "domain", "embedding_sizes", "freq_threshold", "max_size"):
            assert cs.properties[prop] == want[cs.name][prop], (cs.name, prop)
    assert pops.get_embedding_sizes(pwf) == jops.get_embedding_sizes(jwf)
    assert pwf.output_schema["w"].properties["num_buckets"] == 12
    assert pwf.output_schema["t"].properties["num_buckets"] is None


def test_combo_buckets_still_raise():
    """The reference runs combo columns with several buckets on its host
    path (categorify.py:1336-1337), which is not ported."""
    with pytest.raises(NotImplementedError, match="item 4"):
        pops.Categorify(encode_type="combo", num_buckets={"a_b": 4})


def test_mixed_key_kinds_raise(tmp_path):
    """A float column against an integer vocabulary, and a joint group of
    an integer and a float column, name ROADMAP item 4."""
    pwf = pnvt.Workflow(["a"] >> pops.Categorify(), device="cpu")
    pwf.fit(pnvt.Dataset({"a": np.array([1, 2, 2], dtype=np.int32)}))
    with pytest.raises(NotImplementedError, match="item 4"):
        pwf.transform(pnvt.TableBatch.from_pydict({"a": np.array([1.0, 2.0], dtype=np.float32)}))
    joint = pnvt.Workflow([["a", "b"]] >> pops.Categorify(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 4"):
        joint.fit(pnvt.Dataset({"a": np.array([1, 2], dtype=np.int32), "b": np.array([1.0, 2.0])}))


# --- the plain versions against the reference's expressions ----------------------------
def _jax_oov(values, nb):
    """``_Vocab._oov_codes_dev`` (categorify.py:628-634) on the reference's
    device arrays (float64 narrows to float32 without x64)."""
    h = jdispatch.hash_array(jnp.asarray(values))
    return np.asarray((h % np.uint32(nb)).astype(jnp.int32) + 2)


def _values(dtype, r, n=4000):
    if dtype == np.int32:
        v = r.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        v[:4] = [-(2**31), 2**31 - 1, -1, 0]
        return v
    v = r.normal(0.0, 1e3, n).astype(dtype)
    v[:6] = [-0.0, 0.0, np.inf, -np.inf, 1e-40, -3.5]
    return v


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64], ids=["int32", "float32", "float64"])
def test_hashed_epilogue_matches_jax(dtype):
    """K4's hashed branch: a miss → 2 + hash_array(v) % nb, for int32 keys
    (bits and sign extension) and float keys (float32 bits), per column."""
    r = np.random.default_rng(3)
    vals = np.stack([_values(dtype, r), _values(dtype, r)])
    nbs = [1000, 1]
    values = torch.from_numpy(vals)
    if dtype == np.float64:
        values = values.to(torch.float32)  # the wrapper's narrowing, as the device path's
    n = vals.shape[1]
    hit = torch.zeros(values.shape, dtype=torch.bool)
    zero = torch.zeros(values.shape, dtype=torch.int32)
    got = klk._epilogue(zero, hit, None, torch.zeros(2, dtype=torch.int32), 2, 1, values,
                        torch.tensor(nbs, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got[0], _jax_oov(vals[0], nbs[0]))
    np.testing.assert_array_equal(got[1], np.full(n, 2))
    assert len(np.unique(got[0])) > 900  # a modulo, not a mask: all of 1000 buckets in reach


def _jax_searchsorted(sorted_values, sorted_codes, values, nb):
    """The searchsorted branch of ``_Vocab.encode_device``
    (categorify.py:570-584) on the reference's device arrays."""
    sv, sc = jnp.asarray(sorted_values), jnp.asarray(sorted_codes.astype(np.int32))
    vals = jnp.asarray(values).astype(sv.dtype)
    pos = jnp.clip(jnp.searchsorted(sv, vals, side="left"), 0, sv.shape[0] - 1)
    codes = jnp.where(sv[pos] == vals, sc[pos], _jax_oov(values, nb) if nb > 1 else 2)
    return np.asarray(jnp.where(jnp.isnan(jnp.asarray(values)), 1, codes))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("nb", [1, 13])
def test_sorted_lookup_plain_matches_jax(dtype, nb):
    """K8's plain version over two vocabularies in one table against the
    reference's per-column searchsorted: hits, misses below, between and
    above the keys, NaN, ±inf, signed zeros, a subnormal (XLA compares it as
    zero) and float64 keys that share a float32."""
    r = np.random.default_rng(5)
    vocabs = [np.unique(_values(dtype, r, 300))[::-1], np.array([2.5, -1.0, 0.0, 1.0 + 2.0**-40, 1.0], dtype)]
    vocabs = [v[~np.isnan(v)] for v in vocabs]
    start = 2 + nb
    luts = [SortedLookup(v, np.arange(len(v)) + start) for v in vocabs]
    table = BatchedSorted(luts)
    probe = np.concatenate([vocabs[0], vocabs[1], _values(dtype, r, 500), [np.nan, -0.0, 1e30, -1e30]])
    vals = np.stack([probe.astype(dtype), probe[::-1].astype(dtype)])
    got = klk.sorted_lookup(
        torch.from_numpy(vals).to(torch.float32), None, table.keys, table.codes, table.starts, table.lens,
        torch.tensor([0, 1], dtype=torch.int32), torch.zeros(2, dtype=torch.int32), nbuckets=torch.tensor(
            [nb, nb], dtype=torch.int32),
    ).numpy()
    for c, v in enumerate(vocabs):
        order = np.argsort(v, kind="stable")
        want = _jax_searchsorted(v[order], order + start, vals[c], nb)
        np.testing.assert_array_equal(got[c], want)


def test_sorted_lookup_plain_edges():
    """An empty vocabulary gives every value the OOV code with no search;
    one of length 1 hits only its key; validity and NaN give the null code;
    the column offset is added last."""
    luts = [SortedLookup(np.zeros(0, np.float32), np.zeros(0, np.int32)),
            SortedLookup(np.array([0.5], np.float32), np.array([3], np.int32))]
    t = BatchedSorted(luts)
    vals = torch.tensor([[0.5, -1.0, float("nan"), 0.5], [0.5, 0.6, float("nan"), 0.5]])
    valid = torch.tensor([[True, True, True, False], [True, True, True, True]])
    got = klk.sorted_lookup(vals, valid, t.keys, t.codes, t.starts, t.lens, torch.tensor([0, 1], dtype=torch.int32),
                            torch.tensor([0, 100], dtype=torch.int32))
    assert got.tolist() == [[2, 2, 1, 1], [103, 102, 101, 103]]


def _fence_vocabs(sizes, seed=11):
    r = np.random.default_rng(seed)
    return [SortedLookup(np.unique(r.normal(0.0, 100.0, n * 2))[:n] if n else np.zeros(0), np.arange(n) + 3)
            for n in sizes]


def _in_order_tree(sorted_fences, h):
    """The complete binary search tree of 2**h - 1 nodes over ``sorted_fences``
    (+inf past them) in breadth-first order, node k at [k], by an in-order
    walk."""
    tree = np.full(1 << h, np.inf, np.float32)
    entries = iter(np.concatenate([sorted_fences, np.full((1 << h) - 1 - len(sorted_fences), np.inf)]))

    def walk(k):
        if k < 1 << h:
            walk(2 * k)
            tree[k] = next(entries)
            walk(2 * k + 1)

    walk(1)
    return tree


@pytest.mark.parametrize("sizes", [[5], [0, 1, 7], [9_999, 0, 3, 70_000], [4 * klk.FENCE_MAX + 1, 2]],
                         ids=["one-row", "tiny-rows", "mixed", "wide-windows"])
def test_sorted_fences_are_each_windows_first_key(sizes):
    """K8's fences, built with the table: row b's windows of S = 2**shift
    slots start at base = starts[b] - starts[b] % 4; S is the least power of
    two >= 4 that leaves at most FENCE_MAX windows; fence j is the row's
    first key of window j (every S-th key from base, the first clamped to
    the row's start); they fill a complete binary search tree in
    breadth-first order from a multiple of 4 floats, +inf past them; an
    empty vocabulary gets none."""
    t = BatchedSorted(_fence_vocabs(sizes))
    keys, trees = t.keys.numpy(), t.fence_keys.numpy()
    assert t.fence_keys.dtype == torch.float32 and t.fence_starts.dtype == torch.int64
    assert t.fence_shifts.dtype == torch.int32 and t.fences == (t.fence_keys, t.fence_starts, t.fence_shifts)
    at = 0
    for b, n in enumerate(sizes):
        start, fs, shift = int(t.starts[b]), int(t.fence_starts[b]), int(t.fence_shifts[b])
        base = start - start % 4
        count = -(-(start - base + n) // (1 << shift)) if n else 0
        assert fs == at and fs % 4 == 0
        assert shift >= klk.FENCE_MIN_SHIFT and count <= klk.FENCE_MAX
        assert shift == klk.FENCE_MIN_SHIFT or -(-(start - base + n) // (1 << (shift - 1))) > klk.FENCE_MAX
        fences = keys[np.maximum(base + (np.arange(count) << shift), start)]
        if start % 4 == 0:
            np.testing.assert_array_equal(fences, keys[start : start + n : 1 << shift])
        if count == 0:
            continue
        h = count.bit_length()
        size = -(-(1 << h) // 4) * 4
        np.testing.assert_array_equal(trees[fs : fs + (1 << h)], _in_order_tree(fences, h))
        assert np.isposinf(trees[fs + (1 << h) : fs + size]).all()
        at = fs + size
    assert at == len(trees)


def test_sorted_fences_of_empty_vocabularies_and_on_a_device():
    """Empty vocabularies get no fences (an empty table none at all);
    ``to(device)`` carries the fences with the keys; the plain version
    takes the fences and gives the codes it gives without them."""
    empty = BatchedSorted(_fence_vocabs([0, 0]))
    assert empty.fence_keys.numel() == 0 and empty.fence_starts.tolist() == [0, 0]
    t = BatchedSorted(_fence_vocabs([300, 0, 41]))
    assert int(t.fence_starts[2]) == int(t.fence_starts[1])  # the empty row takes no room
    moved = t.to("cpu")
    for name in ("fence_keys", "fence_starts", "fence_shifts"):
        assert torch.equal(getattr(moved, name), getattr(t, name))
    vals = torch.from_numpy(np.concatenate([t.keys.numpy(), [np.nan, -5.0, 1e9]]).astype(np.float32))[None]
    vals = vals.expand(3, -1).contiguous()
    args = (vals, None, t.keys, t.codes, t.starts, t.lens, torch.arange(3, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32))
    assert torch.equal(klk.sorted_lookup(*args, fences=moved.fences), klk.sorted_lookup(*args))
    assert torch.equal(moved.encode(*args[:1], None, args[6], args[7]), klk.sorted_lookup(*args))
