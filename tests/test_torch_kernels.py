"""Kernel modules of nvtabular_tpu_torch against the JAX reference.

The plain PyTorch versions of the lookup kernels (K1-K3 with the K4
epilogue) must give the JAX ``Batched*.encode_dev`` codes bit for bit on the
same tables and values; the plain continuous chain (K5) must match the JAX
ops' chain within a stated tolerance. The CUDA kernels are held against
these plain versions in test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvtabular_tpu.ops import Clip as JClip
from nvtabular_tpu.ops import FillMissing as JFill
from nvtabular_tpu.ops import LogOp as JLog
from nvtabular_tpu.ops import Normalize as JNormalize
from nvtabular_tpu.ops import lookup as jlookup
from nvtabular_tpu.selector import ColumnSelector as JSelector
from nvtabular_tpu.table import Column as JColumn
from nvtabular_tpu.table import TableBatch as JTableBatch
from nvtabular_tpu_torch.kernels import LAUNCHES, cont_chain as kcc, lookup as klk
from nvtabular_tpu_torch.kernels import embedding as kemb
from nvtabular_tpu_torch.kernels import interaction as kint
from nvtabular_tpu_torch.kernels import permute as kperm
from nvtabular_tpu_torch.ops import lookup as plookup
from nvtabular_tpu_torch.table import Column as PColumn

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)


def _reference_codes(codes, validity, col_offsets):
    """K4 epilogue on the JAX side: nulls → 1, then + column offset
    (nvtabular_tpu/ops/categorify.py:1666-1684)."""
    codes = np.asarray(codes)
    if validity is not None:
        codes = np.where(validity, codes, 1)
    return codes + np.asarray(col_offsets)[:, None]


def _values(rng, keysets, n, extra=()):
    """[C, N] int32 queries: mostly vocabulary keys, some misses and
    int32 extremes."""
    rows = []
    for keys in keysets:
        pick = rng.choice(keys, n) if len(keys) else rng.integers(-5, 5, n)
        miss = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64)
        v = np.where(rng.random(n) < 0.2, miss, pick).astype(np.int32)
        v[: len(extra)] = extra
        rows.append(v)
    return np.stack(rows)


def _inputs(values, validity, sel, offsets):
    return (
        torch.from_numpy(values),
        None if validity is None else torch.from_numpy(validity),
        torch.tensor(sel, dtype=torch.int32),
        torch.tensor(offsets, dtype=torch.int32),
    )


EXTREMES = (I32_MAX, I32_MIN, I32_MIN + 1, -I32_MAX, 0, -1)


@pytest.mark.parametrize("with_validity", [False, True])
def test_tiny_plain_matches_jax(with_validity):
    rng = np.random.default_rng(0)
    sizes = [1, 7, 600, 4096, 0]
    keysets = []
    for i, size in enumerate(sizes):
        keys = np.unique(rng.integers(I32_MIN, I32_MAX, size * 2, dtype=np.int64))[:size]
        if i == 1:
            keys[:2] = [I32_MIN + 1, I32_MAX]  # the int32 extremes as keys
        keysets.append(rng.permutation(keys).astype(np.int32))
    luts = [plookup.TinyLookup(k, np.arange(len(k), dtype=np.int32) + 3) for k in keysets]
    blut = plookup.BatchedTiny(luts)
    assert int(blut.keys.shape[1]) == 4096  # shorter rows are padded (first key repeated)
    sel = [4, 0, 2, 1, 3, 2]
    values = _values(rng, [keysets[s] for s in sel], 3000, EXTREMES)
    validity = rng.random(values.shape) > 0.1 if with_validity else None
    offsets = [0, 10, 20, 700, 5000, 9000]

    got = blut.encode(*_inputs(values, validity, sel, offsets)).numpy()

    jblut = jlookup.BatchedTiny([jlookup.TinyLookup(l.keys, l.codes) for l in luts])
    ref = jblut.encode_dev(jnp.asarray(jblut.concat), jnp.asarray(values), 2, sel=np.array(sel))
    np.testing.assert_array_equal(got, _reference_codes(ref, validity, offsets))


@pytest.mark.parametrize("with_validity", [False, True])
def test_direct_plain_matches_jax(with_validity):
    rng = np.random.default_rng(1)
    ranges = [(I32_MAX - 6000, I32_MAX), (I32_MIN, I32_MIN + 9000), (-3000, 5000), (10**6, 10**6 + 20000)]
    keysets, luts = [], []
    for lo, hi in ranges:
        keys = rng.choice(np.arange(lo, hi + 1, dtype=np.int64), (hi - lo) // 2, replace=False)
        keys = np.concatenate([keys, [lo, hi]]).astype(np.int64)
        keys = np.unique(keys)
        keysets.append(keys.astype(np.int32))
        lut = plookup.build_direct(rng.permutation(keys), np.arange(len(keys)) + 3)
        assert isinstance(lut, plookup.DirectLookup)
        luts.append(lut)
    blut = plookup.BatchedDirect(luts)
    sel = [0, 1, 2, 3, 1]
    values = _values(rng, [keysets[s] for s in sel], 4000, EXTREMES)
    values[:, 10] = values[:, 11] - 1  # around the ranges' edges
    validity = rng.random(values.shape) > 0.1 if with_validity else None
    offsets = [0, 3, 11, 19, 100]

    got = blut.encode(*_inputs(values, validity, sel, offsets)).numpy()

    jluts = [jlookup.DirectLookup(l.min_key, l.max_key, l.table) for l in luts]
    jblut = jlookup.BatchedDirect(jluts)
    miss = np.full(values.shape, 2, dtype=np.int32)
    ref = jblut.encode_dev(jnp.asarray(jblut.concat), jnp.asarray(values), miss, sel=np.array(sel))
    np.testing.assert_array_equal(got, _reference_codes(ref, validity, offsets))


@pytest.mark.parametrize("with_validity", [False, True])
def test_cuckoo_plain_matches_jax(with_validity):
    rng = np.random.default_rng(2)
    keysets, luts = [], []
    for size in (5000, 20000, 4097):
        keys = np.unique(rng.integers(I32_MIN, I32_MAX, size * 2, dtype=np.int64))[:size]
        keys[:3] = [I32_MIN, I32_MAX, -1]
        keys = rng.permutation(np.unique(keys)).astype(np.int32)
        keysets.append(keys)
        luts.append(plookup.build_cuckoo(keys, np.arange(len(keys)) + 3))
    blut = plookup.BatchedCuckoo(luts)
    sel = [2, 0, 1, 0]
    values = _values(rng, [keysets[s] for s in sel], 5000, EXTREMES)
    validity = rng.random(values.shape) > 0.1 if with_validity else None
    offsets = [0, 7, 5000, 40000]

    got = blut.encode(*_inputs(values, validity, sel, offsets)).numpy()

    jblut = jlookup.BatchedCuckoo([jlookup.CuckooLookup(l.packed, l.nb) for l in luts])
    miss = np.full(values.shape, 2, dtype=np.int32)
    ref = jblut.encode_dev(jnp.asarray(jblut.concat), jnp.asarray(values), miss, sel=np.array(sel))
    np.testing.assert_array_equal(got, _reference_codes(ref, validity, offsets))


def test_cuckoo_build_places_every_key():
    """The vectorized eviction build holds every key at load 0.8, with the
    reference's hash (JAX CuckooLookup.encode_np reads the same table)."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(I32_MIN, I32_MAX, 120_000, dtype=np.int64))[:100_000]
    keys = rng.permutation(keys).astype(np.int32)
    codes = np.arange(len(keys), dtype=np.int32) + 3
    lut = plookup.build_cuckoo(keys, codes)
    assert lut.nb == int(np.ceil(len(keys) / (4 * plookup.CUCKOO_LOAD)))
    assert (lut.packed[:, 4:] >= 0).sum() == len(keys)
    got = jlookup.CuckooLookup(lut.packed, lut.nb).encode_np(keys, np.int32(2))
    np.testing.assert_array_equal(got, codes)


def test_fmix32_plain_matches_numpy_uint32():
    rng = np.random.default_rng(4)
    u = rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    u[:4] = [0, 1, 2**31, 2**32 - 1]
    ref = jlookup._mix32_np(u, np.uint32(0x9E3779B9))
    got = klk.fmix32_plain(torch.from_numpy(u.astype(np.int64)) ^ 0x9E3779B9)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_build_lookup_kind_choice():
    n = np.arange
    assert isinstance(plookup.build_lookup(n(4096), n(4096) + 3), plookup.TinyLookup)
    assert isinstance(plookup.build_lookup(n(5000) * 3, n(5000) + 3), plookup.DirectLookup)
    wide = (n(5000, dtype=np.int64) * 2654435761) % 2**31
    assert isinstance(plookup.build_lookup(wide, n(5000) + 3), plookup.CuckooLookup)
    with pytest.raises(NotImplementedError, match="int32"):
        plookup.build_lookup(np.array([0, 2**40]), np.array([3, 4]))


def _jax_chain(x, validity, names, means, stds, clip_hi=None):
    """The reference's continuous ops, op by op on jax arrays."""
    batch = JTableBatch()
    for i, name in enumerate(names):
        batch[name] = JColumn(
            jnp.asarray(x[i]), None, None if validity is None else jnp.asarray(validity[i])
        )
    sel = JSelector(names)
    norm = JNormalize()
    norm.means, norm.stds, norm.fitted = dict(zip(names, means)), dict(zip(names, stds)), True
    for op in (JFill(fill_val=0.5), JClip(min_value=0.0, max_value=clip_hi), JLog(), norm):
        batch = op.transform(sel, batch)
    return np.stack([np.asarray(batch[n].values) for n in names])


@pytest.mark.parametrize("with_validity", [False, True])
def test_cont_chain_plain_matches_jax(with_validity):
    """rtol=1e-5, atol=1e-6: log1p differs by a few float32 ULPs between
    XLA's and PyTorch's CPU implementations (the engine-difference class of
    the JAX package's own host and device paths)."""
    rng = np.random.default_rng(5)
    C, N = 4, 5000
    x = rng.normal(1.0, 3.0, (C, N)).astype(np.float32)
    x[rng.random((C, N)) < 0.05] = np.nan
    x[0, :3] = [-0.0, np.inf, -np.inf]
    validity = rng.random((C, N)) > 0.1 if with_validity else None
    names = [f"I{i}" for i in range(C)]
    means = [0.7, -0.2, 1.5, 0.0]
    stds = [1.3, 0.0, 2.0, 0.4]  # std 0: subtract only
    ref = _jax_chain(x, validity, names, means, stds, clip_hi=9.0)

    flags = torch.full((C,), kcc.FILL | kcc.LO | kcc.HI | kcc.LOG | kcc.NORM, dtype=torch.int32)
    params = torch.tensor(
        [[0.5, 0.0, 9.0, m, s if s > 0 else 1.0] for m, s in zip(means, stds)], dtype=torch.float32
    )
    got = kcc.cont_chain(
        torch.from_numpy(x), None if validity is None else torch.from_numpy(validity), params, flags
    ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_cpu_wrappers_launch_nothing():
    before = dict(LAUNCHES)
    luts = [plookup.TinyLookup(np.array([5, 9], dtype=np.int32), np.array([3, 4], dtype=np.int32))]
    plookup.BatchedTiny(luts).encode(*_inputs(np.array([[5, 9, 1]], np.int32), None, [0], [0]))
    assert LAUNCHES == before


def test_permute_rows_plain_edge_cases():
    """Empty arrays, 2-d rows, int32 permutations; wrong shapes raise."""
    empty = kperm.permute_rows({"a": torch.zeros(0, dtype=torch.int32)}, torch.zeros(0, dtype=torch.int64))
    assert empty["a"].shape == (0,)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    got = kperm.permute_rows({"x": x}, torch.tensor([3, 0, 2, 1], dtype=torch.int32))["x"]
    assert torch.equal(got, x[[3, 0, 2, 1]])
    with pytest.raises(ValueError, match="rows"):
        kperm.permute_rows({"x": x}, torch.tensor([0, 1]))
    with pytest.raises(TypeError, match="perm"):
        kperm.permute_rows({"x": x}, torch.tensor([0.0, 1.0, 2.0, 3.0]))


def test_embedding_plain_edge_cases():
    """Ids outside a column's rows never read a neighbour's rows: a NaN row
    and no gradient, as jnp.take; a zero-size column reads only NaN."""
    table = torch.arange(10, dtype=torch.float32)[:, None].repeat(1, 4)  # row r holds r
    offsets, sizes = [0, 3, 9], [3, 6, 0]
    ids = [torch.tensor(v, dtype=torch.int32) for v in ([0, -1, 3], [5, -6, 6], [0, -1, 5])]
    got = kemb.embedding_gather(table, ids, offsets, sizes)
    nan = float("nan")
    want = [[0.0, 8.0, nan], [2.0, 3.0, nan], [nan, nan, nan]]  # [b, column]
    torch.testing.assert_close(got[:, :, 0], torch.tensor(want), equal_nan=True)
    grad = torch.ones((3, 3, 4))
    dtable = kemb.embedding_scatter_grad(grad, ids, offsets, sizes, 10)
    assert dtable[:, 0].tolist() == [1.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    with pytest.raises(ValueError, match="outside the table"):
        kemb.embedding_gather(table, ids, [0, 3, 8], [3, 6, 3])
    with pytest.raises(TypeError, match="int32"):
        kemb.embedding_gather(table, [ids[0].long()], [0], [3])


def test_interaction_plain_edge_cases():
    """One feature has no pairs; the pair order is np.tril_indices(F, -1)."""
    assert kint.interaction_fwd(torch.ones((2, 1, 3))).shape == (2, 0)
    x = torch.zeros((1, 4, 2))
    x[0, :, 0] = torch.tensor([1.0, 2.0, 3.0, 5.0])
    got = kint.interaction_fwd(x)[0].tolist()
    rows, cols = np.tril_indices(4, -1)
    assert got == [float(x[0, i, 0] * x[0, j, 0]) for i, j in zip(rows, cols)]
    buf = torch.full((1, 2 + 6), -1.0)
    kint.interaction_fwd(x, out=buf[:, 2:])
    assert buf[0, :2].tolist() == [-1.0, -1.0] and buf[0, 2:].tolist() == got
    with pytest.raises(ValueError, match="expected float32"):
        kint.interaction_fwd(x, out=torch.empty((1, 5)))


@pytest.mark.parametrize("kind", ["tiny", "direct", "cuckoo"])
def test_group_index_plain_matches_jax(kind):
    """K1-K3 with a group index's codes: hits give the group row, misses and
    null keys the pad slot num_groups (KeyedStats.device_group_index,
    nvtabular_tpu/ops/groupby_stats.py:590-610)."""
    from nvtabular_tpu.ops.groupby_stats import KeyedStats as JKeyed
    from nvtabular_tpu_torch.ops.groupby_stats import KeyedStats as PKeyed

    rng = np.random.default_rng(15)
    size = {"tiny": 300, "direct": 5000, "cuckoo": 5000}[kind]
    if kind == "cuckoo":
        keys = np.unique(rng.integers(I32_MIN, I32_MAX, 2 * size, dtype=np.int64))[:size]
    else:
        keys = rng.choice(np.arange(-1000, 20_000, dtype=np.int64), size, replace=False)
    keys = rng.permutation(keys)
    stats = {"x.sum": rng.random(size)}
    ported = PKeyed(["k"], stats, {"k": keys})
    assert plookup.kind_of(ported.lookup_struct()) == kind
    queries = _values(rng, [keys], 4000, EXTREMES)[0]
    validity = rng.random(len(queries)) > 0.1
    got = ported.group_index("cpu")(PColumn(queries, None, validity)).numpy()
    ref = JKeyed(["k"], stats, keys, {"k": keys}).device_group_index(
        "test", [JColumn(jnp.asarray(queries), None, jnp.asarray(validity))]
    )
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert (got[~validity] == size).all()


def test_te_encode_plain_edge_cases():
    """The pad slot and a group whose out-of-fold count is 0 read the target
    mean when p_smooth is 0; no group or no row gives an empty result."""
    from nvtabular_tpu_torch.kernels import groupby as kgb

    st = kgb.TEState(
        sums=torch.tensor([6.0, 4.0, 0.0]), counts=torch.tensor([3.0, 2.0, 0.0]),
        stat_off=torch.tensor([0]), fsums=torch.tensor([6.0, 0.0, 0.0, 0.0, 4.0, 0.0]),
        fcnts=torch.tensor([3.0, 0.0, 0.0, 0.0, 2.0, 0.0]), fold_off=torch.tensor([0]),
        strides=torch.tensor([3]), means=torch.tensor([1.5]), p_smooth=0.0, kfold=2, fold_seed=42,
    )
    gidx = torch.tensor([[0, 1, 2, 0, 1, 2]], dtype=torch.int32)
    folds = kgb.fold_ids_plain(0, 6, 2, 42).tolist()
    want = []
    for g, f in zip([0, 1, 2, 0, 1, 2], folds):
        c = [3.0, 2.0, 0.0][g] - (3.0 if (f, g) == (0, 0) else 2.0 if (f, g) == (1, 1) else 0.0)
        s = [6.0, 4.0, 0.0][g] - (6.0 if (f, g) == (0, 0) else 4.0 if (f, g) == (1, 1) else 0.0)
        want.append(s / c if c > 0 else 1.5)
    assert kgb.te_encode(gidx, st, 0)[0].tolist() == want
    assert kgb.te_encode(gidx[:, :0], st, 0).shape == (1, 0)
    with pytest.raises(ValueError, match="row_offset"):
        kgb.te_encode(gidx, st, -1)


def test_stat_gather_plain_edge_cases():
    from nvtabular_tpu_torch.kernels import groupby as kgb

    gidx = torch.tensor([[0, 2, 1], [1, 1, 0]], dtype=torch.int32)
    st = kgb.GatherState(
        itable=torch.tensor([7, 8, 0], dtype=torch.int32), ftable=torch.tensor([0.5, 1.5, float("nan"), 9.0, 9.5]),
        groups=torch.tensor([0, 0, 1], dtype=torch.int32), offs=torch.tensor([0, 0, 3]), ki=1,
    )
    ints, floats = kgb.stat_gather(gidx, st)
    assert ints.tolist() == [[7, 0, 8]]
    torch.testing.assert_close(floats, torch.tensor([[0.5, float("nan"), 1.5], [9.5, 9.5, 9.0]]), equal_nan=True)
    none = kgb.GatherState(st.itable, st.ftable, st.groups[:0], st.offs[:0], 0)
    assert [t.shape for t in kgb.stat_gather(gidx, none)] == [(0, 3), (0, 3)]
    with pytest.raises(ValueError, match="ki"):
        kgb.stat_gather(gidx, kgb.GatherState(st.itable, st.ftable, st.groups, st.offs, 4))


def test_hash_and_bucketize_plain_edge_cases():
    """hashed_cross widens bools and small ints to int32 and narrows float64
    to float32 (the reference's device lanes); ``num_buckets`` must fit
    uint32. No bound puts every value in bucket 0."""
    from nvtabular_tpu_torch.kernels import bucketize as kbkt
    from nvtabular_tpu_torch.kernels import hash as khash

    b = torch.tensor([True, False, True])
    assert torch.equal(khash.hashed_cross([b], 97), khash.hashed_cross([b.to(torch.int32)], 97))
    x = torch.tensor([0.1, -2.5, 1e30], dtype=torch.float64)
    assert torch.equal(khash.hashed_cross([x], None), khash.hashed_cross([x.float()], None))
    assert khash.hashed_cross([b], None).dtype == torch.int64
    with pytest.raises(ValueError, match="num_buckets"):
        khash.hashed_cross([b], 2**32)
    with pytest.raises(ValueError, match="at least one"):
        khash.hashed_cross([], 5)
    assert kbkt.bucketize(x, torch.zeros(0, dtype=torch.float64)).tolist() == [0, 0, 0]
    with pytest.raises(TypeError):
        kbkt.bucketize(x, torch.zeros(1))


def test_new_cpu_wrappers_launch_nothing():
    from nvtabular_tpu_torch.kernels import bucketize as kbkt
    from nvtabular_tpu_torch.kernels import hash as khash

    before = dict(LAUNCHES)
    x = torch.arange(10, dtype=torch.float32)
    khash.hashed_cross([x], 7)
    khash.fold_ids(0, 10, 3, 42, "cpu")
    kbkt.bucketize(x, torch.tensor([3.0]))
    assert LAUNCHES == before
