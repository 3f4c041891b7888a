"""K6, the primary + stash lookup, against the JAX reference.

``build_stash`` must give the reference's packed table, ``nbp`` and ``nbs``
bit for bit; the plain version of ``stash_lookup`` (solo and batched, with
nulls, misses and hashed OOV buckets) the codes of ``StashLookup.encode_dev``
and ``BatchedStash.encode_dev`` on CPU-JAX; and a Categorify whose
vocabularies are given stash tables the reference's codes through its device
path (``JitExecutor(jit_min_rows=0)``). The CUDA kernel is held against the
plain version in test_torch_gpu.py.
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
from nvtabular_tpu.ops import lookup as jlookup
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.kernels import LAUNCHES
from nvtabular_tpu_torch.kernels import lookup as klk
from nvtabular_tpu_torch.ops import lookup as plookup

I32_MAX, I32_MIN = 2**31 - 1, -(2**31)
EXTREMES = (I32_MAX, I32_MIN, I32_MIN + 1, -I32_MAX, 0, -1)


def _keys(rng, size):
    keys = np.unique(rng.integers(I32_MIN, I32_MAX, size * 2 + 8, dtype=np.int64))[:size]
    if size >= 3:
        keys[:3] = [I32_MIN, I32_MAX, -1]
    return rng.permutation(np.unique(keys)).astype(np.int32)


@pytest.mark.parametrize(
    "n,load,spills",
    [(20_000, 0.5, True), (3_000, 0.05, False), (5_000, 2.0, True), (1, 0.5, False), (0, 0.5, False)],
    ids=["spills", "fits", "overfull_primary", "one_key", "empty"],
)
def test_build_stash_matches_reference(n, load, spills):
    """The primary's greedy placement, the stash's seeds and size and the
    packed layout [nbp + nbs, 8] equal the reference's bit for bit."""
    rng = np.random.default_rng(n)
    keys = _keys(rng, n)
    codes = np.arange(len(keys), dtype=np.int64) + 3
    got = plookup.build_stash(keys, codes, load)
    want = jlookup.build_stash(keys, codes, load)
    assert (got.nbp, got.nbs) == (want.nbp, want.nbs)
    assert got.nbp & (got.nbp - 1) == 0 and got.nbs & (got.nbs - 1) == 0
    assert (got.nbs > 0) == spills
    assert got.packed.dtype == np.int32 and got.packed.shape == (got.nbp + got.nbs, 8)
    np.testing.assert_array_equal(got.packed, want.packed)
    assert int((got.packed[:, 4:] >= 0).sum()) == len(keys)  # every key placed once


def test_build_stash_refuses_keys_outside_int32():
    keys = np.array([1, 2**31], dtype=np.int64)
    assert plookup.build_stash(keys, np.arange(2)) is None
    assert jlookup.build_stash(keys, np.arange(2)) is None


@pytest.mark.parametrize("nb", [50, 60, 130], ids=["fails", "evicts", "fits"])
def test_stash_cuckoo_build_matches_reference(nb):
    """The stash's cuckoo build with its eviction loop (the reference's
    generator, seeded 0): 200 keys in 50 buckets of 4 fail after 500
    evictions, in 60 (26 keys overflow their first choice) are placed by
    evictions, in 130 fit; both builds give the same table or both fail."""
    keys = _keys(np.random.default_rng(7), 200)
    vals = np.arange(200, dtype=np.int32) + 3
    got = plookup._try_build_cuckoo_numpy(keys, vals, nb, klk.STASH_SEEDS)
    want = jlookup._try_build_cuckoo_numpy(keys, vals, nb, seeds=(jlookup._SEED3, jlookup._SEED4))
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)


def _jax_oov(values, nb):
    """``_Vocab._oov_codes_dev`` (categorify.py:628-634): 2 + hash % nb."""
    h = jdispatch.hash_array(jnp.asarray(values))
    return np.asarray((h % np.uint32(nb)).astype(jnp.int32) + 2)


def _queries(rng, keysets, n):
    rows = []
    for keys in keysets:
        pick = rng.choice(keys, n) if len(keys) else rng.integers(-5, 5, n)
        miss = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64)
        v = np.where(rng.random(n) < 0.2, miss, pick).astype(np.int32)
        v[: len(EXTREMES)] = EXTREMES
        rows.append(v)
    return np.stack(rows)


def _reference(codes, validity, offsets):
    codes = np.asarray(codes)
    if validity is not None:
        codes = np.where(validity, codes, 1)
    return codes + np.asarray(offsets)[:, None]


def _stash_tables(rng):
    sizes_loads = [(20_000, 0.5), (5, 0.5), (3_000, 0.05), (6_000, 2.0)]
    keysets = [_keys(rng, n) for n, _ in sizes_loads]
    luts = [plookup.build_stash(k, np.arange(len(k)) + 3, load) for k, (_, load) in zip(keysets, sizes_loads)]
    assert [l.nbs > 0 for l in luts] == [True, False, False, True]
    return keysets, luts


@pytest.mark.parametrize("with_validity", [False, True])
@pytest.mark.parametrize("nb", [1, 1000])
def test_batched_stash_plain_matches_jax(with_validity, nb):
    """BatchedStash over stashed and stashless columns (sel repeats a row):
    hits in the primary and in the stash, misses (hashed into nb buckets
    where nb > 1), nulls and column offsets."""
    rng = np.random.default_rng(11 + nb)
    keysets, luts = _stash_tables(rng)
    sel = [3, 0, 1, 2, 0]
    values = _queries(rng, [keysets[s] for s in sel], 4000)
    validity = rng.random(values.shape) > 0.1 if with_validity else None
    offsets = [0, 9, 20_000, 30_000, 5]
    nbs = [nb, 1, nb, nb, 1]
    blut = plookup.BatchedStash(luts)
    got = blut.encode(
        torch.from_numpy(values), None if validity is None else torch.from_numpy(validity),
        torch.tensor(sel, dtype=torch.int32), torch.tensor(offsets, dtype=torch.int32),
        nbuckets=torch.tensor(nbs, dtype=torch.int32),
    ).numpy()

    jblut = jlookup.BatchedStash([jlookup.StashLookup(l.packed, l.nbp, l.nbs) for l in luts])
    miss = np.stack([_jax_oov(values[c], m) if m > 1 else np.full(values.shape[1], 2) for c, m in enumerate(nbs)])
    ref = jblut.encode_dev(jnp.asarray(jblut.concat), jnp.asarray(values), jnp.asarray(miss.astype(np.int32)),
                           sel=np.array(sel), stash_dev=jnp.asarray(jblut.stash_concat))
    np.testing.assert_array_equal(got, _reference(ref, validity, offsets))
    in_stash = np.isin(values[1], luts[0].packed[luts[0].nbp:, :4][luts[0].packed[luts[0].nbp:, 4:] >= 0])
    assert in_stash.any()  # the stash is probed and hit
    assert sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize("with_validity", [False, True])
def test_solo_stash_plain_matches_jax(with_validity):
    """One table row (a vocabulary encoding alone) against
    ``StashLookup.encode_dev``, for each of the stashed and stashless
    tables; every column taken alone, so a stashless table's placeholder
    stash row is read."""
    rng = np.random.default_rng(12)
    keysets, luts = _stash_tables(rng)
    for keys, lut in zip(keysets, luts):
        values = _queries(rng, [keys], 3000)
        validity = rng.random(values.shape) > 0.1 if with_validity else None
        got = plookup.BatchedStash([lut]).encode(
            torch.from_numpy(values), None if validity is None else torch.from_numpy(validity),
            torch.zeros(1, dtype=torch.int32), torch.tensor([4], dtype=torch.int32),
        ).numpy()
        jlut = jlookup.StashLookup(lut.packed, lut.nbp, lut.nbs)
        ref = jlut.encode_dev(jnp.asarray(lut.packed), jnp.asarray(values[0]), np.int32(2))
        np.testing.assert_array_equal(got, _reference(np.asarray(ref)[None], validity, [4]))


def test_stash_lookup_plain_finds_every_key_and_takes_empty_inputs():
    """Every key of a table with a stash finds its own code, in the primary
    or the stash; no values give an empty result."""
    rng = np.random.default_rng(13)
    keysets, luts = _stash_tables(rng)
    blut = plookup.BatchedStash(luts[:1])
    keys = torch.from_numpy(keysets[0][None])
    args = (blut.table, blut.nbps, blut.row_offsets)
    codes = klk.stash_lookup_plain(keys, None, *args, blut.stash, blut.nbss, blut.stash_offsets,
                                   torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    lut = luts[0]
    np.testing.assert_array_equal(np.sort(codes.numpy()[0]), np.arange(len(keysets[0])) + 3)
    empty = blut.encode(torch.zeros((1, 0), dtype=torch.int32), None, torch.zeros(1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32))
    assert empty.shape == (1, 0) and lut.nbs > 0


# --- a Categorify whose vocabularies are given stash tables ------------------------------------
COLUMNS = ["t", "w", "d"]


def _part(seed, n=6000):
    r = np.random.default_rng(seed)
    return {
        "t": r.integers(0, 40, n).astype(np.int32),
        "w": (((r.integers(0, 9000, n) + seed) * 2654435761) % 2**31 - 2**30).astype(np.int32),
        "d": (100_000 + r.integers(0, 8000, n) + seed).astype(np.int32),
    }


def _batch(mod, part):
    cols = {}
    for k, v in part.items():
        valid = np.random.default_rng(len(k)).random(len(v)) > 0.1 if k != "t" else None
        cols[k] = mod.Column(v, None, valid)
    return mod.TableBatch(cols)


def _categorify(wf, ops):
    return next(n.op for n in wf.graph.nodes if isinstance(n.op, ops.Categorify))


@pytest.mark.parametrize("solo", [False, True], ids=["batched", "solo"])
def test_categorify_with_stash_tables_matches_jax(tmp_path, solo):
    """Both packages fit the same data; then every vocabulary is given the
    stash table of its keys ascending (build_stash at load 0.5), the
    reference through ``lookup_struct``'s cache, the port through its own.
    The transform of seen and unseen rows gives the reference's codes, the
    port's columns in one BatchedStash launch or (``solo``) one a column."""
    parts = [_part(s) for s in range(3)]
    jwf = jnvt.Workflow(COLUMNS >> jops.Categorify(out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([_batch(jnvt, p) for p in parts]))
    pwf = pnvt.Workflow(COLUMNS >> pops.Categorify(out_path=str(tmp_path / "port")), device="cpu")
    pwf.fit(pnvt.Dataset([_batch(pnvt, p) for p in parts]))

    jcat, pcat = _categorify(jwf, jops), _categorify(pwf, pops)
    spilled = 0
    for key, jv in jcat.vocabs.items():
        jv._lookup = jlookup.build_stash(jv.sorted_values, jv.sorted_codes.astype(np.int32))
        jv._lookup_built = True
        pv = pcat.vocabs[key]
        pv.lookup_struct()
        pv._lookup = plookup.build_stash(pv._sv, pv._sc)
        np.testing.assert_array_equal(pv._lookup.packed, jv._lookup.packed)
        spilled += pv._lookup.nbs > 0
    assert spilled >= 2
    jcat._batched_cache = pcat._batched_cache = None
    if solo:
        pcat._solo_keys = lambda: set(pcat.vocabs)
    else:
        assert set(pcat._get_batched()) == {"stash"}

    for part in (parts[0], _part(99)):
        got = pwf.transform(_batch(pnvt, part))
        want = jwf.transform(_batch(jnvt, part)).to_host()
        for name in COLUMNS:
            np.testing.assert_array_equal(got[name].values.numpy(), np.asarray(want[name].values), err_msg=name)
