"""nvtabular_tpu_torch.parallel against nvtabular_tpu.parallel on the CPU.

Rank ``r`` of a gloo group of N spawned processes must return what device
``r`` of the JAX package's N-device mesh (the conftest's virtual CPU
devices) returns on the same inputs: the sharded vocabulary count's sorted
shards, overflow and counts, and the row-sharded lookups, bit for bit; the
bags and the sharded moments within the tolerances below. The kernels'
plain versions (K15a route and sort, K15b range gather and bag, K15c
partial moments) are held against the JAX functions' per-device bodies at
1, 2, 4 and 8 devices. The module imports no JAX at its top: the spawned
workers import it by name.
"""

import numpy as np
import pytest
import torch

from nvtabular_tpu_torch import parallel as par
from nvtabular_tpu_torch.convert import load_sharded_table
from nvtabular_tpu_torch.kernels import embedding as kemb
from nvtabular_tpu_torch.kernels import embedding_bag as kbag
from nvtabular_tpu_torch.kernels import exchange as kex
from nvtabular_tpu_torch.kernels import moments as kmom
from nvtabular_tpu_torch.parallel import multihost, sharded_vocab
from torch_groups import run_group

NDEVS = [1, 2, 4, 8]
WORLDS = [1, 2, 4]
# float32 sums of a shard in another order than XLA's (the bag: <= 4 terms a
# row; the moments: 4096 rows, then Chan's combine in float64)
BAG_TOL = dict(rtol=1e-6, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-5, atol=1e-6)
V, D, B, L = 64, 8, 32, 4


def _keys(case: str):
    """(keys, capacity factor) of the reference's tests
    (tests/unit/parallel/test_distributed_stats.py:39-127) at CPU size."""
    if case == "uniform":
        rng = np.random.default_rng(1)
        return rng.choice(rng.integers(-(1 << 30), 1 << 30, 500), 40_000).astype(np.int32), 2.5
    if case == "skew":  # one key: its owner overflows
        return np.full(8192, 42, dtype=np.int32), 0.1
    if case == "ragged":  # not a multiple of the mesh size
        return np.arange(1003, dtype=np.int32), 9.0
    if case == "powerlaw":  # Criteo-like popularity
        raw = np.random.default_rng(11).zipf(1.2, 200_000)
        return ((raw * 2654435761) % (1 << 22)).astype(np.int32), 2.5
    if case == "retry":  # one dominant key overflows the default capacity
        keys = np.zeros(200_000, dtype=np.int32)
        keys[:100] = np.arange(100, dtype=np.int32) + 1
        return keys, 2.5
    raise KeyError(case)


CASES = ["uniform", "skew", "ragged", "powerlaw", "retry"]


def _shards(keys: np.ndarray, ndev: int, factor: float):
    """The reference's padding and split (sharded_vocab.py:84-90): device
    d's keys, and the send capacity."""
    per = -(-len(keys) // ndev)
    padded = np.full(per * ndev, sharded_vocab._PAD, dtype=np.int32)
    padded[: len(keys)] = keys
    return [padded[d * per: (d + 1) * per] for d in range(ndev)], max(int(np.ceil(per * factor / ndev)), 8)


def _jax_mesh(n, axes=None):
    import jax

    from nvtabular_tpu.parallel import make_mesh

    return make_mesh(axes or {"data": -1}, devices=jax.devices()[:n])


def _jax_route(local: np.ndarray, ndev: int, cap: int):
    """The routing lines of the reference's exchange_and_sort
    (sharded_vocab.py:100-113) on one device's keys, jitted as there."""
    import jax

    send, overflow = jax.jit(_jax_route_body, static_argnums=(1, 2))(local, ndev, cap)
    return np.asarray(send), int(overflow)


def _jax_route_body(local, ndev, cap):
    import jax
    import jax.numpy as jnp

    from nvtabular_tpu.parallel.sharded_vocab import _PAD, _mix32

    is_pad = local == _PAD
    owner = jnp.where(is_pad, jnp.int32(0), _mix32(local, ndev))
    onehot = (owner[:, None] == jax.lax.broadcasted_iota(jnp.int32, (1, ndev), 1)).astype(jnp.int32)
    rank = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=1)
    overflow = jnp.sum((rank >= cap) & ~is_pad)
    row = jnp.where(is_pad | (rank >= cap), ndev, owner)
    send = jnp.full((ndev + 1, cap), _PAD, dtype=jnp.int32)
    send = send.at[row, jnp.minimum(rank, cap - 1)].set(jnp.where(is_pad, _PAD, local), mode="drop")
    return send[:ndev], overflow


def _jax_pass(keys, factor, ndev):
    """The reference's whole pass: (per-device sorted shards, overflow)."""
    from nvtabular_tpu.parallel.sharded_vocab import _exchange_sort_pass

    flat, shard_len, n, overflow = _exchange_sort_pass(keys, _jax_mesh(ndev), "data", factor)
    return [flat[d * shard_len: (d + 1) * shard_len] for d in range(n)], overflow


# --- K15a's plain versions against the reference's per-device body ---------------------
@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("case", CASES)
def test_exchange_plain_matches_jax_body(case, ndev):
    """Each device's send buffer and overflow bit-equal; the plain sort of
    what each owner receives (the all_to_all as a transpose) equals the
    reference's sorted shard."""
    keys, factor = _keys(case)
    shards, cap = _shards(keys, ndev, factor)
    sends, overflow = [], 0
    for local in shards:
        want_send, want_over = _jax_route(local, ndev, cap)
        send, over = kex.exchange_route(torch.from_numpy(local), ndev, cap)
        np.testing.assert_array_equal(send.numpy(), want_send)
        assert int(over[0]) == want_over
        sends.append(send)
        overflow += want_over
    want_sorted, want_overflow = _jax_pass(keys, factor, ndev)
    assert overflow == want_overflow
    recv = torch.stack(sends).transpose(0, 1).reshape(ndev, -1)  # recv[d] = sends[s][d] over s
    for d in range(ndev):
        np.testing.assert_array_equal(kex.radix_sort(recv[d].contiguous()).numpy(), want_sorted[d])
    if case == "skew" or (case == "retry" and ndev >= 4):
        assert want_overflow > 0  # the capacity is exceeded, as the reference's tests expect


def test_radix_sort_plain_orders_extremes():
    keys = torch.tensor([5, -1, 2**31 - 1, -(2**31), 0, 7, -7, 5], dtype=torch.int32)
    np.testing.assert_array_equal(kex.radix_sort(keys).numpy(), np.sort(keys.numpy()))


# --- K15b's plain versions against the reference's per-device bodies --------------------
def _table_and_ids():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, B).astype(np.int32)
    idx[:2] = [V + 3, -1]  # rows no shard holds read zeros
    vals = rng.integers(0, V, (B, L)).astype(np.int32)
    vals[0, 0] = V + 5
    mask = (rng.random((B, L)) < 0.7).astype(np.float32)
    return table, idx, vals, mask


@pytest.mark.parametrize("model", NDEVS)
def test_range_gather_and_bag_plain_match_jax_bodies(model):
    """Shard m's gather bit-equal to embeddings.py:40-49 and its bag to
    :73-80 within BAG_TOL; the shards' sums are the reference's outputs."""
    import jax.numpy as jnp

    table, idx, vals, mask = _table_and_ids()
    rows = V // model
    gathered = np.zeros((B, D), np.float32)
    bagged = np.zeros((B, D), np.float32)
    for m in range(model):
        local, start = table[m * rows: (m + 1) * rows], m * rows
        li = jnp.asarray(idx) - start
        in_range = (li >= 0) & (li < rows)
        want = np.asarray(jnp.where(in_range[:, None], jnp.take(local, jnp.clip(li, 0, rows - 1), axis=0), 0.0))
        got = kemb.embedding_range_gather(torch.from_numpy(local), torch.from_numpy(idx), start).numpy()
        np.testing.assert_array_equal(got, want)
        lv = jnp.asarray(vals) - start
        inr = (lv >= 0) & (lv < rows)
        emb = jnp.take(local, jnp.clip(lv, 0, rows - 1), axis=0)
        want_bag = np.asarray(jnp.sum(emb * (jnp.asarray(mask) * inr).astype(emb.dtype)[..., None], axis=1))
        got_bag = kbag.embedding_range_bag(torch.from_numpy(local), torch.from_numpy(vals), torch.from_numpy(mask),
                                           start).numpy()
        np.testing.assert_allclose(got_bag, want_bag, **BAG_TOL)
        gathered += got
        bagged += got_bag
    expect = np.where(((idx >= 0) & (idx < V))[:, None], table[np.clip(idx, 0, V - 1)], 0.0)
    np.testing.assert_array_equal(gathered, expect)
    w = mask * ((vals >= 0) & (vals < V))
    np.testing.assert_allclose(bagged, (table[np.clip(vals, 0, V - 1)] * w[..., None]).sum(1), **BAG_TOL)


# --- K15c's plain version against the reference's local_partials --------------------
def _moment_data():
    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 2.0, (4096, 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[:, 4] = np.nan  # an all-null column
    return x


@pytest.mark.parametrize("ndev", NDEVS)
def test_column_moments_plain_matches_jax_body(ndev):
    """stats.py:50-63 on each device's rows: count, min and max exact, mean
    and M2 within MOMENT_TOL."""
    import jax.numpy as jnp

    x = _moment_data()
    per = x.shape[0] // ndev
    for d in range(ndev):
        xs = jnp.asarray(x[d * per: (d + 1) * per])
        valid = ~jnp.isnan(xs)
        count = jnp.sum(valid, axis=0, dtype=jnp.int32)
        mean = jnp.sum(jnp.where(valid, xs, 0.0), axis=0) / jnp.maximum(count, 1).astype(xs.dtype)
        dd = jnp.where(valid, xs - mean, 0.0)
        want = (count, mean, jnp.sum(dd * dd, axis=0), jnp.min(jnp.where(valid, xs, jnp.inf), axis=0),
                jnp.max(jnp.where(valid, xs, -jnp.inf), axis=0))
        got = kmom.column_moments(torch.from_numpy(x[d * per: (d + 1) * per]))
        for i in (0, 3, 4):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        for i in (1, 2):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), **MOMENT_TOL)


# --- gloo groups of 1, 2 and 4 ranks against the JAX mesh of as many devices --------
def group_worker(rank, world):
    """Every parallel entry point on this rank's shard of the module's inputs."""
    mesh = par.local_mesh()
    out = {"passes": {}, "counts": {}}
    for case in CASES:
        keys, factor = _keys(case)
        shards, _cap = _shards(keys, world, factor)
        flat, shard_len, ndev, overflow = sharded_vocab._exchange_sort_pass(shards[rank], mesh, "data", factor)
        out["passes"][case] = (flat.numpy(), shard_len, ndev, overflow)
        counts, over = par.sharded_value_counts(shards[rank], mesh, "data", factor)
        out["counts"][case] = (counts, over)
        if case in ("powerlaw", "retry"):
            out["counts"][case + "_exact"] = sharded_vocab.sharded_value_counts_exact(shards[rank], mesh)
            out["counts"][case + "_arrays"] = sharded_vocab.sharded_value_counts_arrays(shards[rank], mesh)
    x = _moment_data()
    per = x.shape[0] // world
    out["moments"] = par.sharded_moments(x[rank * per: (rank + 1) * per], mesh)
    model = min(world, 2)
    emesh = par.make_mesh({"data": -1, "model": model})
    table, idx, vals, mask = _table_and_ids()
    d, m = rank // model, rank % model
    data_n = world // model
    b = B // data_n
    local = load_sharded_table(table, m, model, device="cpu")
    out["lookup"] = par.sharded_embedding_lookup(local, idx[d * b: (d + 1) * b], emesh).numpy()
    out["bag"] = par.sharded_embedding_bag(local, vals[d * b: (d + 1) * b], mask[d * b: (d + 1) * b], emesh).numpy()
    out["bag_sum"] = par.sharded_embedding_bag(local, vals[d * b: (d + 1) * b], mask[d * b: (d + 1) * b], emesh,
                                               combiner="sum").numpy()
    out["coords"] = (d, m, multihost.process_index(), multihost.process_count())
    out["gathered"] = multihost.allgather_pyobj({"rank": rank})
    try:
        par.make_mesh({"data": -1, "model": -1})
        out["two_wild"] = "no error"
    except ValueError as e:
        out["two_wild"] = str(e)
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("groups")
    return {world: run_group(group_worker, world, tmp) for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_value_counts_match_jax_devices(groups, world, case):
    """Rank r's sorted shard, the overflow and the gathered counts equal
    device r's, the reference's overflow and its counts."""
    from nvtabular_tpu.parallel.sharded_vocab import sharded_value_counts as jax_counts

    keys, factor = _keys(case)
    want_sorted, want_overflow = _jax_pass(keys, factor, world)
    want_counts, _ = jax_counts(keys, _jax_mesh(world), "data", factor)
    for rank, res in enumerate(groups[world]):
        flat, shard_len, ndev, overflow = res["passes"][case]
        assert (ndev, overflow) == (world, want_overflow)
        assert shard_len == len(want_sorted[rank])
        np.testing.assert_array_equal(flat, want_sorted[rank])
        counts, over = res["counts"][case]
        assert over == want_overflow and counts == want_counts
        if case in ("powerlaw", "retry"):
            from nvtabular_tpu.parallel.sharded_vocab import sharded_value_counts_arrays as jax_arrays

            vals, cnts = np.unique(keys, return_counts=True)
            assert res["counts"][case + "_exact"] == dict(zip(vals.tolist(), cnts.tolist()))
            got_v, got_c = res["counts"][case + "_arrays"]
            want_v, want_c = jax_arrays(keys, _jax_mesh(world))
            np.testing.assert_array_equal(got_v, want_v)
            np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_moments_match_jax(groups, world):
    from nvtabular_tpu.parallel.stats import sharded_moments as jax_moments

    want = jax_moments(_moment_data(), _jax_mesh(world))
    for res in groups[world]:
        got = res["moments"]
        for k in ("count", "min", "max"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("mean", "var", "std"):
            np.testing.assert_allclose(got[k], want[k], **MOMENT_TOL, err_msg=k)
        assert got["count"][4] == 0 and got["mean"][4] == 0.0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_embeddings_match_jax(groups, world):
    """Rank (d, m) of the (data, model) mesh holds model shard m of the
    table and data shard d of the ids: the lookup equals the reference's
    rows of data shard d bit for bit, the bags within BAG_TOL."""
    from nvtabular_tpu.parallel.embeddings import sharded_embedding_bag, sharded_embedding_lookup

    model = min(world, 2)
    mesh = _jax_mesh(world, {"data": -1, "model": model})
    table, idx, vals, mask = _table_and_ids()
    want = np.asarray(sharded_embedding_lookup(table, idx, mesh))
    want_bag = np.asarray(sharded_embedding_bag(table, vals, mask, mesh))
    want_sum = np.asarray(sharded_embedding_bag(table, vals, mask, mesh, combiner="sum"))
    b = B // (world // model)
    for res in groups[world]:
        d, m, rank, count = res["coords"]
        assert count == world and (d, m) == (rank // model, rank % model)
        rows = slice(d * b, (d + 1) * b)
        np.testing.assert_array_equal(res["lookup"], want[rows])
        np.testing.assert_allclose(res["bag"], want_bag[rows], **BAG_TOL)
        np.testing.assert_allclose(res["bag_sum"], want_sum[rows], **BAG_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_group_objects_and_mesh_rules(groups, world):
    for rank, res in enumerate(groups[world]):
        assert res["gathered"] == [{"rank": r} for r in range(world)]
        assert res["two_wild"] == "at most one axis may be -1"


# --- no process group ----------------------------------------------------------------------
def test_one_process_without_a_group():
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    obj = {"a": np.arange(3)}
    assert multihost.allgather_pyobj(obj)[0] is obj
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        par.local_mesh()
    keys, counts = np.array([3, 1], np.int64), np.array([2, 5], np.int64)
    assert sharded_vocab.exchange_partial_counts(keys, counts)[0] is not None
    lanes = np.arange(6, dtype=np.int32).reshape(3, 2)
    np.testing.assert_array_equal(sharded_vocab.exchange_keyed_rows(lanes, np.zeros(3)), lanes)


def test_default_backend_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        par.initialize_distributed()


def test_string_exchange_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 4"):
        sharded_vocab.exchange_partial_string_counts(np.array(["a"], dtype=object), np.array([1]))


def test_load_sharded_table_rows():
    table = np.arange(24, dtype=np.float32).reshape(8, 3)
    np.testing.assert_array_equal(load_sharded_table(table, 2, 4, device="cpu").numpy(), table[4:6])
    with pytest.raises(ValueError):
        load_sharded_table(table, 0, 3, device="cpu")
