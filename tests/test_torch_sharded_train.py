"""DLRM training on row-sharded tables: nvtabular_tpu_torch against the JAX
package on the CPU.

Kernel K15d's plain versions (``range_gather_columns`` and
``range_scatter_grad``, what the CPU runs in place of the CUDA kernels) are
held against ``jnp.take`` of P("model", None)-sharded tables on a mesh of 1,
2 and 4 virtual devices and against its ``jax.vjp``. ``vocab_pad_multiple >
1`` is held against the JAX forward and three optax Adagrad steps on one
device for DLRM, DeepFM and DCN-v2. Gloo groups of 1, 2 and 4 spawned ranks
(data 1 x model 1, 1 x 2 and 2 x 2) run ``shard_params``, ``shard_batch``
and ``make_train_step`` with JAX's parameters carried across by
``convert``, against the JAX ``make_train_step`` on the mesh of the same
shape: losses at rtol 1e-5, the tables stacked from the ranks at rtol 1e-5,
atol 1e-6, the accumulators at rtol 1e-5 (``test_torch_loader.py``'s
limits: bfloat16 MLPs on both sides, float32 sums in another order). The
module imports no JAX at its top: the spawned workers import it by name.
"""

import numpy as np
import pytest
import torch

import nvtabular_tpu_torch as pnvt
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch import parallel as par
from nvtabular_tpu_torch.convert import load_sharded_table
from nvtabular_tpu_torch.kernels import embedding as kemb
from nvtabular_tpu_torch.parallel.mesh import mesh_device
from torch_groups import run_group

# three tables, padded to a multiple of the model axis's 2 ranks
CARDS = {"a": 1001, "b": 499, "c": 7}
NUM_DENSE, BATCH, STEPS, LR, PAD = 4, 64, 3, 1e-2, 2
MODEL_KW = dict(embedding_dim=8, bottom_mlp=(16,), top_mlp=(16,), vocab_pad_multiple=PAD)
SHAPES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}  # world -> (data, model)
LOSS_TOL = dict(rtol=1e-5)
TABLE_TOL = dict(rtol=1e-5, atol=1e-6)
ACC_TOL = dict(rtol=1e-5)
# the row-sharded lookup's gradient: sums of a few float32 terms in another order
LOOKUP_TOL = dict(rtol=1e-6, atol=1e-6)
V, D, B = 64, 8, 32


def t(a):
    return torch.from_numpy(np.array(a))


def step_batch(seed=3):
    """A global batch whose ids include a padding row (V) and ids that wrap
    by the padded size Vp (-1 to the padding row Vp - 1, -Vp to row 0)."""
    batch = pmodels.make_synthetic_batch(pmodels.DLRMConfig(CARDS, NUM_DENSE, **MODEL_KW), BATCH, seed=seed)
    batch["a"][:3] = [1001, -1, -1002]
    batch["c"][5:7] = [7, -8]
    return batch


def lookup_inputs():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, B).astype(np.int32)
    idx[:2] = [V + 3, -1]  # no shard holds these: zeros, no gradient
    ct = rng.normal(size=(B, D)).astype(np.float32)
    return table, idx, ct


# --- the spawned ranks ---------------------------------------------------------------------
def train_worker(rank, world, model_size, params, batch, steps=STEPS):
    """``steps`` sharded Adagrad steps of one global batch on this rank's
    shard; its tables, accumulators, MLPs and eval logits after them."""
    mesh = par.local_mesh(model=model_size)
    dev = mesh_device(mesh)
    config = pmodels.DLRMConfig(CARDS, NUM_DENSE, **MODEL_KW)
    model = pmodels.DLRM(config, device=dev)
    p_specs, b_specs = pmodels.dlrm_param_specs(model), pmodels.batch_specs(config)
    par.shard_params(model, p_specs, mesh)
    opt = pmodels.Adagrad(model.parameters(), lr=LR)
    pnvt.load_dlrm_params(model, params)
    step = par.make_train_step(pmodels.dlrm_loss, opt, mesh=mesh, param_specs=p_specs, batch_specs=b_specs)
    local = par.shard_batch(batch, b_specs, mesh)
    losses = [float(step(model, opt, local)) for _ in range(steps)]
    acc = opt.accumulator(model.table).detach().cpu().numpy()
    out = {
        "coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model")),
        "rows": int(local["label"].shape[0]),
        "losses": losses,
        "params": pnvt.dlrm_params(model),
        "acc": {n: acc[o : o + s] for n, o, s in zip(model.names, model.offsets, model.sizes)},
        "logits": par.make_eval_step(pmodels.DLRM.forward, mesh)(model, local).cpu().numpy(),
    }
    if dev.type == "cpu":
        table, idx, ct = lookup_inputs()
        d, m = out["coords"]
        b = B // mesh.get_group("data").size()
        local_table = load_sharded_table(table, m, model_size, device="cpu").requires_grad_(True)
        looked = par.sharded_embedding_lookup(local_table, idx[d * b : (d + 1) * b], mesh)
        (looked * t(ct[d * b : (d + 1) * b])).sum().backward()
        out["lookup"] = looked.detach().numpy()
        out["lookup_grad"] = local_table.grad.numpy()
    return out


# --- the JAX side, in this process only ------------------------------------------------------
def jax_params(seed=0):
    import jax

    from nvtabular_tpu.models import dlrm as jdlrm

    config = jdlrm.DLRMConfig(CARDS, NUM_DENSE, **MODEL_KW)
    return jax.tree.map(np.asarray, jdlrm.dlrm_init(jax.random.PRNGKey(seed), config))


def jax_mesh(data, model):
    import jax

    from nvtabular_tpu.parallel import make_mesh

    return make_mesh({"data": data, "model": model}, devices=jax.devices()[: data * model])


def jax_sharded_run(params, batch, data, model, steps=STEPS):
    """The JAX package's make_train_step on a (data, model) mesh of virtual
    CPU devices with optax.adagrad: losses, params, sum_of_squares, logits."""
    import jax
    import jax.numpy as jnp
    import optax

    from nvtabular_tpu.models import dlrm as jdlrm
    from nvtabular_tpu.parallel import train as jtrain

    config = jdlrm.DLRMConfig(CARDS, NUM_DENSE, **MODEL_KW)
    mesh = jax_mesh(data, model)
    p_specs, b_specs = jdlrm.dlrm_param_specs(params), jdlrm.batch_specs(config)
    jp = jtrain.shard_params(jax.tree.map(jnp.asarray, params), p_specs, mesh)
    opt = optax.adagrad(LR)
    state = opt.init(jp)
    step = jtrain.make_train_step(jdlrm.dlrm_loss, opt, mesh=mesh, param_specs=p_specs, batch_specs=b_specs)
    jbatch = jtrain.shard_batch(batch, b_specs, mesh)
    losses = []
    for _ in range(steps):
        jp, state, loss = step(jp, state, jbatch)
        losses.append(float(loss))
    logits = np.asarray(jdlrm.dlrm_forward(jp, jbatch))
    return losses, jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, state[0].sum_of_squares), logits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's ranks and the JAX run on the mesh of the same shape."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    params, batch = jax_params(), step_batch()
    out = {}
    for world, (data, model) in SHAPES.items():
        ranks = run_group(train_worker, world, tmp, model, params, batch, timeout=90.0)
        out[world] = (ranks, jax_sharded_run(params, batch, data, model))
    return out


def _stacked(ranks, model_size, key):
    """Each table's rows stacked in model-rank order (from the data-rank-0 ranks)."""
    by_m = {res["coords"][1]: res for res in ranks if res["coords"][0] == 0}
    return {n: np.concatenate([by_m[m][key]["tables"][n] if key == "params" else by_m[m][key][n]
                               for m in range(model_size)]) for n in CARDS}


# --- the sharded step against JAX's on the same mesh shape ---------------------------------
@pytest.mark.parametrize("world", list(SHAPES))
def test_sharded_step_losses_match_jax(runs, world):
    ranks, (want_losses, _, _, _) = runs[world]
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want_losses, **LOSS_TOL)
    assert all(np.isfinite(want_losses))


@pytest.mark.parametrize("world", list(SHAPES))
def test_sharded_step_tables_and_accumulators_match_jax(runs, world):
    """The tables stacked from the ranks in model order equal JAX's padded
    tables after the steps; the Adagrad accumulators likewise."""
    ranks, (_, want, want_sos, _) = runs[world]
    model_size = SHAPES[world][1]
    tables, accs = _stacked(ranks, model_size, "params"), _stacked(ranks, model_size, "acc")
    for n in CARDS:
        assert tables[n].shape == want["tables"][n].shape == (-(-CARDS[n] // PAD) * PAD, MODEL_KW["embedding_dim"])
        np.testing.assert_allclose(tables[n], want["tables"][n], **TABLE_TOL, err_msg=n)
        np.testing.assert_allclose(accs[n], want_sos["tables"][n], **ACC_TOL, err_msg=n)
    for res in ranks:  # every data rank of a model shard holds the same rows
        m = res["coords"][1]
        for n in CARDS:
            rows = want["tables"][n].shape[0] // model_size
            np.testing.assert_allclose(res["params"]["tables"][n], want["tables"][n][m * rows : (m + 1) * rows],
                                       **TABLE_TOL, err_msg=n)


@pytest.mark.parametrize("world", list(SHAPES))
def test_sharded_step_mlps_match_jax_and_replicas_are_bit_equal(runs, world):
    """The MLP replicas bit-equal on every rank, and JAX's within TABLE_TOL
    on one data rank. Over two data ranks each side rounds a rank's bfloat16
    weight gradient before the data axis's sum and sums in its own way, so
    a gradient may differ by 2**-8 of itself; an Adagrad update is below lr
    in size, so each weight within STEPS * lr * 2**-8."""
    ranks, (_, want, _, _) = runs[world]
    tol = TABLE_TOL if SHAPES[world][0] == 1 else dict(rtol=0, atol=STEPS * LR * 2**-8)
    first = ranks[0]["params"]
    for side in ("bottom", "top"):
        for got, w in zip(first[side], want[side]):
            for k in ("w", "b"):
                np.testing.assert_allclose(got[k], w[k], **tol)
        for res in ranks[1:]:
            for got, ref in zip(res["params"][side], first[side]):
                for k in ("w", "b"):
                    assert np.array_equal(got[k].view(np.int32), ref[k].view(np.int32)), (side, k, res["coords"])


@pytest.mark.parametrize("world", list(SHAPES))
def test_shard_batch_and_eval_step_give_the_data_rank_rows(runs, world):
    """Data rank d's eval logits are rows [d * b, (d + 1) * b) of JAX's
    forward after the steps, the same on every model rank (logits within
    1e-3: bfloat16 MLPs, as test_torch_loader's forward tolerance)."""
    ranks, (_, _, _, want_logits) = runs[world]
    data = SHAPES[world][0]
    b = BATCH // data
    by_d = {}
    for res in ranks:
        d, _m = res["coords"]
        assert res["rows"] == b
        np.testing.assert_allclose(res["logits"], want_logits[d * b : (d + 1) * b], rtol=1e-3, atol=1e-3)
        by_d.setdefault(d, res["logits"])
        assert np.array_equal(res["logits"], by_d[d])


@pytest.mark.parametrize("world", list(SHAPES))
def test_sharded_lookup_gradient_matches_jax_vjp(runs, world):
    """sharded_embedding_lookup's gradient, summed over the data ranks of
    each model shard and stacked in model order, against jax.vjp of the JAX
    shard_map lookup; the forward bit-equal to it."""
    import jax
    import jax.numpy as jnp

    from nvtabular_tpu.parallel.embeddings import sharded_embedding_lookup

    ranks, _ = runs[world]
    data, model = SHAPES[world]
    table, idx, ct = lookup_inputs()
    mesh = jax_mesh(data, model)
    want, vjp = jax.vjp(lambda tab: sharded_embedding_lookup(tab, idx, mesh), jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(ct))
    b, rows = B // data, V // model
    grad = np.zeros_like(table)
    for res in ranks:
        d, m = res["coords"]
        np.testing.assert_array_equal(res["lookup"], np.asarray(want)[d * b : (d + 1) * b])
        grad[m * rows : (m + 1) * rows] += res["lookup_grad"]
    np.testing.assert_allclose(grad, np.asarray(want_grad), **LOOKUP_TOL)


# --- K15d's plain versions against the JAX sharded gather and its vjp ---------------------------
def _columns(model_size, seed=0, b=97, dim=6):
    """Three tables (padded to a multiple of 4), their ids with the edge
    cases, a cotangent, and each shard's columns."""
    rng = np.random.default_rng(seed)
    cards = [13, 5, 41]
    padded = [-(-c // 4) * 4 for c in cards]
    tables = [rng.normal(size=(vp, dim)).astype(np.float32) for vp in padded]
    ids = []
    for c, vp in zip(cards, padded):
        v = rng.integers(0, c, b).astype(np.int32)
        # a padding row, wraps to the padding row and to row 0, and no rank's ids
        v[:6] = [c, -1, -vp, vp, -vp - 1, 2**31 - 1]
        ids.append(v)
    ct = rng.normal(size=(b, len(cards), dim)).astype(np.float32)
    return tables, ids, ct, padded


def _shard(tables, padded, m, model_size):
    sizes = [vp // model_size for vp in padded]
    starts = [m * s for s in sizes]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    local = np.concatenate([tab[st : st + s] for tab, st, s in zip(tables, starts, sizes)])
    return t(local), offsets, sizes, starts


def _jax_gather(tables, ids, model_size):
    """jnp.take of each P("model", None)-sharded padded table, jitted on a
    mesh of ``model_size`` devices, stacked to [B, C, D]; and its vjp."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from nvtabular_tpu.parallel import make_mesh

    mesh = make_mesh({"model": model_size}, devices=jax.devices()[:model_size])
    placed = [jax.device_put(jnp.asarray(tab), NamedSharding(mesh, P("model", None))) for tab in tables]

    @jax.jit
    def gather(tabs):
        return jnp.stack([jnp.take(tab, jnp.asarray(i), axis=0) for tab, i in zip(tabs, ids)], axis=1)

    return jax.vjp(gather, placed)


@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_range_gather_columns_plain_matches_jax_sharded_gather(model_size):
    """Each shard's gather summed over the shards (the model group's sum)
    equals jnp.take on the whole padded tables bit for bit: the padding row
    read, negatives wrapped by Vp, NaN rows where no rank holds the id —
    written by model rank 0 alone."""
    tables, ids, _, padded = _columns(model_size)
    want, _ = _jax_gather(tables, ids, model_size)
    want = np.asarray(want)
    total = np.zeros_like(want)
    pids = [t(i) for i in ids]
    for m in range(model_size):
        local, offsets, sizes, starts = _shard(tables, padded, m, model_size)
        got = kemb.range_gather_columns(local, pids, offsets, sizes, starts, padded, m).numpy()
        assert got.shape == want.shape and got.flags["C_CONTIGUOUS"]
        assert np.isnan(got).any() == (m == 0)
        total += got
    np.testing.assert_array_equal(total, want)
    no_rank = np.isnan(want).all(axis=2)
    assert no_rank[:, :][[3, 4, 5]].all() and not no_rank[:3].any()


@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_range_scatter_grad_plain_matches_jax_vjp(model_size):
    """Each shard's scatter-add, stacked in model order, equals the vjp's
    table gradients (sums of at most a few terms in another order); ids no
    rank holds add nothing. The gradient may be a strided view."""
    tables, ids, ct, padded = _columns(model_size, seed=1)
    _, vjp = _jax_gather(tables, ids, model_size)
    (want,) = vjp(np.asarray(ct))
    buf = torch.zeros((ct.shape[0], 1 + ct.shape[1], ct.shape[2]))
    buf[:, 1:] = t(ct)
    pids = [t(i) for i in ids]
    got = [[] for _ in tables]
    for m in range(model_size):
        local, offsets, sizes, starts = _shard(tables, padded, m, model_size)
        dtable = kemb.range_scatter_grad(buf[:, 1:], pids, offsets, sizes, starts, padded, local.shape[0]).numpy()
        for c, (o, s) in enumerate(zip(offsets, sizes)):
            got[c].append(dtable[o : o + s])
    for c, w in enumerate(want):
        np.testing.assert_allclose(np.concatenate(got[c]), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_sharded_features_sum_lead_once_and_backward_is_not_summed():
    """ShardedEmbeddingFeatures with a model group of two simulated in one
    process: the lead stays out of the sum (slot 0 is the lead, not twice
    it), and each rank's table gradient is its own rows' share, not the
    group's sum of them (no second sum in the backward)."""
    tables, ids, ct, padded = _columns(2, seed=2)
    pids = [t(i) for i in ids]
    lead = torch.randn(len(ids[0]), tables[0].shape[1])
    shards = [_shard(tables, padded, m, 2) for m in range(2)]
    total = sum(kemb.range_gather_columns(local, pids, offs, sizes, starts, padded, m)
                for m, (local, offs, sizes, starts) in enumerate(shards))
    grads = []
    for m, (local, offsets, sizes, starts) in enumerate(shards):
        shard = kemb.RowShard(tuple(offsets), tuple(sizes), tuple(starts), tuple(padded), m,
                              reduce=lambda x: x.copy_(total))
        local.requires_grad_(True)
        feats = kemb.sharded_embedding_features(lead, local, pids, shard)
        torch.testing.assert_close(feats[:, 0], lead, rtol=0, atol=0)
        torch.testing.assert_close(feats[:, 1:], total, rtol=0, atol=0, equal_nan=True)
        feats.backward(torch.cat([torch.zeros_like(lead)[:, None], t(ct)], dim=1))
        grads.append(local.grad)
    whole = np.concatenate([[0], np.cumsum(padded)[:-1]]).tolist()
    want = kemb.range_scatter_grad_plain(t(ct), pids, whole, padded, [0] * 3, padded, sum(padded))
    offsets, sizes = shards[0][1], shards[0][2]
    for c, (o, s) in enumerate(zip(offsets, sizes)):
        got = torch.cat([g[o : o + s] for g in grads])
        torch.testing.assert_close(got, want[whole[c] : whole[c] + padded[c]], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "call",
    [
        lambda: kemb.range_gather_columns(torch.zeros(4, 3), [torch.zeros(5, dtype=torch.int64)], [0], [4], [0], [4], 0),
        lambda: kemb.range_gather_columns(torch.zeros(4, 3), [torch.zeros(5, dtype=torch.int32)], [0], [5], [0], [8], 0),
        lambda: kemb.range_gather_columns(torch.zeros(4, 3), [torch.zeros(5, dtype=torch.int32)], [0], [4], [6], [8], 0),
        lambda: kemb.range_gather_columns(torch.zeros(4, 3), [torch.zeros(5, dtype=torch.int32)], [0, 0], [4], [0], [8], 0),
        lambda: kemb.range_scatter_grad(torch.zeros(6, 1, 3), [torch.zeros(5, dtype=torch.int32)], [0], [4], [0], [8], 4),
        lambda: kemb.range_scatter_grad(torch.zeros(5, 2, 3)[:, :, :2], [torch.zeros(5, dtype=torch.int32)] * 2,
                                        [0, 0], [4, 4], [0, 0], [8, 8], 4),
    ],
    ids=["int64_ids", "rows_past_the_shard", "rows_past_the_table", "columns_mismatch", "batch_mismatch",
         "strided_block"],
)
def test_range_column_wrappers_reject_wrong_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()


# --- specs ------------------------------------------------------------------------------
def test_param_and_batch_specs_match_jax():
    """The port's axis tuples in the shape of the JAX PartitionSpec pytrees."""
    import jax
    from jax.sharding import PartitionSpec as P

    from nvtabular_tpu.models import dlrm as jdlrm

    jconfig = jdlrm.DLRMConfig(CARDS, NUM_DENSE, **MODEL_KW)
    model = pmodels.DLRM(pmodels.DLRMConfig(CARDS, NUM_DENSE, **MODEL_KW), device="cpu")
    as_tuples = lambda tree: jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))  # noqa: E731
    want = as_tuples(jdlrm.dlrm_param_specs(jax_params()))
    assert pmodels.dlrm_param_specs(model) == want
    assert pmodels.dlrm_param_specs(model, "rows") == as_tuples(jdlrm.dlrm_param_specs(jax_params(), "rows"))
    assert pmodels.batch_specs(model.config) == as_tuples(jdlrm.batch_specs(jconfig))
    assert pmodels.batch_specs(model.config, "dp") == as_tuples(jdlrm.batch_specs(jconfig, "dp"))


def test_shard_tables_needs_sizes_divisible_by_the_model_axis():
    model = pmodels.DLRM(pmodels.DLRMConfig(CARDS, NUM_DENSE, **MODEL_KW), device="cpu")
    with pytest.raises(ValueError, match="vocab_pad_multiple"):
        model.shard_tables(0, 4, reduce=lambda x: x)
    model.shard_tables(1, 2, reduce=lambda x: x)
    assert model.sizes == [501, 250, 4] and model.shard.starts == (501, 250, 4)
    assert model.table.shape == (755, MODEL_KW["embedding_dim"])
    with pytest.raises(ValueError, match="sharded already"):
        model.shard_tables(0, 2, reduce=lambda x: x)
    with pytest.raises(ValueError, match="not sharded"):
        pmodels.reference_forward(model, {})


def test_train_step_without_a_mesh_is_train_step():
    """make_train_step without a mesh steps as models.train_step;
    make_eval_step is the forward without gradients."""
    config = pmodels.DLRMConfig(CARDS, NUM_DENSE, **MODEL_KW)
    batch = {k: t(v) for k, v in step_batch().items()}
    runs = []
    for step in (par.make_train_step(pmodels.dlrm_loss), pmodels.train_step):
        model = pmodels.DLRM(config, seed=4, device="cpu")
        opt = pmodels.Adagrad(model.parameters(), lr=LR)
        runs.append(([float(step(model, opt, batch)) for _ in range(2)], model.table.detach().clone()))
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    logits = par.make_eval_step(pmodels.DLRM.forward)(model, batch)
    assert not logits.requires_grad and torch.equal(logits, model(batch).detach())
    with pytest.raises(ValueError, match="param_specs and batch_specs"):
        par.make_train_step(pmodels.dlrm_loss, None, mesh=object())


# --- vocab_pad_multiple > 1 on one device --------------------------------------------------
FAMILIES = ["dlrm", "deepfm", "dcn"]


def _family(name):
    import nvtabular_tpu.models.deepfm as jdeepfm
    import nvtabular_tpu.models.dlrm as jdlrm

    kw = dict(embedding_dim=8, vocab_pad_multiple=4)
    if name == "dlrm":
        kw.update(bottom_mlp=(16,), top_mlp=(16,))
        return (jdlrm.DLRMConfig, jdlrm.dlrm_init, jdlrm.dlrm_loss, jdlrm.dlrm_forward, pmodels.DLRMConfig,
                pmodels.DLRM, pmodels.dlrm_loss, pnvt.load_dlrm_params, pnvt.dlrm_params, kw)
    kw.update(deep_mlp=(16,))
    if name == "deepfm":
        return (jdeepfm.DeepFMConfig, jdeepfm.deepfm_init, jdeepfm.deepfm_loss, jdeepfm.deepfm_forward,
                pmodels.DeepFMConfig, pmodels.DeepFM, pmodels.deepfm_loss, pnvt.load_deepfm_params,
                pnvt.deepfm_params, kw)
    kw.update(num_cross_layers=2)
    return (jdeepfm.DCNConfig, jdeepfm.dcn_init, jdeepfm.dcn_loss, jdeepfm.dcn_forward, pmodels.DCNConfig,
            pmodels.DCN, pmodels.dcn_loss, pnvt.load_dcn_params, pnvt.dcn_params, kw)


@pytest.mark.parametrize("family", FAMILIES)
def test_vocab_pad_multiple_matches_jax(family):
    """Tables (and DeepFM's linear) padded to multiples of 4 as the JAX init
    pads them; a batch reading the padding rows and wrapping negative ids by
    the padded size gives JAX's logits (1e-3: bfloat16 MLPs) and, over three
    Adagrad(1e-2) steps against optax's, its losses, parameters and
    accumulators (the limits of test_torch_loader.py)."""
    import jax
    import jax.numpy as jnp
    import optax

    from nvtabular_tpu.models.training import make_step_fns

    jconfig_cls, jinit, jloss, jforward, pconfig_cls, pmodel, ploss, load, params_of, kw = _family(family)
    cards = {"a": 1001, "b": 499, "c": 7}
    jconfig, pconfig = jconfig_cls(cards, NUM_DENSE, **kw), pconfig_cls(cards, NUM_DENSE, **kw)
    params = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(1), jconfig))
    assert params["tables"]["c"].shape[0] == pconfig.padded_cardinality(7) == 8
    batches = [step_batch(seed=20 + i) for i in range(STEPS)]

    opt = optax.adagrad(LR)
    step, _ = make_step_fns(jloss, opt)
    jp = jax.tree.map(jnp.asarray, params)
    want_logits = np.asarray(jforward(jp, {k: jnp.asarray(v) for k, v in batches[0].items()}))
    state = opt.init(jp)
    want_losses = []
    for b in batches:
        jp, state, loss = step(jp, state, {k: jnp.asarray(v) for k, v in b.items()})
        want_losses.append(float(loss))

    model = pmodel(pconfig, device="cpu")
    assert model.table.shape[0] == sum(pconfig.padded_cardinality(c) for c in cards.values())
    load(model, params)
    opt_p = pmodels.Adagrad(model.parameters(), lr=LR)
    np.testing.assert_allclose(model({k: t(v) for k, v in batches[0].items()}).detach().numpy(), want_logits,
                               rtol=1e-3, atol=1e-3)
    got_losses = [float(pmodels.train_step(model, opt_p, {k: t(v) for k, v in b.items()}, ploss)) for b in batches]
    np.testing.assert_allclose(got_losses, want_losses, **LOSS_TOL)

    got = params_of(model)
    want = jax.tree.map(np.asarray, jp)
    for n in cards:
        np.testing.assert_allclose(got["tables"][n], want["tables"][n], **TABLE_TOL, err_msg=n)
    sos = pmodel(pconfig, device="cpu")
    load(sos, jax.tree.map(np.asarray, state[0].sum_of_squares))
    for (name, p), s in zip(model.named_parameters(), sos.parameters()):
        np.testing.assert_allclose(opt_p.accumulator(p).numpy(), s.detach().numpy(), **ACC_TOL, err_msg=name)
