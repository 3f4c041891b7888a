"""DLRM with multihot tables, whole and row-sharded: nvtabular_tpu_torch
against the JAX package on the CPU.

The port runs the plain versions of its kernels here: K13a and K13c for the
whole model's single-hot rows and bags, K15d and K15d's bag (``range_bag``,
``range_bag_grad``) for the sharded one, K13b for the interaction. The same
numpy batches and the JAX parameters (carried across by
``convert.load_dlrm_params``) go through ``dlrm_forward`` with
``optax.adagrad(1e-2)`` and through the port; the sharded step runs on gloo
groups of 2 and 4 spawned ranks (data 1 x model 2 and 2 x 2) against the
JAX ``make_train_step`` on a mesh of the same shape of virtual CPU devices.
Tolerances are those of ``test_torch_sharded_train.py``: losses rtol 1e-5,
tables rtol 1e-5 and atol 1e-6, accumulators rtol 1e-5 (bfloat16 MLPs on
both sides, float32 sums in another order); logits 1e-3 (bfloat16 MLPs).
The module imports no JAX at its top: the spawned workers import it by
name, and the across-cards GPU test reuses ``train_worker``.
"""

import numpy as np
import pytest
import torch

import nvtabular_tpu_torch as pnvt
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch import parallel as par
from nvtabular_tpu_torch.convert import load_sharded_table
from nvtabular_tpu_torch.kernels import LAUNCHES
from nvtabular_tpu_torch.kernels import embedding as kemb
from nvtabular_tpu_torch.kernels import embedding_bag as kbag
from nvtabular_tpu_torch.parallel.mesh import mesh_device
from torch_groups import run_group

# two tables and two multihot tables, padded to a multiple of the model axis's 2 ranks
CARDS, MH_CARDS = {"a": 1001, "c": 7}, {"g": 23, "m": 41}
NUM_DENSE, BATCH, STEPS, LR, PAD, L = 4, 64, 3, 1e-2, 2, 3
MODEL_KW = dict(embedding_dim=8, bottom_mlp=(16,), top_mlp=(16,), vocab_pad_multiple=PAD,
                multihot_cardinalities=MH_CARDS, multihot_max_len=L)
SHAPES = {2: (1, 2), 4: (2, 2)}  # world -> (data, model)
LOSS_TOL = dict(rtol=1e-5)
TABLE_TOL = dict(rtol=1e-5, atol=1e-6)
ACC_TOL = dict(rtol=1e-5)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
# the sharded bag's inputs (the zero rule) and its gradient: sums of a few float32 terms in another order
BAG_V, BAG_D, BAG_B = 48, 8, 32
BAG_TOL = dict(rtol=1e-6, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def config(**kw):
    return pmodels.DLRMConfig(CARDS, NUM_DENSE, **{**MODEL_KW, **kw})


def step_batch(seed=3, pad=PAD):
    """A global batch whose multihot slots include negatives in real slots
    (-1 wraps to the padding row Vp - 1, -Vp to row 0), a padding row, and
    in-range ids under the mask; its single-hot ids a padding row and a
    wrap."""
    batch = pmodels.make_synthetic_batch(config(vocab_pad_multiple=pad), BATCH, seed=seed)
    batch["a"][:2] = [1001, -1]
    for name, card in MH_CARDS.items():
        vp = -(-card // pad) * pad
        values, mask = batch[f"{name}__values"], batch[f"{name}__mask"]
        mask[:4] = [[1, 1, 0], [1, 0, 0], [1, 1, 1], [0, 0, 0]]
        values[0, :2] = [-1, -vp]
        values[1] = [card, 5, 2]  # the padding row (or, unpadded, a row past the table) only when real
        values[2, 2] = vp - 1
    return batch


def nan_batch(batch):
    """The batch with a masked id outside the padded table in row 5 and a
    real one in row 6: their bags, and so their logits, are NaN."""
    batch = {k: v.copy() for k, v in batch.items()}
    batch["g__values"][5] = [1, 2, 10_000]
    batch["g__mask"][5] = [1, 1, 0]
    batch["m__values"][6, 0] = -500
    batch["m__mask"][6, 0] = 1
    return batch


# --- the spawned ranks ---------------------------------------------------------------------
def bag_inputs():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(BAG_V, BAG_D)).astype(np.float32)
    values = rng.integers(0, BAG_V, (BAG_B, 4)).astype(np.int32)
    values[:3, 0] = [BAG_V + 3, -1, -BAG_V]  # no shard holds these under the zero rule: zeros, no gradient
    mask = (rng.random((BAG_B, 4)) < 0.7).astype(np.float32)
    mask[3] = 0  # an empty bag
    ct = rng.normal(size=(BAG_B, BAG_D)).astype(np.float32)
    return table, values, mask, ct


def train_worker(rank, world, model_size, params, batch, steps=STEPS):
    """``steps`` sharded Adagrad steps of one global batch on this rank's
    shard of the single-hot and multihot tables; its tables, accumulators,
    MLPs and eval logits after them, and on the CPU the sharded bag and its
    gradient with both combiners."""
    mesh = par.local_mesh(model=model_size)
    dev = mesh_device(mesh)
    model = pmodels.DLRM(config(), device=dev)
    p_specs, b_specs = pmodels.dlrm_param_specs(model), pmodels.batch_specs(model.config)
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
        "mh_acc": {n: opt.accumulator(p).detach().cpu().numpy() for n, p in zip(model.mh_names, model.mh_tables)},
        "logits": par.make_eval_step(pmodels.DLRM.forward, mesh)(model, local).cpu().numpy(),
    }
    if dev.type == "cpu":
        table, values, mask, ct = bag_inputs()
        d, m = out["coords"]
        b = BAG_B // mesh.get_group("data").size()
        rows = slice(d * b, (d + 1) * b)
        for combiner in ("mean", "sum"):
            local_table = load_sharded_table(table, m, model_size, device="cpu").requires_grad_(True)
            pooled = par.sharded_embedding_bag(local_table, values[rows], mask[rows], mesh, combiner=combiner)
            (pooled * t(ct[rows])).sum().backward()
            out[f"bag_{combiner}"] = (pooled.detach().numpy(), local_table.grad.numpy())
    return out


# --- the JAX side, in this process only ------------------------------------------------------
def jax_config(**kw):
    from nvtabular_tpu.models import dlrm as jdlrm

    return jdlrm.DLRMConfig(CARDS, NUM_DENSE, **{**MODEL_KW, **kw})


def jax_params(seed=0, **kw):
    import jax

    from nvtabular_tpu.models import dlrm as jdlrm

    return jax.tree.map(np.asarray, jdlrm.dlrm_init(jax.random.PRNGKey(seed), jax_config(**kw)))


def jax_mesh(data, model):
    import jax

    from nvtabular_tpu.parallel import make_mesh

    return make_mesh({"data": data, "model": model}, devices=jax.devices()[: data * model])


def jax_steps(params, batches, mesh=None):
    """optax.adagrad(LR) steps of the JAX DLRM, one per batch, single-device
    (make_step_fns) or on a mesh (make_train_step): losses, params,
    sum_of_squares, the logits after the steps of the last batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from nvtabular_tpu.models import dlrm as jdlrm
    from nvtabular_tpu.models.training import make_step_fns
    from nvtabular_tpu.parallel import train as jtrain

    opt = optax.adagrad(LR)
    jp = jax.tree.map(jnp.asarray, params)
    if mesh is None:
        step, _ = make_step_fns(jdlrm.dlrm_loss, opt)
        place = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
    else:
        p_specs, b_specs = jdlrm.dlrm_param_specs(params), jdlrm.batch_specs(jax_config())
        jp = jtrain.shard_params(jp, p_specs, mesh)
        step = jtrain.make_train_step(jdlrm.dlrm_loss, opt, mesh=mesh, param_specs=p_specs, batch_specs=b_specs)
        place = lambda b: jtrain.shard_batch(b, b_specs, mesh)  # noqa: E731
    state = opt.init(jp)
    losses = []
    for b in batches:
        jp, state, loss = step(jp, state, place(b))
        losses.append(float(loss))
    logits = np.asarray(jdlrm.dlrm_forward(jp, place(batches[-1])))
    return losses, jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, state[0].sum_of_squares), logits


# --- the whole model against dlrm_forward and optax --------------------------------------
def test_multihot_forward_matches_jax_including_nan_and_wrapped_ids():
    """Logits of dlrm_forward on a batch with negative ids (wrapped), padding
    rows under the mask and ids outside the table: a masked one (NaN times
    a zero mask is NaN) and a real one make their rows NaN, as jnp.take
    does; the features are JAX's [bottom, tables sorted, multihot sorted]."""
    import jax.numpy as jnp

    from nvtabular_tpu.models import dlrm as jdlrm

    params = jax_params(seed=1, vocab_pad_multiple=1)
    batch = nan_batch(step_batch(seed=7, pad=1))
    want = np.asarray(jdlrm.dlrm_forward({k: v for k, v in params.items()}, {k: jnp.asarray(v) for k, v in batch.items()}))
    model = pmodels.DLRM(config(vocab_pad_multiple=1), device="cpu")
    assert [tuple(p.shape) for p in model.mh_tables] == [(23, 8), (41, 8)]
    pnvt.load_dlrm_params(model, params)
    got = model({k: t(v) for k, v in batch.items()}).detach().numpy()
    # row 0: id 1001 of a 1001-row table; row 1: id 23 of a 23-row table, real
    assert np.isnan(want[[0, 1, 5, 6]]).all() and np.isnan(want).sum() == 4
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert sum(LAUNCHES.values()) == 0  # CPU tensors never launch a kernel


def test_multihot_loss_and_adagrad_steps_match_optax():
    """Three Adagrad(1e-2) steps on three batches (wrapped negatives,
    padding rows, masked ids) against optax.adagrad on dlrm_loss: losses,
    both kinds of tables, MLPs and every accumulator."""
    params = jax_params(seed=2)
    batches = [step_batch(seed=20 + i) for i in range(STEPS)]
    want_losses, want, want_sos, _ = jax_steps(params, batches)
    model = pmodels.DLRM(config(), device="cpu")
    pnvt.load_dlrm_params(model, params)
    opt = pmodels.Adagrad(model.parameters(), lr=LR)
    got_losses = [float(pmodels.train_step(model, opt, {k: t(v) for k, v in b.items()})) for b in batches]
    np.testing.assert_allclose(got_losses, want_losses, **LOSS_TOL)
    got = pnvt.dlrm_params(model)
    for kind in ("tables", "mh_tables"):
        for name, w in want[kind].items():
            np.testing.assert_allclose(got[kind][name], w, **TABLE_TOL, err_msg=name)
    for side in ("bottom", "top"):
        for g, w in zip(got[side], want[side]):
            np.testing.assert_allclose(g["w"], w["w"], **TABLE_TOL)
    sos = pmodels.DLRM(config(), device="cpu")
    pnvt.load_dlrm_params(sos, want_sos)
    for (name, p), s in zip(model.named_parameters(), sos.parameters()):
        np.testing.assert_allclose(opt.accumulator(p).numpy(), s.detach().numpy(), **ACC_TOL, err_msg=name)


def test_reference_forward_covers_the_bags():
    """reference_forward (the plain versions) equals the model's forward and
    gradients; the bags sit after the single-hot rows in the features."""
    model = pmodels.DLRM(config(), seed=3, device="cpu")
    batch = {k: t(v) for k, v in step_batch(seed=9).items()}
    got = model(batch)
    want = pmodels.reference_forward(model, batch)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    feats = kemb.embedding_features(torch.zeros(BATCH, 8), model.table, [batch[n] for n in model.names],
                                    model.offsets, model.sizes, model._bags(batch))
    assert feats.shape == (BATCH, 1 + 2 + 2, 8)
    torch.testing.assert_close(feats[:, 3], kbag.embedding_bag_fwd_plain(model.mh_tables[0], batch["g__values"],
                                                                         batch["g__mask"]), rtol=0, atol=0)


def test_slice_whole_config1_loader_dlrm_multihot_adagrad(tmp_path):
    """The MovieLens config-1 workflow fitted by each package →
    DeviceLoader(shuffle=False, sparse_max={"genres": 4}) → a DLRM of
    DLRMConfig.from_schema(num_dense=1): 2 tables, the genres multihot table,
    4 features → 3 Adagrad(1e-2) steps, against the same chain in JAX
    (losses and tables to 1e-5: the dense input differs by log1p ULPs)."""
    import jax
    import jax.numpy as jnp
    import optax

    import nvtabular_tpu as jnvt
    from nvtabular_tpu import ops as jops
    from nvtabular_tpu.dag.executor import JitExecutor
    from nvtabular_tpu.loader import DeviceLoader as JDeviceLoader
    from nvtabular_tpu.models import dlrm as jdlrm
    from nvtabular_tpu.models.training import make_step_fns
    from nvtabular_tpu_torch import ops as pops
    from nvtabular_tpu_torch.loader import DeviceLoader
    from test_torch_tabular import _config1, _movielens_part, _table

    parts = [_movielens_part(s) for s in range(3)]
    jwf = jnvt.Workflow(_config1(jops, out_path=str(tmp_path)), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([_table(jnvt, p) for p in parts]))
    pwf = pnvt.Workflow(_config1(pops), device="cpu")
    pwf.fit(pnvt.Dataset([_table(pnvt, p) for p in parts]))
    names = dict(cat_names=["userId", "movieId", "genres"], cont_names=["ts_delta"], label_names=["rating"],
                 batch_size=1024, shuffle=False, sparse_max={"genres": 4})
    jbatches = list(JDeviceLoader(jwf.transform(jnvt.Dataset([_table(jnvt, p) for p in parts])), **names))[:3]
    pbatches = list(DeviceLoader(pwf.transform(pnvt.Dataset([_table(pnvt, p) for p in parts])), device="cpu",
                                 **names))[:3]
    kwargs = dict(num_dense=1, embedding_dim=8, bottom_mlp=(32, 16), top_mlp=(32, 16))
    jconfig = jdlrm.DLRMConfig.from_schema(jwf.output_schema, **kwargs)
    pconfig = pmodels.DLRMConfig.from_schema(pwf.output_schema, **kwargs)
    assert pconfig.cardinalities == jconfig.cardinalities and len(pconfig.cardinalities) == 2
    assert pconfig.multihot_cardinalities == jconfig.multihot_cardinalities == {"genres": 23}
    assert pconfig.num_features == 4 and pconfig.interaction_dim == 6
    params = jax.tree.map(np.asarray, jdlrm.dlrm_init(jax.random.PRNGKey(0), jconfig))

    opt = optax.adagrad(LR)
    step, _ = make_step_fns(jdlrm.dlrm_loss, opt)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    want_losses = []
    for b in jbatches:
        jp, state, loss = step(jp, state, b)
        want_losses.append(float(loss))

    model = pmodels.DLRM(pconfig, device="cpu")
    pnvt.load_dlrm_params(model, params)
    popt = pmodels.Adagrad(model.parameters(), lr=LR)
    got_losses = [float(pmodels.train_step(model, popt, b)) for b in pbatches]
    np.testing.assert_allclose(got_losses, want_losses, **LOSS_TOL)
    got = pnvt.dlrm_params(model)
    for kind in ("tables", "mh_tables"):
        for name, want in jp[kind].items():
            np.testing.assert_allclose(got[kind][name], np.asarray(want), **TABLE_TOL, err_msg=name)


def test_jax_dlrm_forward_fails_with_self_interaction_and_the_port_refuses_it():
    """The recorded difference: the reference sizes its top MLP for F(F+1)/2
    pairs but builds F(F-1)/2, so its forward raises; the port refuses the
    configuration and names the reference's fault."""
    import jax.numpy as jnp

    from nvtabular_tpu.models import dlrm as jdlrm

    params = jax_params(self_interaction=True, multihot_cardinalities={}, vocab_pad_multiple=1)
    batch = pmodels.make_synthetic_batch(config(multihot_cardinalities={}), 8)
    with pytest.raises(TypeError, match="contracting dimensions"):
        jdlrm.dlrm_forward(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="ROADMAP.md §3"):
        pmodels.DLRM(config(self_interaction=True), device="cpu")


def test_params_round_trip_and_specs_match_jax():
    """load_dlrm_params / dlrm_params carry mh_tables; dlrm_param_specs
    row-shards them over the model axis as the JAX specs do."""
    import jax
    from jax.sharding import PartitionSpec as P

    from nvtabular_tpu.models import dlrm as jdlrm

    params = jax_params(seed=4)
    model = pmodels.DLRM(config(), device="cpu")
    pnvt.load_dlrm_params(model, params)
    got = pnvt.dlrm_params(model)
    for kind in ("tables", "mh_tables"):
        assert sorted(got[kind]) == sorted(params[kind])
        for name, want in params[kind].items():
            np.testing.assert_array_equal(got[kind][name], want)
    as_tuples = lambda tree: jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))  # noqa: E731
    assert pmodels.dlrm_param_specs(model) == as_tuples(jdlrm.dlrm_param_specs(params))
    assert pmodels.batch_specs(model.config) == as_tuples(jdlrm.batch_specs(jax_config()))
    with pytest.raises(ValueError, match="mh_tables"):
        pnvt.load_dlrm_params(model, {**params, "mh_tables": {"g": params["mh_tables"]["g"]}})


def test_shard_tables_keeps_each_multihot_tables_rows():
    """Model shard 1 of 2: each multihot table's rows [Vp / 2, Vp), the
    shard's starts and padded sizes; loading and reading JAX's whole
    tables gives the rank's rows; sizes not divisible by the axis raise."""
    params = jax_params(seed=5)
    model = pmodels.DLRM(config(), device="cpu")
    with pytest.raises(ValueError, match="vocab_pad_multiple"):
        model.shard_tables(0, 4, reduce=lambda x: x)
    model.shard_tables(1, 2, reduce=lambda x: x)
    assert [tuple(p.shape) for p in model.mh_tables] == [(12, 8), (21, 8)]
    assert model.shard.bag_starts == (12, 21) and model.shard.bag_padded == (24, 42)
    pnvt.load_dlrm_params(model, params)
    got = pnvt.dlrm_params(model)
    for name, vp in (("g", 24), ("m", 42)):
        np.testing.assert_array_equal(got["mh_tables"][name], params["mh_tables"][name][vp // 2 :])
    with pytest.raises(ValueError, match="padded table"):
        pnvt.load_dlrm_params(model, {**params, "mh_tables": {n: v[:-2] for n, v in params["mh_tables"].items()}})


# --- the sharded step against JAX's on the same mesh shape ---------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's ranks and the JAX run on the mesh of the same shape."""
    tmp = tmp_path_factory.mktemp("multihot_sharded")
    params, batch = jax_params(), step_batch()
    out = {}
    for world, (data, model) in SHAPES.items():
        ranks = run_group(train_worker, world, tmp, model, params, batch, timeout=90.0)
        out[world] = (ranks, jax_steps(params, [batch] * STEPS, jax_mesh(data, model)))
    return out


def _stacked(ranks, model_size, kind, key="params"):
    """Each table's rows stacked in model-rank order (from the data-rank-0 ranks)."""
    by_m = {res["coords"][1]: res for res in ranks if res["coords"][0] == 0}
    names = CARDS if kind == "tables" else MH_CARDS
    pick = (lambda r, n: r["params"][kind][n]) if key == "params" else (lambda r, n: r[key][n])
    return {n: np.concatenate([pick(by_m[m], n) for m in range(model_size)]) for n in names}


@pytest.mark.parametrize("world", list(SHAPES))
def test_sharded_multihot_step_losses_match_jax(runs, world):
    ranks, (want_losses, _, _, _) = runs[world]
    assert all(np.isfinite(want_losses))
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want_losses, **LOSS_TOL)


@pytest.mark.parametrize("world", list(SHAPES))
def test_sharded_multihot_step_tables_and_accumulators_match_jax(runs, world):
    """Both kinds of tables stacked from the ranks in model order equal
    JAX's padded tables after the steps, and so do their Adagrad
    accumulators; every data rank of a model shard holds the same rows."""
    ranks, (_, want, want_sos, _) = runs[world]
    model_size = SHAPES[world][1]
    for kind, acc_key in (("tables", "acc"), ("mh_tables", "mh_acc")):
        tables, accs = _stacked(ranks, model_size, kind), _stacked(ranks, model_size, kind, acc_key)
        for name, w in want[kind].items():
            card = {**CARDS, **MH_CARDS}[name]
            assert tables[name].shape == w.shape == (-(-card // PAD) * PAD, MODEL_KW["embedding_dim"])
            np.testing.assert_allclose(tables[name], w, **TABLE_TOL, err_msg=name)
            np.testing.assert_allclose(accs[name], want_sos[kind][name], **ACC_TOL, err_msg=name)
            for res in ranks:
                rows = w.shape[0] // model_size
                m = res["coords"][1]
                np.testing.assert_allclose(res["params"][kind][name], w[m * rows : (m + 1) * rows], **TABLE_TOL)


@pytest.mark.parametrize("world", list(SHAPES))
def test_sharded_multihot_mlps_and_logits_match_jax(runs, world):
    """The MLP replicas bit-equal on every rank and JAX's within TABLE_TOL on
    one data rank, STEPS * lr * 2**-8 on two (each side rounds a rank's
    bfloat16 weight gradient before the data axis's sum:
    test_torch_sharded_train.py); data rank d's eval logits are rows of
    JAX's forward after the steps."""
    ranks, (_, want, _, want_logits) = runs[world]
    data = SHAPES[world][0]
    tol = TABLE_TOL if data == 1 else dict(rtol=0, atol=STEPS * LR * 2**-8)
    first = ranks[0]["params"]
    b = BATCH // data
    for res in ranks:
        for side in ("bottom", "top"):
            for got, w, ref in zip(res["params"][side], want[side], first[side]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(got[k], w[k], **tol)
                    assert np.array_equal(got[k].view(np.int32), ref[k].view(np.int32))
        d = res["coords"][0]
        assert res["rows"] == b
        np.testing.assert_allclose(res["logits"], want_logits[d * b : (d + 1) * b], **LOGIT_TOL)


@pytest.mark.parametrize("combiner", ["mean", "sum"])
@pytest.mark.parametrize("world", list(SHAPES))
def test_sharded_embedding_bag_and_gradient_match_jax_vjp(runs, world, combiner):
    """sharded_embedding_bag (the zero rule: ids no shard holds read zeros,
    negatives too) and its gradient, summed over the data ranks of each
    model shard and stacked in model order, against jax.vjp of the JAX
    shard_map bag on the mesh of the same shape."""
    import jax
    import jax.numpy as jnp

    from nvtabular_tpu.parallel.embeddings import sharded_embedding_bag

    ranks, _ = runs[world]
    data, model = SHAPES[world]
    table, values, mask, ct = bag_inputs()
    mesh = jax_mesh(data, model)
    want, vjp = jax.vjp(lambda tab: sharded_embedding_bag(tab, values, mask, mesh, combiner=combiner),
                        jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(ct))
    b, rows = BAG_B // data, BAG_V // model
    grad = np.zeros_like(table)
    for res in ranks:
        d, m = res["coords"]
        pooled, local_grad = res[f"bag_{combiner}"]
        np.testing.assert_allclose(pooled, np.asarray(want)[d * b : (d + 1) * b], **BAG_TOL)
        grad[m * rows : (m + 1) * rows] += local_grad
    np.testing.assert_allclose(grad, np.asarray(want_grad), **BAG_TOL)
    assert np.count_nonzero(np.asarray(want_grad)) > 0


# --- K15d's bag: plain versions against jnp.take on the whole padded table ---------------------
def _bags(seed=0, b=53, dim=6, vp=24):
    """A padded multihot table, ids with the edge cases, a mask and a
    cotangent: a padding row, -1 and -vp (wraps), masked and real ids
    outside [-vp, vp) in rows 4 and 5."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(vp, dim)).astype(np.float32)
    values = rng.integers(0, vp - 1, (b, 4)).astype(np.int32)
    mask = (rng.random((b, 4)) < 0.75).astype(np.float32)
    values[:4, 0] = [vp - 1, -1, -vp, 3]
    mask[:4, 0] = 1.0
    values[4, 1], mask[4, 1] = vp, 0.0  # masked, no rank's: NaN
    values[5, 2], mask[5, 2] = -vp - 1, 1.0
    ct = rng.normal(size=(b, dim)).astype(np.float32)
    return table, values, mask, ct


@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_range_bag_plain_sums_to_the_whole_bag(model_size):
    """Each shard's take-mode bag summed over the shards equals the whole
    padded table's multihot sum (jnp.take, then the masked sum), NaN bags
    written by model rank 0 alone; the ids another rank holds add nothing."""
    import jax.numpy as jnp

    table, values, mask, _ = _bags()
    emb = jnp.take(jnp.asarray(table), jnp.asarray(values), axis=0)
    want = np.asarray(jnp.sum(emb * jnp.asarray(mask)[..., None], axis=1))
    vp, rows = table.shape[0], table.shape[0] // model_size
    total = np.zeros_like(want)
    for m in range(model_size):
        got = kbag.range_bag(t(table[m * rows : (m + 1) * rows]), t(values), t(mask), m * rows, vp, m).numpy()
        assert np.isnan(got).any() == (m == 0)
        total += got
    assert np.isnan(want).all(axis=1)[[4, 5]].all() and np.isnan(want).any(axis=1).sum() == 2
    np.testing.assert_array_equal(np.isnan(total), np.isnan(want))
    np.testing.assert_allclose(total, want, **BAG_TOL)


@pytest.mark.parametrize("combiner", ["mean", "sum"])
@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_range_bag_grad_plain_matches_jax_vjp(model_size, combiner):
    """Each shard's bag gradient, stacked in model order, equals jax.vjp of
    multihot_embedding_lookup on the whole padded table (ids outside it add
    nothing; the gradient may be a strided view)."""
    import jax
    import jax.numpy as jnp

    from nvtabular_tpu.models.layers import multihot_embedding_lookup

    table, values, mask, ct = _bags(seed=1)
    keep = np.ones(len(values), bool)
    keep[[4, 5]] = False  # their bags are NaN, and so would be their rows' gradient through the forward
    _, vjp = jax.vjp(lambda tab: multihot_embedding_lookup(tab, jnp.asarray(values[keep]), jnp.asarray(mask[keep]),
                                                           combiner), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(ct[keep]))
    vp, rows = table.shape[0], table.shape[0] // model_size
    buf = torch.zeros((len(values), 3 * table.shape[1]))
    buf[:, 6:12] = t(ct)
    got = [kbag.range_bag_grad(buf[keep][:, 6:12], t(values[keep]), t(mask[keep]), m * rows, rows, vp, combiner)
           for m in range(model_size)]
    np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(want), **BAG_TOL)
    # the out-of-table ids of rows 4 and 5 add nothing
    full = [kbag.range_bag_grad(t(ct), t(values), t(mask), m * rows, rows, vp, combiner) for m in range(model_size)]
    lone = np.zeros_like(table)
    for b in (4, 5):
        for l in range(4):
            v = int(values[b, l]) % vp if -vp <= values[b, l] < vp else None
            if v is not None:
                scale = mask[b, l] / (max(mask[b].sum(), 1.0) if combiner == "mean" else 1.0)
                lone[v] += ct[b] * scale
    np.testing.assert_allclose(torch.cat(full).numpy(), np.asarray(want) + lone, **BAG_TOL)


@pytest.mark.parametrize("combiner", ["mean", "sum"])
@pytest.mark.parametrize("vp,dim,b,hot", [(112, 64, 301, False), (116, 64, 301, False), (24, 16, 509, True)],
                         ids=["copies_at_limit", "global_past_limit", "one_hot_row"])
def test_range_bag_grad_plain_matches_jax_vjp_at_plan_edges(vp, dim, b, hot, combiner):
    """The four shards' bag gradients, stacked, against jax.vjp of
    multihot_embedding_lookup where the kernel's plan changes path (shards of
    28 and 29 rows of 64 floats: private copies, then global atomics,
    ``bag_grad_plan``), and with one row taking every id in range; rows 6-11
    are all-masked bags. Within 1e-5 of the sum of the terms' magnitudes
    (jax.vjp of |cotangent|): a hot row sums hundreds of terms in another
    order."""
    import jax
    import jax.numpy as jnp

    from nvtabular_tpu.models.layers import multihot_embedding_lookup

    table, values, mask, ct = _bags(seed=2, b=b, dim=dim, vp=vp)
    rows = vp // 4
    if hot:  # every id in range on one row of shard 1, half of them through its negative alias
        hot_row = rows + 1
        values = np.where(np.abs(values) < vp, np.where(values < 0, hot_row - vp, hot_row), values).astype(np.int32)
    mask[6:12] = 0.0
    assert bool(kbag.bag_grad_plan(b, dim, rows, 4)[0]) == (rows * dim <= 28 * 64)
    keep = np.ones(b, bool)
    keep[[4, 5]] = False  # NaN bags, as above
    v, m = jnp.asarray(values[keep]), jnp.asarray(mask[keep])
    _, vjp = jax.vjp(lambda tab: multihot_embedding_lookup(tab, v, m, combiner), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(ct[keep]))
    (magnitude,) = vjp(jnp.abs(jnp.asarray(ct[keep])))
    buf = torch.zeros((b, 2 * dim + 3))
    buf[:, 3 : 3 + dim] = t(ct)  # a strided view at a 4-byte offset
    got = torch.cat([kbag.range_bag_grad(buf[keep][:, 3 : 3 + dim], t(values[keep]), t(mask[keep]), k * rows, rows,
                                         vp, combiner) for k in range(4)]).numpy()
    assert got.shape == table.shape
    assert (np.abs(got - np.asarray(want)) <= 1e-5 * np.asarray(magnitude) + 1e-6).all()
    if hot:
        assert np.abs(got).sum(axis=1).argmax() == hot_row


def _two_rank_bag_grads():
    """ShardedEmbeddingFeatures with a model group of two simulated in one
    process (a single-hot column and a multihot table): each rank's bag
    table gradient, stacked in model order, the whole table's bag gradient
    from the plain version, the last rank's features and the whole table's
    bags."""
    rng = np.random.default_rng(6)
    vp, dim, b = 24, 6, 41
    mh = rng.normal(size=(vp, dim)).astype(np.float32)
    single = rng.normal(size=(8, dim)).astype(np.float32)
    values = t(rng.integers(-vp, vp, (b, 3)).astype(np.int32))
    mask = t((rng.random((b, 3)) < 0.8).astype(np.float32))
    ids = [t(rng.integers(0, 8, b).astype(np.int32))]
    lead = torch.randn(b, dim, generator=torch.Generator().manual_seed(1))
    ct = torch.randn(b, 3, dim, generator=torch.Generator().manual_seed(2))
    total = torch.zeros((b, 2, dim))  # the group's sum of the two ranks' [b, C + M, D] buffers
    for m in range(2):
        emb = torch.empty((b, 2, dim))
        kemb.range_gather_columns(t(single[4 * m : 4 * m + 4]), ids, (0,), (4,), (4 * m,), (8,), m, out=emb[:, :1])
        kbag.range_bag(t(mh[12 * m : 12 * m + 12]), values, mask, 12 * m, vp, m, out=emb[:, 1])
        total += emb
    grads = []
    for m in range(2):
        shard = kemb.RowShard((0,), (4,), (4 * m,), (8,), m, reduce=lambda x: x.copy_(total),
                              bag_starts=(12 * m,), bag_padded=(vp,))
        local = t(mh[12 * m : 12 * m + 12]).requires_grad_(True)
        feats = kemb.sharded_embedding_features(lead, t(single[4 * m : 4 * m + 4]), ids, shard,
                                                [(local, values, mask)])
        torch.testing.assert_close(feats[:, 0], lead, rtol=0, atol=0)
        feats.backward(ct)
        grads.append(local.grad)
    want = kbag.range_bag_grad_plain(ct[:, 2], values, mask, 0, vp, vp)
    return torch.cat(grads), want, feats.detach(), kbag.embedding_bag_fwd_plain(t(mh), values, mask)


def test_sharded_bag_features_divide_after_the_sum_and_backward_is_not_summed():
    """The model group of two: the bag slot is the whole table's mean (the
    division after the sum), and the stacked gradient is the whole table's
    bag gradient, each rank's its own rows' share."""
    got, want, feats, want_bag = _two_rank_bag_grads()
    torch.testing.assert_close(feats[:, 2], want_bag, rtol=1e-6, atol=1e-6, equal_nan=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_summed_cotangent_mutation_fails_the_bag_gradient_check(monkeypatch):
    """The mutation check: a backward that sums the cotangent over the model
    group (here the two ranks' equal cotangents, twice one) makes each
    rank's bag gradient twice its share, and the comparison above fails."""
    backward = kemb.ShardedEmbeddingFeatures.backward

    def summed(ctx, grad):
        return backward(ctx, grad * 2)

    monkeypatch.setattr(kemb.ShardedEmbeddingFeatures, "backward", staticmethod(summed))
    got, want, _, _ = _two_rank_bag_grads()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, 2 * want, rtol=1e-6, atol=1e-6)
