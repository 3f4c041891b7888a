"""The multihot embedding bag (K13c) and the tabular MLP of
nvtabular_tpu_torch against the JAX reference, and the MovieLens multihot
slice whole: the config-1 workflow → DeviceLoader(sparse_max) → TabularMLP
→ Adagrad steps.

The same numpy inputs go through the JAX functions and the port, which
runs on the CPU through the plain versions of kernels K13a, K13c and K11.
Gradients are compared with ``jax.vjp`` / ``jax.grad``; parameters are
carried across with ``convert.load_tabular_mlp_params``. The CUDA kernels
are held against these plain versions in test_torch_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nvtabular_tpu as jnvt
import nvtabular_tpu_torch as pnvt
from nvtabular_tpu import ops as jops
from nvtabular_tpu.dag.executor import JitExecutor
from nvtabular_tpu.kernels import ragged as jragged
from nvtabular_tpu.loader import DeviceLoader as JDeviceLoader
from nvtabular_tpu.models import layers as jlayers
from nvtabular_tpu.models import tabular_mlp as jtab
from nvtabular_tpu.models.training import make_step_fns
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.kernels import LAUNCHES
from nvtabular_tpu_torch.kernels import ragged as pragged
from nvtabular_tpu_torch.loader import DeviceLoader

# the bag: the same float32 products and sums in the same order; the
# gradient's scatter-add sums its terms in another order
BAG_TOL = dict(rtol=1e-6, atol=1e-7)


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _bag_inputs(seed, v=23, d=16, b=300, L=4):
    """Padded multihot ids and mask: rows of 0..L values (row 0 all masked),
    a negative id (wraps once) in a real slot, and out-of-range ids (NaN
    rows) in a real slot of row 1 and a masked slot of row 2."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    lengths = rng.integers(0, L + 1, b)
    lengths[:4] = [0, L, 1, L]
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    values = rng.integers(0, v, (b, L)).astype(np.int32)
    values[3, :] = [-1, -v, 5, v - 1]
    values[1, 2] = v + 9
    values[2, 3] = -v - 1
    cot = rng.normal(size=(b, d)).astype(np.float32)
    return table, values, mask, cot


@pytest.mark.parametrize("combiner", ["mean", "sum"])
def test_multihot_embedding_lookup_and_vjp_match_jax(combiner):
    """Forward exact (NaN rows included: an out-of-range id poisons its row
    even under a 0 mask) and the vjp to the table within rtol=1e-6,
    atol=1e-7, against multihot_embedding_lookup and its twin
    padded_embedding_bag."""
    table, values, mask, cot = _bag_inputs(1)
    jv, jm = jnp.asarray(values), jnp.asarray(mask)
    want, vjp = jax.vjp(lambda tb: jlayers.multihot_embedding_lookup(tb, jv, jm, combiner), jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(cot))
    np.testing.assert_array_equal(np.asarray(want), np.asarray(jragged.padded_embedding_bag(table, jv, jm, combiner)))

    pt = t(table).requires_grad_(True)
    got = pmodels.multihot_embedding_lookup(pt, t(values), t(mask), combiner)
    got.backward(t(cot))
    assert np.isnan(n(got)[1]).all() and np.isnan(n(got)[2]).all() and not np.isnan(n(got)[3:]).any()
    np.testing.assert_allclose(n(got), np.asarray(want), **BAG_TOL)
    np.testing.assert_allclose(n(pt.grad), np.asarray(want_grad), **BAG_TOL)
    assert sum(LAUNCHES.values()) == 0  # CPU tensors never launch a kernel


def _configs(**kwargs):
    single = {"userId": (900, 64), "movieId": (300, 64), "zip": (40, 16)}
    multi = {"genres": (23, 16), "tags": (60, 8)}
    common = dict(embedding_sizes=single, num_continuous=3, multihot_embedding_sizes=multi, **kwargs)
    return jtab.TabularMLPConfig(**common), pmodels.TabularMLPConfig(**common)


def _jax_params(jconfig, seed=0):
    return jax.tree.map(np.asarray, jtab.tabular_mlp_init(jax.random.PRNGKey(seed), jconfig))


def test_tabular_mlp_params_round_trip_and_layout():
    """One parameter a table in sorted column order, carried to and from
    the JAX pytree unchanged; the MLP input is JAX's concatenation order,
    padded to a multiple of 4 floats."""
    jconfig, pconfig = _configs(layer_sizes=(32, 16))
    model = pmodels.TabularMLP(pconfig, seed=3, device="cpu")
    assert [(name, start) for name, _, start in model.layout.tables] == [("movieId", 0), ("userId", 64), ("zip", 128)]
    assert [tuple(p.shape) for p in model.tables] == [(300, 64), (900, 64), (40, 16)]
    assert [(name, start) for name, _, start in model.layout.bags] == [("genres", 144), ("tags", 160)]
    assert (model.layout.cont_start, model.layout.input_dim, model.layout.width) == (168, 171, 172)
    params = _jax_params(jconfig)
    pnvt.load_tabular_mlp_params(model, params)
    back = pnvt.tabular_mlp_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="tables"):
        pnvt.load_tabular_mlp_params(model, {**params, "mh_tables": {"genres": params["mh_tables"]["genres"]}})


def test_tabular_mlp_init_distributions():
    """tabular_mlp_init's distributions from a torch.Generator: tables
    N(0, 1/dim), MLP weights N(0, 2/fan_in), zero biases, the shapes of the
    JAX pytree; the same seed gives the same parameters."""
    jconfig, pconfig = _configs()
    pconfig.embedding_sizes = {"a": (20_000, 64), "b": (9_000, 16)}
    jconfig.embedding_sizes = dict(pconfig.embedding_sizes)
    m1 = pmodels.TabularMLP(pconfig, seed=7, device="cpu")
    m2 = pmodels.TabularMLP(pconfig, seed=7, device="cpu")
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p1, p2)
    for name, (_, dim) in pconfig.embedding_sizes.items():
        table = m1.tables[m1.names.index(name)].detach()
        assert abs(float(table.std()) - dim**-0.5) < 0.02 * dim**-0.5 and abs(float(table.mean())) < 0.01
    w = m1.mlp.weights[0].detach()
    assert abs(float(w.std()) - (2.0 / w.shape[0]) ** 0.5) < 0.05 * (2.0 / w.shape[0]) ** 0.5
    assert all(float(b.detach().abs().max()) == 0.0 for b in m1.mlp.biases)
    shapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(lambda: jtab.tabular_mlp_init(jax.random.PRNGKey(0), jconfig)))
    assert jax.tree.map(lambda a: a.shape, pnvt.tabular_mlp_params(m1)) == shapes


def _batch(pconfig, b, seed):
    rng = np.random.default_rng(seed)
    batch = {"continuous": rng.normal(size=(b, pconfig.num_continuous)).astype(np.float32),
             "label": rng.integers(0, 2, b).astype(np.float32)}
    for name, (card, _) in pconfig.embedding_sizes.items():
        batch[name] = rng.integers(0, card, b).astype(np.int32)
    for name, (card, _) in pconfig.multihot_embedding_sizes.items():
        batch[f"{name}__values"] = rng.integers(0, card, (b, 4)).astype(np.int32)
        batch[f"{name}__mask"] = (np.arange(4)[None, :] < rng.integers(0, 5, b)[:, None]).astype(np.float32)
    return batch


def _jax_loss(params, batch):
    return jlayers.bce_with_logits(jtab.tabular_mlp_forward(params, batch).reshape(-1), batch["label"])


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_tabular_forward_loss_and_grads_match_jax(compute, monkeypatch):
    """tabular_mlp_forward, its loss and every gradient with the JAX
    parameters carried across. In float32 (mlp_apply's compute_dtype set to
    float32) only summation orders differ; in bfloat16 (as written) a hidden
    value that close to a rounding boundary could round the other way (none
    does at this size and seed)."""
    jconfig, pconfig = _configs(layer_sizes=(32, 16))
    params = _jax_params(jconfig)
    batch = _batch(pconfig, 512, seed=4)
    if compute == "float32":
        monkeypatch.setattr(jtab, "mlp_apply", functools.partial(jlayers.mlp_apply, compute_dtype=jnp.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, params)
    want_logits = np.asarray(jtab.tabular_mlp_forward(jp, jbatch))
    want_loss, want_grads = jax.value_and_grad(_jax_loss)(jp, jbatch)

    dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
    model = pmodels.TabularMLP(pconfig, device="cpu", compute_dtype=dtype)
    pnvt.load_tabular_mlp_params(model, params)
    pbatch = {k: t(v) for k, v in batch.items()}
    logits = model(pbatch)
    assert logits.shape == (512, 1)
    np.testing.assert_allclose(n(logits), want_logits, rtol=1e-5, atol=1e-5)
    loss = pmodels.tabular_mlp_loss(model, pbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    ref = pmodels.tabular_reference_forward(model, pbatch)  # the plain path, as the card checks it
    np.testing.assert_array_equal(n(ref), n(logits))

    got = {"tables": {}, "mh_tables": {}, "mlp": [{"w": n(w.grad), "b": n(b.grad)}
                                                   for w, b in zip(model.mlp.weights, model.mlp.biases)]}
    for p, name in zip(model.tables, model.names):
        got["tables"][name] = n(p.grad)
    for p, name in zip(model.mh_tables, model.mh_names):
        got["mh_tables"][name] = n(p.grad)
    limit = 1e-5 if compute == "float32" else 1e-4
    for (path, mine), want in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want_grads)):
        scale = float(np.abs(want).max())
        err = float(np.abs(mine - np.asarray(want)).max())
        assert err <= limit * scale, (jax.tree_util.keystr(path), err, scale)


def test_tabular_adagrad_steps_match_optax():
    """3 optimizer steps of the loss against make_step_fns(loss,
    optax.adagrad(1e-2)) from the same parameters, to 1e-5; optax's
    accumulators carried into the port's match after them."""
    jconfig, pconfig = _configs(layer_sizes=(32, 16))
    params = _jax_params(jconfig, seed=2)
    batches = [_batch(pconfig, 256, seed=s) for s in range(3)]
    opt = optax.adagrad(1e-2)
    step, _ = make_step_fns(_jax_loss, opt)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    want_losses = []
    for b in batches:
        jp, state, loss = step(jp, state, {k: jnp.asarray(v) for k, v in b.items()})
        want_losses.append(float(loss))

    model = pmodels.TabularMLP(pconfig, device="cpu")
    pnvt.load_tabular_mlp_params(model, params)
    popt = pmodels.Adagrad(model.parameters(), lr=1e-2)
    got_losses = [float(pmodels.train_step(model, popt, {k: t(v) for k, v in b.items()}, pmodels.tabular_mlp_loss))
                  for b in batches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    for got, want in zip(jax.tree.leaves(pnvt.tabular_mlp_params(model)), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    fresh = pmodels.TabularMLP(pconfig, device="cpu")
    fopt = pmodels.Adagrad(fresh.parameters(), lr=1e-2)
    sos = jax.tree.map(np.asarray, state[0].sum_of_squares)
    pnvt.load_tabular_mlp_params(fresh, jax.tree.map(np.asarray, jp), fopt, sos)
    for p, q in zip(model.parameters(), fresh.parameters()):
        np.testing.assert_allclose(n(fopt.accumulator(q)), n(popt.accumulator(p)), rtol=1e-5)


def _movielens_part(seed, rows=3000):
    """MovieLens-shaped, as chip_smoke.make_movielens_part draws it at a
    small key space: 1-4 genre ids of 20 per row."""
    r = np.random.default_rng(seed)
    lengths = r.integers(1, 5, rows)
    offsets = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return {
        "userId": r.zipf(1.2, rows).clip(1, 1500).astype(np.int64),
        "movieId": r.zipf(1.1, rows).clip(1, 400).astype(np.int64),
        "genres": (r.integers(1, 21, int(offsets[-1])).astype(np.int64), offsets),
        "rating": (r.integers(1, 11, rows) / 2.0).astype(np.float32),
        "ts_delta": r.exponential(86400.0, rows).astype(np.float32),
    }


def _table(mod, part):
    return mod.TableBatch({k: mod.Column(*v) if isinstance(v, tuple) else mod.Column(v) for k, v in part.items()})


def _config1(ops, **kw):
    cats = ["userId", "movieId", "genres"] >> ops.Categorify(**kw)
    conts = ["ts_delta"] >> ops.LogOp() >> ops.Normalize()
    label = ["rating"] >> ops.LambdaOp(lambda col: (np.asarray(col) > 3).astype(np.float32))
    return cats + conts + label


def test_slice_whole_config1_loader_tabular_mlp_adagrad(tmp_path):
    """The config-1 workflow with the binarized label, fitted by each
    package → DeviceLoader(shuffle=False, sparse_max={"genres": 4}) →
    TabularMLP (JAX parameters carried across; ``continuous`` is the
    loader's ``dense``) → 3 Adagrad(1e-2) steps, against the same chain in
    JAX: losses and updated tables to 1e-5 (the continuous input differs by
    log1p ULPs; bfloat16 compute on both sides)."""
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
    single, multi = pops.get_embedding_sizes(pwf)
    assert (single, multi) == jops.categorify.get_embedding_sizes(jwf) and multi == {"genres": (23, 16)}
    kwargs = dict(embedding_sizes=single, num_continuous=1, multihot_embedding_sizes=multi, layer_sizes=(64, 32))
    params = _jax_params(jtab.TabularMLPConfig(**kwargs))

    opt = optax.adagrad(1e-2)
    step, _ = make_step_fns(_jax_loss, opt)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    want_losses = []
    for b in jbatches:
        jp, state, loss = step(jp, state, {**b, "continuous": b["dense"]})
        want_losses.append(float(loss))

    model = pmodels.TabularMLP(pmodels.TabularMLPConfig(**kwargs), device="cpu")
    pnvt.load_tabular_mlp_params(model, params)
    popt = pmodels.Adagrad(model.parameters(), lr=1e-2)
    got_losses = [float(pmodels.train_step(model, popt, {**b, "continuous": b["dense"]}, pmodels.tabular_mlp_loss))
                  for b in pbatches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    got = pnvt.tabular_mlp_params(model)
    for kind in ("tables", "mh_tables"):
        for name, want in jp[kind].items():
            np.testing.assert_allclose(got[kind][name], np.asarray(want), rtol=1e-5, atol=1e-6, err_msg=name)


def test_tabular_mlp_reads_continuous_and_defaults_to_cuda():
    _, pconfig = _configs(layer_sizes=(8,))
    model = pmodels.TabularMLP(pconfig, device="cpu")
    batch = {k: t(v) for k, v in _batch(pconfig, 16, seed=1).items()}
    batch["dense"] = batch.pop("continuous")
    with pytest.raises(ValueError, match="continuous"):
        model(batch)
    if torch.cuda.is_available():
        assert next(pmodels.TabularMLP(pconfig).parameters()).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmodels.TabularMLP(pconfig)


@pytest.mark.parametrize(
    "call",
    [
        lambda: pmodels.multihot_embedding_lookup(torch.zeros(3, 4), torch.zeros((2, 2), dtype=torch.int64),
                                                  torch.ones(2, 2)),
        lambda: pmodels.multihot_embedding_lookup(torch.zeros(3, 4), torch.zeros((2, 2), dtype=torch.int32),
                                                  torch.ones(2, 3)),
        lambda: pmodels.multihot_embedding_lookup(torch.zeros(3, 4), torch.zeros((2, 2), dtype=torch.int32),
                                                  torch.ones(2, 2), combiner="max"),
        lambda: pragged.ragged_to_padded(torch.zeros(4, dtype=torch.int32), torch.tensor([0, 4], dtype=torch.int32), 2),
        lambda: pragged.ragged_to_padded(torch.zeros(4, dtype=torch.bool), torch.tensor([0, 4]), 2),
        lambda: pragged.ragged_slice_padded(torch.zeros(4, dtype=torch.int32), torch.tensor([0, 4]), 0, 3, -1),
    ],
    ids=["int64_ids", "mask_shape", "combiner", "int32_offsets", "bool_values", "negative_width"],
)
def test_bag_and_ragged_wrappers_reject_wrong_inputs(call):
    """The wrappers check what their kernels take on every device."""
    with pytest.raises((TypeError, ValueError)):
        call()
