"""Model layers, DLRM and Adagrad of nvtabular_tpu_torch against the JAX reference.

The same numpy inputs go through the JAX functions and the port, which runs
on the CPU through the plain versions of kernels K13a (embedding gather and
its scatter-add gradient) and K13b (dot interaction and its gradient).
Gradients are compared with ``jax.vjp`` for the same output cotangent. The
CUDA kernels are held against these plain versions in test_torch_gpu.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nvtabular_tpu_torch as pnvt
from nvtabular_tpu.models import dlrm as jdlrm
from nvtabular_tpu.models import layers as jlayers
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch import parallel as par
from nvtabular_tpu_torch.kernels import LAUNCHES
from nvtabular_tpu_torch.kernels.embedding import embedding_features
from nvtabular_tpu_torch.kernels.interaction import dot_interaction

# float32 sums in another order (XLA's CPU dot / scatter-add vs PyTorch's
# bmm / index_add_): a few ULPs of the largest term
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _ids(rng, v, b, out_of_range):
    ids = rng.integers(0, v, b).astype(np.int32)
    if out_of_range:  # jnp.take: -1 wraps to v - 1, -v to 0; v, -v - 1 and beyond read NaN
        ids[:6] = [v, v + 7, -1, -v, -v - 1, 2**31 - 1]
    return ids


@pytest.mark.parametrize("out_of_range", [False, True], ids=["in_range", "out_of_range"])
def test_embedding_lookup_and_grad_match_jax(out_of_range):
    rng = np.random.default_rng(0)
    v, d, b = 37, 8, 300
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = _ids(rng, v, b, out_of_range)
    cot = rng.normal(size=(b, d)).astype(np.float32)

    want, vjp = jax.vjp(lambda tb: jlayers.embedding_lookup(tb, jnp.asarray(ids)), jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(cot))

    pt = t(table).requires_grad_(True)
    got = pmodels.embedding_lookup(pt, t(ids))
    got.backward(t(cot))
    np.testing.assert_array_equal(n(got), np.asarray(want))  # a gather: exact, NaN rows included
    np.testing.assert_allclose(n(pt.grad), np.asarray(want_grad), **F32_TOL)
    assert sum(LAUNCHES.values()) == 0  # CPU tensors never launch a kernel


@pytest.mark.parametrize("out_of_range", [False, True], ids=["in_range", "out_of_range"])
def test_embedding_features_match_jax_stack(out_of_range):
    """The DLRM feature block: [lead, take(T_c, ids_c) for each column] from
    one concatenated table, against jnp.stack of per-table takes."""
    rng = np.random.default_rng(1)
    sizes, d, b = [3, 50, 11, 200], 16, 257
    tables = [rng.normal(size=(s, d)).astype(np.float32) for s in sizes]
    ids = [_ids(rng, s, b, out_of_range and c == 1) for c, s in enumerate(sizes)]
    lead = rng.normal(size=(b, d)).astype(np.float32)
    cot = rng.normal(size=(b, 1 + len(sizes), d)).astype(np.float32)

    def jfeats(lead, *tabs):
        return jnp.stack([lead] + [jnp.take(tb, jnp.asarray(i), axis=0) for tb, i in zip(tabs, ids)], axis=1)

    want, vjp = jax.vjp(jfeats, jnp.asarray(lead), *[jnp.asarray(x) for x in tables])
    want_grads = vjp(jnp.asarray(cot))

    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    pl = t(lead).requires_grad_(True)
    pt = t(np.concatenate(tables)).requires_grad_(True)
    got = embedding_features(pl, pt, [t(i) for i in ids], offsets, sizes)
    got.backward(t(cot))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(n(pl.grad), np.asarray(want_grads[0]))
    np.testing.assert_allclose(n(pt.grad), np.concatenate([np.asarray(g) for g in want_grads[1:]]), **F32_TOL)


@pytest.mark.parametrize("f,d", [(5, 8), (27, 16), (28, 12), (2, 64), (27, 66), (27, 300), (65, 128)])
def test_dot_product_interaction_and_vjp_match_jax(f, d):
    """rtol 1e-5: float32 dots of d terms summed in another order. (28, 12)
    and (2, 64) are where the backward kernel's plan takes four row blocks
    of 8 and 3 column chunks, or one block and 16 chunks (bwd_plan); (27,
    66), (27, 300) and (65, 128) where a sample's items pass the block's
    threads (one sample a group). Past 64 terms a dot the rounding of a
    float32 sum of d unit-sized products reaches 1e-5 on its own (about
    sqrt(d) 2**-24 sqrt(d) at d = 300), so those cases hold each entry
    within 1e-5 of the sum of its terms' magnitudes plus 1e-6 (the same
    inputs' absolute values through the reference), as the layer tests
    do."""
    rng = np.random.default_rng(2)
    b = 96
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    cot = rng.normal(size=(b, f * (f - 1) // 2)).astype(np.float32)
    want, vjp = jax.vjp(jlayers.dot_product_interaction, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))

    px = t(x).requires_grad_(True)
    got = pmodels.dot_product_interaction(px)
    got.backward(t(cot))
    if d <= 64:
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(n(px.grad), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
        return
    mag, mvjp = jax.vjp(jlayers.dot_product_interaction, jnp.abs(jnp.asarray(x)))
    (mag_dx,) = mvjp(jnp.abs(jnp.asarray(cot)))
    assert (np.abs(n(got) - np.asarray(want)) <= 1e-5 * np.asarray(mag) + 1e-6).all()
    assert (np.abs(n(px.grad) - np.asarray(want_dx)) <= 1e-5 * np.asarray(mag_dx) + 1e-6).all()


def test_interaction_with_lead_matches_jax_concatenate():
    """DLRM's top input: [bottom_out, interaction(feats)] in one buffer."""
    rng = np.random.default_rng(3)
    b, f, d = 64, 6, 8
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    lead = rng.normal(size=(b, d)).astype(np.float32)
    cot = rng.normal(size=(b, d + f * (f - 1) // 2)).astype(np.float32)

    def jtop(x, lead):
        return jnp.concatenate([lead, jlayers.dot_product_interaction(x)], axis=1)

    want, vjp = jax.vjp(jtop, jnp.asarray(x), jnp.asarray(lead))
    want_dx, want_dlead = vjp(jnp.asarray(cot))
    px, pl = t(x).requires_grad_(True), t(lead).requires_grad_(True)
    got = dot_interaction(px, pl)
    got.backward(t(cot))
    np.testing.assert_allclose(n(got), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(n(px.grad), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(n(pl.grad), np.asarray(want_dlead))


def _mlp_pair(rng, sizes, final_activation, compute_dtype):
    jparams = jlayers.mlp_init(jax.random.PRNGKey(int(rng.integers(1 << 30))), sizes)
    mlp = pmodels.MLP(sizes, final_activation=final_activation, compute_dtype=compute_dtype, device="cpu")
    with torch.no_grad():
        for w, b, layer in zip(mlp.weights, mlp.biases, jparams):
            w.copy_(t(layer["w"]))
            b.copy_(t(rng.normal(size=layer["b"].shape).astype(np.float32) * 0.1))
            layer["b"] = jnp.asarray(n(b))
    return jparams, mlp


@pytest.mark.parametrize("final_activation", [False, True])
def test_mlp_float32_matches_jax(final_activation):
    """compute_dtype float32: the only difference is the order of the
    float32 sums (rtol 1e-5)."""
    rng = np.random.default_rng(4)
    sizes = [13, 64, 32, 16]
    jparams, mlp = _mlp_pair(rng, sizes, final_activation, torch.float32)
    x = rng.normal(size=(200, 13)).astype(np.float32)
    want = jlayers.mlp_apply(jparams, jnp.asarray(x), final_activation=final_activation, compute_dtype=jnp.float32)
    np.testing.assert_allclose(n(mlp(t(x))), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mlp_bfloat16_matches_jax():
    """compute_dtype bfloat16 (mlp_apply's default). Products of bfloat16
    values are exact in float32 on both sides, so the sums differ only in
    order (~1e-7 relative); but where a hidden value lies that close to a
    bfloat16 rounding boundary the two round it to neighbouring values,
    2**-8 apart relative. A flip moves an output by well under 1e-3 (none
    occurs at this size and seed); almost every output agrees to float32
    precision."""
    rng = np.random.default_rng(5)
    sizes = [13, 128, 64, 1]
    jparams, mlp = _mlp_pair(rng, sizes, False, torch.bfloat16)
    x = rng.normal(size=(2000, 13)).astype(np.float32)
    want = np.asarray(jlayers.mlp_apply(jparams, jnp.asarray(x)))
    got = n(mlp(t(x)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert close.mean() > 0.99, close.mean()


def _config_pair(**kwargs):
    cards = {"b": 40, "a": 7, "c": 300}
    return (
        jdlrm.DLRMConfig(cardinalities=cards, num_dense=5, **kwargs),
        pmodels.DLRMConfig(cardinalities=cards, num_dense=5, **kwargs),
    )


def _jax_params(jconfig, seed=0):
    return jax.tree.map(np.asarray, jdlrm.dlrm_init(jax.random.PRNGKey(seed), jconfig))


def test_dlrm_params_round_trip_and_shapes():
    jconfig, pconfig = _config_pair(embedding_dim=8, bottom_mlp=(16,), top_mlp=(16, 8))
    model = pmodels.DLRM(pconfig, seed=3, device="cpu")
    assert model.names == ["a", "b", "c"] and model.offsets == [0, 7, 47]
    assert tuple(model.table.shape) == (347, 8)
    params = _jax_params(jconfig)
    pnvt.load_dlrm_params(model, params)
    back = pnvt.dlrm_params(model)
    for name in params["tables"]:
        np.testing.assert_array_equal(back["tables"][name], params["tables"][name])
    for side in ("bottom", "top"):
        for got, want in zip(back[side], params[side]):
            np.testing.assert_array_equal(got["w"], want["w"])
            np.testing.assert_array_equal(got["b"], want["b"])
    with pytest.raises(ValueError, match="tables"):
        pnvt.load_dlrm_params(model, {**params, "tables": {"a": params["tables"]["a"]}})


def test_load_dlrm_params_carries_adagrad_state():
    """optax's sum_of_squares lands in the port's accumulators, table rows
    in sorted column order."""
    jconfig, pconfig = _config_pair(embedding_dim=4, bottom_mlp=(8,), top_mlp=(8,))
    params = _jax_params(jconfig)
    rng = np.random.default_rng(9)
    sos = jax.tree.map(lambda a: (rng.random(a.shape) + 0.1).astype(np.float32), params)
    model = pmodels.DLRM(pconfig, device="cpu")
    opt = pmodels.Adagrad(model.parameters(), lr=1e-2)
    pnvt.load_dlrm_params(model, params, opt, sos)
    np.testing.assert_array_equal(
        n(opt.accumulator(model.table)), np.concatenate([sos["tables"][k] for k in ("a", "b", "c")])
    )
    np.testing.assert_array_equal(n(opt.accumulator(model.top.weights[1])), sos["top"][1]["w"])


def test_dlrm_init_distributions():
    """dlrm_init's distributions from a torch.Generator: tables N(0, 1/D),
    MLP weights N(0, 2/fan_in), zero biases; the same seed gives the same
    parameters."""
    _, pconfig = _config_pair(embedding_dim=16)
    pconfig.cardinalities = {"a": 20_000, "b": 30_000}
    m1 = pmodels.DLRM(pconfig, seed=7, device="cpu")
    m2 = pmodels.DLRM(pconfig, seed=7, device="cpu")
    assert torch.equal(m1.table, m2.table)
    table = m1.table.detach()
    assert abs(float(table.std()) - 0.25) < 0.01 and abs(float(table.mean())) < 0.01
    w = m1.top.weights[0].detach()
    assert abs(float(w.std()) - (2.0 / w.shape[0]) ** 0.5) < 0.05 * (2.0 / w.shape[0]) ** 0.5
    assert all(float(b.abs().max()) == 0.0 for b in m1.top.biases)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_dlrm_forward_loss_and_grads_match_jax(compute, monkeypatch):
    """dlrm_loss and its gradient with the JAX parameters carried across.
    In float32 (the JAX forward with mlp_apply's compute_dtype set to
    float32) only summation orders differ; in bfloat16 (dlrm_forward as
    written) a rounding flip of a hidden value would add a difference of
    up to ~1e-4 relative to the largest gradient entry (none occurs at this
    size and seed: the largest difference is 5e-8 of it)."""
    jconfig, pconfig = _config_pair(embedding_dim=8, bottom_mlp=(32, 16), top_mlp=(32, 16))
    params = _jax_params(jconfig)
    batch = jdlrm.make_synthetic_batch(jconfig, 512, seed=4)
    dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
    if compute == "float32":
        monkeypatch.setattr(jdlrm, "mlp_apply", functools.partial(jlayers.mlp_apply, compute_dtype=jnp.float32))
    loss_fn = jdlrm.dlrm_loss
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params), jbatch)

    model = pmodels.DLRM(pconfig, device="cpu", compute_dtype=dtype)
    pnvt.load_dlrm_params(model, params)
    loss = pmodels.dlrm_loss(model, {k: t(v) for k, v in batch.items()})
    loss.backward()

    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got_grads = {
        "tables": np.concatenate([np.asarray(want_grads["tables"][k]) for k in model.names]),
        "top0": np.asarray(want_grads["top"][0]["w"]),
        "bottom0": np.asarray(want_grads["bottom"][0]["w"]),
    }
    mine = {"tables": n(model.table.grad), "top0": n(model.top.weights[0].grad),
            "bottom0": n(model.bottom.weights[0].grad)}
    for key, want in got_grads.items():
        scale = float(np.abs(want).max())
        err = float(np.abs(mine[key] - want).max())
        limit = 1e-5 if compute == "float32" else 1e-4
        assert err <= limit * scale, (key, err, scale)


def test_adagrad_matches_optax_over_three_steps():
    """optax.adagrad(1e-2): accumulator from 0.1, eps inside the rsqrt.
    Rows with a zero gradient stay as they were. rtol 1e-6: rsqrt and the
    fused multiply-adds may round differently in the last bit."""
    rng = np.random.default_rng(6)
    params = {"table": rng.normal(size=(50, 4)).astype(np.float32), "w": rng.normal(size=(7,)).astype(np.float32)}
    grads = []
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        g["table"][rng.random(50) < 0.5] = 0.0
        grads.append(g)

    opt = optax.adagrad(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    pp = {k: t(v.copy()) for k, v in params.items()}
    popt = pmodels.Adagrad(pp.values(), lr=1e-2)
    for g in grads:
        for k, p in pp.items():
            p.grad = t(g[k])
        popt.step()
    sos = state[0].sum_of_squares
    for k in params:
        np.testing.assert_allclose(n(pp[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(n(popt.accumulator(pp[k])), np.asarray(sos[k]), rtol=1e-6)
    untouched = np.all([np.all(g["table"] == 0, axis=1) for g in grads], axis=0)
    np.testing.assert_array_equal(n(pp["table"])[untouched], params["table"][untouched])


def test_roc_auc_matches_jax_package():
    from nvtabular_tpu.models.training import roc_auc as jroc

    rng = np.random.default_rng(8)
    labels = rng.integers(0, 2, 5000)
    scores = np.round(rng.normal(size=5000) + labels * 0.5, 1)  # ties
    assert pmodels.roc_auc(labels, scores) == jroc(labels, scores)


def test_train_chunk_equals_train_steps():
    _, pconfig = _config_pair(embedding_dim=8, bottom_mlp=(16,), top_mlp=(16,))
    chunk = {k: t(v) for k, v in pmodels.make_synthetic_batch(pconfig, 300, seed=1).items()}
    m1 = pmodels.DLRM(pconfig, seed=1, device="cpu")
    m2 = pmodels.DLRM(pconfig, seed=1, device="cpu")
    o1, o2 = pmodels.Adagrad(m1.parameters()), pmodels.Adagrad(m2.parameters())
    losses = pmodels.train_chunk(m1, o1, chunk, 128)
    assert losses.shape == (2,)
    want = [pmodels.train_step(m2, o2, {k: v[s : s + 128] for k, v in chunk.items()}) for s in (0, 128)]
    assert torch.equal(losses, torch.stack(want))
    assert torch.equal(m1.table, m2.table)


@pytest.mark.parametrize(
    "call",
    [
        # the reference's own dlrm_forward fails for self_interaction=True;
        # multihot tables, their sharding, the self-interaction layer and the
        # CIN layer are ported (test_torch_dlrm_multihot.py, test_torch_layers.py)
        lambda: pmodels.DLRM(_config_pair()[1].__class__({"a": 3}, 1, self_interaction=True), device="cpu"),
    ],
    ids=["dlrm_self_interaction"],
)
def test_unported_model_parts_raise(call):
    with pytest.raises(ValueError, match="reference's own dlrm_forward fails.*ROADMAP.md §3"):
        call()


def test_dlrm_default_device_is_cuda():
    _, pconfig = _config_pair(embedding_dim=4)
    if torch.cuda.is_available():
        assert pmodels.DLRM(pconfig).table.device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmodels.DLRM(pconfig)
