"""The JAX package's functional model entry points in nvtabular_tpu_torch:
``*_init`` / ``*_forward`` of DLRM (whole and with multihot tables),
DeepFM, DCN-v2 and the tabular MLP, ``mlp_init`` / ``mlp_apply``,
``make_step_fns`` and ``make_chunk_train_fn`` with ``adagrad``, and
``convert.params_from_jax``, against the JAX package on the CPU.

A JAX params tree is carried across leaf by leaf (``params_from_jax``) and
the same seeded numpy batches go through both packages; the port runs its
kernels' plain versions here. Tolerances are the module tests' (bfloat16
compute on both sides, float32 sums in another order): the loss within
rtol 1e-5, the logits within 1e-3 (a value that close to a bfloat16
rounding boundary may round the other way on the two sides), and after
Adagrad steps the losses within rtol 1e-5 and every parameter and
accumulator within rtol 1e-5, atol 1e-6 (test_torch_deepfm.py,
test_torch_models.py, test_torch_tabular.py). The functional path and the
module path run one forward, so on the CPU they agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nvtabular_tpu_torch as pnvt
from nvtabular_tpu.models import deepfm as jdeepfm
from nvtabular_tpu.models import dlrm as jdlrm
from nvtabular_tpu.models import layers as jlayers
from nvtabular_tpu.models import tabular_mlp as jtab
from nvtabular_tpu.models.training import make_chunk_train_fn as jax_chunk_fn
from nvtabular_tpu.models.training import make_step_fns as jax_step_fns
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch.models.pytree import tree_leaves, tree_map

CARDS = {"b": 40, "a": 7, "c": 300}


def _jax_tabular_loss(params, batch):
    return jlayers.bce_with_logits(jtab.tabular_mlp_forward(params, batch), batch["label"])


def _dlrm_batch(config, b, seed):
    return pmodels.make_synthetic_batch(config, b, seed=seed)


def _tabular_batch(config, b, seed):
    rng = np.random.default_rng(seed)
    batch = {"continuous": rng.normal(size=(b, config.num_continuous)).astype(np.float32),
             "label": rng.integers(0, 2, b).astype(np.float32)}
    for name, (card, _) in config.embedding_sizes.items():
        batch[name] = rng.integers(0, card, b).astype(np.int32)
    for name, (card, _) in config.multihot_embedding_sizes.items():
        batch[f"{name}__values"] = rng.integers(0, card, (b, 4)).astype(np.int32)
        batch[f"{name}__mask"] = (np.arange(4)[None, :] < rng.integers(0, 5, b)[:, None]).astype(np.float32)
    return batch


def _table_batch(config, b, seed):
    rng = np.random.default_rng(seed)
    batch = {"dense": rng.normal(size=(b, config.num_dense)).astype(np.float32),
             "label": rng.integers(0, 2, b).astype(np.float32)}
    for name, card in config.cardinalities.items():
        batch[name] = rng.integers(0, card, b).astype(np.int32)
    return batch


# name: (JAX config, port config, the config's arguments, JAX init, forward, loss, port init, forward, loss,
#        the module, the batch)
FAMILIES = {
    "dlrm": (jdlrm.DLRMConfig, pmodels.DLRMConfig, dict(cardinalities=CARDS, num_dense=5, embedding_dim=8,
                                                         bottom_mlp=(16,), top_mlp=(16, 8)),
             jdlrm.dlrm_init, jdlrm.dlrm_forward, jdlrm.dlrm_loss,
             pmodels.dlrm_init, pmodels.dlrm_forward, pmodels.dlrm_loss, pmodels.DLRM, _dlrm_batch),
    "dlrm_multihot": (jdlrm.DLRMConfig, pmodels.DLRMConfig,
                      dict(cardinalities=CARDS, num_dense=5, embedding_dim=8, bottom_mlp=(16,), top_mlp=(16,),
                           multihot_cardinalities={"g": 23, "m": 60}, multihot_max_len=4),
                      jdlrm.dlrm_init, jdlrm.dlrm_forward, jdlrm.dlrm_loss,
                      pmodels.dlrm_init, pmodels.dlrm_forward, pmodels.dlrm_loss, pmodels.DLRM, _dlrm_batch),
    "deepfm": (jdeepfm.DeepFMConfig, pmodels.DeepFMConfig, dict(cardinalities=CARDS, num_dense=5, embedding_dim=8,
                                                                deep_mlp=(16,)),
               jdeepfm.deepfm_init, jdeepfm.deepfm_forward, jdeepfm.deepfm_loss,
               pmodels.deepfm_init, pmodels.deepfm_forward, pmodels.deepfm_loss, pmodels.DeepFM, _table_batch),
    "dcn": (jdeepfm.DCNConfig, pmodels.DCNConfig, dict(cardinalities=CARDS, num_dense=5, embedding_dim=8,
                                                       deep_mlp=(16,), num_cross_layers=2),
            jdeepfm.dcn_init, jdeepfm.dcn_forward, jdeepfm.dcn_loss,
            pmodels.dcn_init, pmodels.dcn_forward, pmodels.dcn_loss, pmodels.DCN, _table_batch),
    "tabular": (jtab.TabularMLPConfig, pmodels.TabularMLPConfig,
                dict(embedding_sizes={"userId": (90, 16), "movieId": (30, 16), "zip": (40, 8)}, num_continuous=3,
                     multihot_embedding_sizes={"genres": (23, 8)}, layer_sizes=(32, 16)),
                jtab.tabular_mlp_init, jtab.tabular_mlp_forward, _jax_tabular_loss,
                pmodels.tabular_mlp_init, pmodels.tabular_mlp_forward, pmodels.tabular_mlp_loss, pmodels.TabularMLP,
                _tabular_batch),
}


class Family:
    def __init__(self, name):
        (self.jconfig_cls, self.pconfig_cls, self.kwargs, self.jinit, self.jforward, self.jloss, self.pinit,
         self.pforward, self.ploss, self.module, self.make_batch) = FAMILIES[name]
        self.jconfig, self.pconfig = self.jconfig_cls(**self.kwargs), self.pconfig_cls(**self.kwargs)

    def jax_params(self, seed=0):
        return jax.tree.map(np.asarray, self.jinit(jax.random.PRNGKey(seed), self.jconfig))

    def batch(self, b, seed):
        return self.make_batch(self.pconfig, b, seed)


def t(a):
    return torch.from_numpy(np.array(a))


def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(np.shape(a)), str(np.asarray(a).dtype)), tree)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_tree_has_the_jax_keys_nesting_and_shapes(family):
    """``*_init`` gives JAX's tree: its keys, its nesting (dicts of tables,
    lists of ``{"w", "b"}`` layers), its leaf shapes and float32; a seed and
    a generator seeded alike draw the same values."""
    fam = Family(family)
    want = fam.jax_params()
    got = fam.pinit(3, fam.pconfig, device="cpu")
    assert _shapes(tree_map(lambda x: x.numpy(), got)) == _shapes(want)
    assert jax.tree.structure(tree_map(lambda x: x.numpy(), got)) == jax.tree.structure(want)
    again = fam.pinit(torch.Generator().manual_seed(3), fam.pconfig)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(again)))
    assert all(not leaf.requires_grad for leaf in tree_leaves(got))


def test_mlp_init_and_apply_match_jax():
    """``mlp_init``'s tree is JAX's (shapes, He normal scale); ``mlp_apply``
    of a carried-across JAX stack equals JAX's within the module tests'
    bfloat16 limit (1e-3), and in float32 compute within 1e-5."""
    sizes = [13, 32, 16, 1]
    jparams = jax.tree.map(np.asarray, jlayers.mlp_init(jax.random.PRNGKey(0), sizes))
    got = pmodels.mlp_init(0, sizes, device="cpu")
    assert _shapes(tree_map(lambda x: x.numpy(), got)) == _shapes(jparams)
    big = pmodels.mlp_init(torch.Generator().manual_seed(1), [4096, 64])
    assert abs(float(big[0]["w"].std()) - (2 / 4096) ** 0.5) < 0.02 * (2 / 4096) ** 0.5
    assert not bool(big[0]["b"].any())
    x = np.random.default_rng(2).normal(size=(64, 13)).astype(np.float32)
    params = pnvt.params_from_jax(jparams, device="cpu")
    for dtype, jdtype, tol in ((torch.bfloat16, jnp.bfloat16, 1e-3), (torch.float32, jnp.float32, 1e-5)):
        for final in (False, True):
            want = np.asarray(jlayers.mlp_apply(jparams, jnp.asarray(x), final_activation=final, compute_dtype=jdtype))
            out = pmodels.mlp_apply(params, t(x), final_activation=final, compute_dtype=dtype)
            np.testing.assert_allclose(out.numpy(), want, rtol=tol, atol=tol)


def test_params_from_jax_keeps_dtypes_and_shapes():
    """Leaf by leaf: float32, bfloat16 (numpy's extension type, by its bits)
    and 0-d leaves, copied (the JAX arrays stay as they are)."""
    tree = {"a": [{"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)}], "b": jnp.asarray([1.5, -2.0], jnp.bfloat16),
            "c": np.float32(4.0)}
    got = pnvt.params_from_jax(tree, device="cpu")
    assert got["a"][0]["w"].dtype == torch.float32 and got["a"][0]["w"].shape == (2, 3)
    assert got["b"].dtype == torch.bfloat16 and got["b"].tolist() == [1.5, -2.0]
    assert got["c"].shape == () and float(got["c"]) == 4.0
    got["a"][0]["w"].add_(1)
    assert float(tree["a"][0]["w"][0, 0]) == 0.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_from_a_jax_tree_matches_jax(family):
    """``*_forward`` of a JAX tree carried across against JAX's forward on
    one batch: logits within 1e-3, the loss within rtol 1e-5 (module
    tests' limits), the gradient of every leaf within 1e-4 of its largest
    entry (test_torch_deepfm.py's bfloat16 limit)."""
    fam = Family(family)
    params = fam.jax_params(seed=1)
    batch = fam.batch(256, seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    want_loss, want_grads = jax.value_and_grad(fam.jloss)(jparams, jbatch)
    want_logits = np.asarray(fam.jforward(jparams, jbatch))

    pparams = tree_map(lambda x: x.requires_grad_(True), pnvt.params_from_jax(params, device="cpu"))
    pbatch = {k: t(v) for k, v in batch.items()}
    logits = fam.pforward(pparams, pbatch)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-3, atol=1e-3)
    loss = fam.ploss(pparams, pbatch)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    loss.backward()
    for got, want in zip(tree_leaves(pparams), jax.tree.leaves(want_grads)):
        want = np.asarray(want)
        assert got.grad.shape == want.shape
        assert float(np.abs(got.grad.numpy() - want).max()) <= 1e-4 * max(float(np.abs(want).max()), 1e-30)


def _jax_steps(fam, params, batches):
    opt = optax.adagrad(1e-2)
    step, _ = jax_step_fns(fam.jloss, opt)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    losses = []
    for b in batches:
        jp, state, loss = step(jp, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return jp, state[0].sum_of_squares, losses


def _assert_trees_close(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_make_step_fns_matches_jax(family):
    """Three steps of ``make_step_fns(loss, adagrad(1e-2))`` from a JAX
    tree carried across against JAX's ``make_step_fns(loss,
    optax.adagrad(1e-2))``: losses, parameters and accumulators (module
    tests' limits); ``eval_step`` gives the forward without gradients."""
    fam = Family(family)
    params = fam.jax_params(seed=1)
    batches = [fam.batch(256, seed=10 + i) for i in range(3)]
    want_params, want_sos, want_losses = _jax_steps(fam, params, batches)

    opt = pmodels.adagrad(1e-2)
    train_step, eval_step = pmodels.make_step_fns(fam.ploss, opt, forward_fn=fam.pforward)
    pparams = pnvt.params_from_jax(params, device="cpu")
    state = opt.init(pparams)
    assert all(bool((s == 0.1).all()) for s in tree_leaves(state))
    losses = []
    for b in batches:
        pparams, state, loss = train_step(pparams, state, {k: t(v) for k, v in b.items()})
        assert loss.dim() == 0 and not loss.requires_grad
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_trees_close(pparams, want_params)
    _assert_trees_close(state, want_sos)
    logits = eval_step(pparams, {k: t(v) for k, v in batches[0].items()})
    assert not logits.requires_grad and logits.shape[0] == 256


@pytest.mark.parametrize("family", ["dlrm", "tabular"])
def test_make_chunk_train_fn_matches_jax(family):
    """``make_chunk_train_fn`` over a chunk of 3 batches of 128 and a
    remainder of 45 rows (dropped, as JAX's scan drops them) against JAX's:
    losses [3], parameters and accumulators (module tests' limits); a chunk
    shorter than a batch trains nothing and gives no loss."""
    fam = Family(family)
    params = fam.jax_params(seed=2)
    chunk = fam.batch(3 * 128 + 45, seed=7)
    opt = optax.adagrad(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    jp, jstate, jlosses = jax_chunk_fn(fam.jloss, opt, 128)(jp, opt.init(jp), {k: jnp.asarray(v) for k, v in chunk.items()})

    popt = pmodels.adagrad(1e-2)
    train_chunk = pmodels.make_chunk_train_fn(fam.ploss, popt, 128)
    pparams = pnvt.params_from_jax(params, device="cpu")
    pparams, state, losses = train_chunk(pparams, popt.init(pparams), {k: t(v) for k, v in chunk.items()})
    assert losses.shape == (3,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    _assert_trees_close(pparams, jp)
    _assert_trees_close(state, jstate[0].sum_of_squares)
    before = [x.clone() for x in tree_leaves(pparams)]
    _, _, none = train_chunk(pparams, state, {k: t(v)[:100] for k, v in chunk.items()})
    assert none.shape == (0,) and all(torch.equal(a, b) for a, b in zip(before, tree_leaves(pparams)))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_functional_path_equals_module_path(family):
    """One forward, two entries: ``*_init(seed)`` is the module's
    parameters (``param_tree``) bit for bit, the functional forward its
    logits, and three ``make_step_fns`` steps then ``make_chunk_train_fn``
    over two batches equal ``train_step`` and ``train_chunk`` with
    ``Adagrad`` bit for bit: losses, parameters and accumulators."""
    fam = Family(family)
    params = fam.pinit(5, fam.pconfig, device="cpu")
    model = fam.module(fam.pconfig, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(model.param_tree())))
    batches = [{k: t(v) for k, v in fam.batch(128, seed=20 + i).items()} for i in range(3)]
    with torch.no_grad():
        assert torch.equal(fam.pforward(params, batches[0]), model(batches[0]))

    opt = pmodels.adagrad(1e-2)
    state = opt.init(params)
    train_step, _ = pmodels.make_step_fns(fam.ploss, opt)
    madagrad = pmodels.Adagrad(model.parameters(), lr=1e-2)
    for b in batches:
        params, state, loss = train_step(params, state, b)
        assert torch.equal(loss, pmodels.train_step(model, madagrad, b, fam.ploss))
    chunk = {k: torch.cat([batches[0][k], batches[1][k]]) for k in batches[0]}
    params, state, losses = pmodels.make_chunk_train_fn(fam.ploss, opt, 128)(params, state, chunk)
    assert torch.equal(losses, pmodels.train_chunk(model, madagrad, chunk, 128, fam.ploss))
    tree = model.param_tree()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(tree)))
    by_param = {id(p): a for p, a in zip(madagrad.params, madagrad.sum_of_squares)}
    for leaf, acc in zip(tree_leaves(tree), tree_leaves(state)):
        base = leaf._base if leaf._base is not None else leaf
        want = by_param[id(base)]
        if leaf._base is not None:  # a table's view of the concatenated parameter: its rows of the accumulator
            want = want.view(-1)[leaf.storage_offset(): leaf.storage_offset() + leaf.numel()].view(leaf.shape)
        assert torch.equal(acc, want)
