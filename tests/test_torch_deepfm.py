"""DeepFM and DCN-v2 of nvtabular_tpu_torch against the JAX reference.

The same numpy inputs go through the JAX package and the port, which runs on
the CPU through the plain versions of kernels K13a (the embedding gather into
the feature row), K16 (the FM terms) and K17 (the cross-layer epilogue).
Gradients are compared with ``jax.vjp`` / ``jax.value_and_grad``. The CUDA
kernels are held against these plain versions in test_torch_gpu.py.
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
from nvtabular_tpu.loader import DeviceLoader as JDeviceLoader
from nvtabular_tpu.models import deepfm as jdeepfm
from nvtabular_tpu.models import dlrm as jdlrm
from nvtabular_tpu.models import layers as jlayers
from nvtabular_tpu.models.training import make_step_fns
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.kernels import LAUNCHES
from nvtabular_tpu_torch.kernels import cross as kcross
from nvtabular_tpu_torch.kernels import fm as kfm
from nvtabular_tpu_torch.kernels.embedding import embedding_row
from nvtabular_tpu_torch.loader import DeviceLoader

# float32 sums in another order than XLA's CPU reductions, dots and
# scatter-adds: 1e-5 of the sum of the terms' magnitudes (an output whose
# terms cancel can differ by far more than 1e-5 of itself)
SUM_RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_within(got, want, scale, rtol=SUM_RTOL, atol=1e-7):
    """|got - want| <= rtol * scale + atol elementwise; NaN exactly where
    ``want`` is NaN."""
    got, want, scale = np.asarray(got), np.asarray(want), np.broadcast_to(np.asarray(scale), np.shape(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok])
    limit = rtol * scale[ok] + atol
    assert bool((err <= limit).all()), float((err / limit).max())


def _ids(rng, v, b, out_of_range):
    ids = rng.integers(0, v, b).astype(np.int32)
    if out_of_range:  # jnp.take: -1 wraps to v - 1, -v to 0; v, -v - 1 and beyond read NaN
        ids[:6] = [v, v + 7, -1, -v, -v - 1, 2**31 - 1]
    return ids


def _fm_inputs(F, D, out_of_range, seed=0, B=203, nd=5):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 60, F)]
    return dict(
        v=rng.normal(size=(B, F, D)).astype(np.float32),
        lins=[rng.normal(size=s).astype(np.float32) for s in sizes],
        ids=[_ids(rng, s, B, out_of_range and c % 2 == 0) for c, s in enumerate(sizes)],
        dense=rng.normal(size=(B, nd)).astype(np.float32),
        dense_w=rng.normal(size=nd).astype(np.float32),
        g=rng.normal(size=B).astype(np.float32),
        sizes=sizes,
    )


def _jax_fm(ids):
    """deepfm_forward's FM terms (nvtabular_tpu/models/deepfm.py:62-68),
    the per-table linear weights as a list."""

    def fm(stacked, lins, dense, dense_w):
        s = jnp.sum(stacked, axis=1)
        fm2 = 0.5 * jnp.sum(s * s - jnp.sum(stacked * stacked, axis=1), axis=1)
        fm1 = sum(jnp.take(lin, jnp.asarray(i)) for lin, i in zip(lins, ids))
        return fm1 + dense @ dense_w + fm2

    return fm


def _strided(a, pad=3):
    """``a`` [B, ...] as a view of a wider row-major buffer."""
    B = a.shape[0]
    flat = a.reshape(B, -1)
    buf = torch.zeros((B, flat.shape[1] + pad))
    buf[:, : flat.shape[1]] = t(flat)
    return buf[:, : flat.shape[1]].unflatten(1, a.shape[1:]) if a.ndim > 2 else buf[:, : flat.shape[1]]


@pytest.mark.parametrize(
    "F,D,out_of_range,strided",
    [(26, 16, False, True), (3, 8, True, False), (1, 8, True, True), (5, 6, False, False)],
    ids=["criteo_fields_strided", "out_of_range", "one_field", "d6"],
)
def test_fm_plain_matches_jax_and_vjp(F, D, out_of_range, strided):
    """K16's plain versions (the wrappers on CPU tensors) against the JAX
    expression and jax.vjp. The FM output is held at 1e-5 of the sum of
    its terms' magnitudes: sum_d (s_d^2 + sum_f v_fd^2) for the second
    order, whose difference cancels; dv = g (s - v) at 1e-5 of
    |g| sum_f |v_fd| (s is a sum of F terms); the scatter-add and column
    sums at 1e-5 of the sums of |terms|; ddense = g w is one product,
    exact."""
    d = _fm_inputs(F, D, out_of_range)
    ids = d["ids"]
    want, vjp = jax.vjp(_jax_fm(ids), jnp.asarray(d["v"]), [jnp.asarray(x) for x in d["lins"]],
                        jnp.asarray(d["dense"]), jnp.asarray(d["dense_w"]))
    want_dv, want_dlins, want_ddense, want_dw = vjp(jnp.asarray(d["g"]))

    offsets = np.concatenate([[0], np.cumsum(d["sizes"])[:-1]]).tolist()
    v = _strided(d["v"]) if strided else t(d["v"])
    dense = _strided(d["dense"]) if strided else t(d["dense"])
    pids, linear, dense_w = [t(i) for i in ids], t(np.concatenate(d["lins"])), t(d["dense_w"])
    got = kfm.fm_fwd(v, dense, pids, offsets, d["sizes"], linear, dense_w)

    s, q = d["v"].sum(1), (d["v"] ** 2).sum(1)
    lin_mag = sum(np.abs(lin[np.clip(np.where(i < 0, i + len(lin), i), 0, len(lin) - 1)])
                  for lin, i in zip(d["lins"], ids))
    scale = (s * s + q).sum(1) + lin_mag + np.abs(d["dense"] * d["dense_w"]).sum(1)
    assert_within(n(got), np.asarray(want), scale)
    if out_of_range:  # rows 0, 1, 4 and 5 of column 0 are out of range; -1 and -v wrap
        assert np.isnan(n(got)[[0, 1, 4, 5]]).all() and np.isfinite(n(got)[[2, 3]]).all()

    dv, ddense, dlinear, ddense_w = kfm.fm_bwd(v, dense, pids, offsets, d["sizes"], dense_w, t(d["g"]),
                                               linear.shape[0])
    g = np.abs(d["g"])
    assert_within(n(dv), np.asarray(want_dv), g[:, None, None] * np.abs(d["v"]).sum(1, keepdims=True))
    np.testing.assert_array_equal(n(ddense), np.asarray(want_ddense))
    rows = [np.where(i < 0, i + len(lin), i) for lin, i in zip(d["lins"], ids)]
    mag = np.concatenate([np.bincount(r[(r >= 0) & (r < len(lin))], g[(r >= 0) & (r < len(lin))], len(lin))
                          for lin, r in zip(d["lins"], rows)])
    assert_within(n(dlinear), np.concatenate([np.asarray(x) for x in want_dlins]), mag)
    assert_within(n(ddense_w), np.asarray(want_dw), g @ np.abs(d["dense"]))
    assert sum(LAUNCHES.values()) == 0  # CPU tensors never launch a kernel


@pytest.mark.parametrize("strided", [False, True])
def test_fm_terms_autograd_matches_jax(strided):
    """The autograd Function over DeepFM's [B, F*D + nd] row: the forward
    and the row's gradient (both blocks) in one [B, F*D + nd] tensor."""
    F, D, nd = 4, 8, 3
    d = _fm_inputs(F, D, False, seed=1, B=97, nd=nd)
    row = np.concatenate([d["v"].reshape(97, -1), d["dense"]], axis=1)
    want, vjp = jax.vjp(_jax_fm(d["ids"]), jnp.asarray(d["v"]), [jnp.asarray(x) for x in d["lins"]],
                        jnp.asarray(d["dense"]), jnp.asarray(d["dense_w"]))
    want_dv, want_dlins, want_ddense, want_dw = vjp(jnp.asarray(d["g"]))

    x = (_strided(row) if strided else t(row)).requires_grad_(True)
    linear = t(np.concatenate(d["lins"])).requires_grad_(True)
    dense_w = t(d["dense_w"]).requires_grad_(True)
    offsets = np.concatenate([[0], np.cumsum(d["sizes"])[:-1]]).tolist()
    got = kfm.fm_terms(x, linear, dense_w, [t(i) for i in d["ids"]], offsets, d["sizes"], D)
    got.backward(t(d["g"]))
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    want_dx = np.concatenate([np.asarray(want_dv).reshape(97, -1), np.asarray(want_ddense)], axis=1)
    np.testing.assert_allclose(n(x.grad), want_dx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(linear.grad), np.concatenate([np.asarray(a) for a in want_dlins]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(dense_w.grad), np.asarray(want_dw), rtol=1e-5, atol=1e-5)


def _jax_cross(xw, b, x0, x):
    """dcn_forward's cross layer after its product (deepfm.py:126-134)."""
    return x0 * (xw + b) + x


@pytest.mark.parametrize("B,N,strided", [(257, 29, False), (64, 429, True)])
def test_cross_plain_matches_jax_and_vjp(B, N, strided):
    """K17's plain versions (the wrappers on CPU tensors) against the JAX
    expression and jax.vjp: each element is the same two or three rounded
    operations, bit-equal; db sums B products in another order (1e-5 of
    the sum of their magnitudes)."""
    rng = np.random.default_rng(2)
    xw, x0, x, g = (rng.normal(size=(B, N)).astype(np.float32) for _ in range(4))
    b = rng.normal(size=N).astype(np.float32)
    want, vjp = jax.vjp(_jax_cross, *(jnp.asarray(a) for a in (xw, b, x0, x)))
    want_dxw, want_db, want_dx0, want_dx = vjp(jnp.asarray(g))

    wrap = _strided if strided else t
    got = kcross.cross_fwd(wrap(xw), t(b), wrap(x0), wrap(x))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    dxw, dx0, db = kcross.cross_bwd(wrap(g), wrap(xw), t(b), wrap(x0))
    np.testing.assert_array_equal(n(dxw), np.asarray(want_dxw))
    np.testing.assert_array_equal(n(dx0), np.asarray(want_dx0))
    np.testing.assert_array_equal(np.asarray(want_dx), g)
    assert_within(n(db), np.asarray(want_db), np.abs(g * x0).sum(0))

    # the autograd Function: x's gradient is g itself
    leaves = [t(a).requires_grad_(True) for a in (xw, b, x0, x)]
    kcross.cross_layer(*leaves).backward(t(g))
    for leaf, want_grad in zip(leaves, (want_dxw, want_db, want_dx0, want_dx)):
        np.testing.assert_allclose(n(leaf.grad), np.asarray(want_grad), rtol=1e-5, atol=1e-5)
    assert sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize("out_of_range", [False, True], ids=["in_range", "out_of_range"])
def test_embedding_row_matches_jax_concatenate(out_of_range):
    """The feature row of DeepFM and DCN: [take(T_c, ids_c) for each column,
    dense] from one concatenated table, against dcn_forward's
    jnp.concatenate (deepfm.py:121-123)."""
    rng = np.random.default_rng(3)
    sizes, d, b, nd = [3, 50, 11], 8, 129, 5
    tables = [rng.normal(size=(s, d)).astype(np.float32) for s in sizes]
    ids = [_ids(rng, s, b, out_of_range and c == 1) for c, s in enumerate(sizes)]
    dense = rng.normal(size=(b, nd)).astype(np.float32)
    cot = rng.normal(size=(b, len(sizes) * d + nd)).astype(np.float32)

    def jrow(dense, *tabs):
        return jnp.concatenate([jnp.take(tb, jnp.asarray(i), axis=0) for tb, i in zip(tabs, ids)] + [dense], axis=1)

    want, vjp = jax.vjp(jrow, jnp.asarray(dense), *[jnp.asarray(x) for x in tables])
    want_grads = vjp(jnp.asarray(cot))
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    pd = t(dense).requires_grad_(True)
    pt = t(np.concatenate(tables)).requires_grad_(True)
    got = embedding_row(pt, [t(i) for i in ids], offsets, sizes, pd)
    got.backward(t(cot))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(n(pd.grad), np.asarray(want_grads[0]))
    np.testing.assert_allclose(n(pt.grad), np.concatenate([np.asarray(g) for g in want_grads[1:]]), rtol=1e-5, atol=1e-6)


# --- the two models ------------------------------------------------------------------

CARDS = {"b": 40, "a": 7, "c": 300}


class Family:
    def __init__(self, name):
        self.name = name
        if name == "deepfm":
            self.jconfig = jdeepfm.DeepFMConfig
            self.pconfig, self.model = pmodels.DeepFMConfig, pmodels.DeepFM
            self.jinit, self.jloss, self.jforward = jdeepfm.deepfm_init, jdeepfm.deepfm_loss, jdeepfm.deepfm_forward
            self.ploss, self.reference = pmodels.deepfm_loss, pmodels.deepfm_reference_forward
            self.load, self.params = pnvt.load_deepfm_params, pnvt.deepfm_params
            self.kwargs = dict(embedding_dim=8, deep_mlp=(16,))
        else:
            self.jconfig = jdeepfm.DCNConfig
            self.pconfig, self.model = pmodels.DCNConfig, pmodels.DCN
            self.jinit, self.jloss, self.jforward = jdeepfm.dcn_init, jdeepfm.dcn_loss, jdeepfm.dcn_forward
            self.ploss, self.reference = pmodels.dcn_loss, pmodels.dcn_reference_forward
            self.load, self.params = pnvt.load_dcn_params, pnvt.dcn_params
            self.kwargs = dict(embedding_dim=8, deep_mlp=(16,), num_cross_layers=2)

    def configs(self, cards=CARDS, num_dense=5, **kwargs):
        kw = {**self.kwargs, **kwargs}
        return self.jconfig(cardinalities=cards, num_dense=num_dense, **kw), self.pconfig(cards, num_dense, **kw)

    def jax_params(self, jconfig, seed=0):
        return jax.tree.map(np.asarray, self.jinit(jax.random.PRNGKey(seed), jconfig))

    def mlps(self, model):
        return [model.deep] if self.name == "deepfm" else [model.cross, model.deep, model.out]


FAMILIES = ["deepfm", "dcn"]


def _batch(cards, num_dense, b, seed):
    rng = np.random.default_rng(seed)
    batch = {
        "dense": rng.normal(size=(b, num_dense)).astype(np.float32),
        "label": rng.integers(0, 2, b).astype(np.float32),
    }
    for name, card in cards.items():
        batch[name] = rng.integers(0, card, b).astype(np.int32)
    return batch


class _Float32Numpy:
    """jax.numpy with ``bfloat16`` mapped to float32: dcn_forward's cross
    product casts to jnp.bfloat16 by name (deepfm.py:128-129)."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_loss_and_grads_match_jax(family, compute, monkeypatch):
    """The loss, the logits and every parameter's gradient with the JAX
    parameters carried across. float32 (the JAX forward with mlp_apply's
    compute_dtype and the cross product's cast set to float32): only
    summation orders differ — loss rtol 1e-5, logits within 1e-5, each
    gradient within 1e-5 of its largest entry. bfloat16 (the JAX functions
    as written): the same, and a value that close to a rounding boundary
    may round the other way on the two sides, moving what it feeds by up to
    2**-8 relative — logits within 1e-3 and gradients within 1e-4 of their
    largest entry, the limits of test_dlrm_forward_loss_and_grads_match_jax."""
    fam = Family(family)
    jconfig, pconfig = fam.configs()
    params = fam.jax_params(jconfig)
    batch = _batch(CARDS, 5, 512, seed=4)
    dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
    if compute == "float32":
        monkeypatch.setattr(jdeepfm, "mlp_apply", functools.partial(jlayers.mlp_apply, compute_dtype=jnp.float32))
        monkeypatch.setattr(jdeepfm, "jnp", _Float32Numpy())
    jparams = jax.tree.map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.value_and_grad(fam.jloss)(jparams, jbatch)
    want_logits = np.asarray(fam.jforward(jparams, jbatch))

    model = fam.model(pconfig, device="cpu", compute_dtype=dtype)
    fam.load(model, params)
    pbatch = {k: t(v) for k, v in batch.items()}
    logits = model(pbatch)
    loss = fam.ploss(model, pbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    logit_tol = 1e-5 if compute == "float32" else 1e-3
    np.testing.assert_allclose(n(logits), want_logits, rtol=logit_tol, atol=logit_tol)

    # the JAX gradients in the port's parameter layout
    grads = fam.model(pconfig, device="cpu")
    fam.load(grads, jax.tree.map(np.asarray, want_grads))
    limit = 1e-5 if compute == "float32" else 1e-4
    for (name, p), want in zip(model.named_parameters(), grads.parameters()):
        want = n(want)
        scale = float(np.abs(want).max())
        err = float(np.abs(n(p.grad) - want).max())
        assert err <= limit * scale, (name, err, scale)


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_forward_equals_kernel_path_on_cpu(family):
    """On the CPU both paths run the plain versions: the same logits and
    gradients (only the autograd graph differs)."""
    fam = Family(family)
    _, pconfig = fam.configs()
    model = fam.model(pconfig, seed=2, device="cpu")
    batch = {k: t(v) for k, v in _batch(CARDS, 5, 256, seed=5).items()}
    got = model(batch)
    got.sum().backward()
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    want = fam.reference(model, batch)
    want.sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for g, p in zip(grads, model.parameters()):
        torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", FAMILIES)
def test_adagrad_steps_match_optax(family):
    """Three Adagrad(1e-2) steps against make_step_fns(loss,
    optax.adagrad(1e-2)): losses, parameters and accumulators to 1e-5
    (bfloat16 compute on both sides, float32 sums in another order)."""
    fam = Family(family)
    jconfig, pconfig = fam.configs()
    params = fam.jax_params(jconfig, seed=1)
    batches = [_batch(CARDS, 5, 256, seed=10 + i) for i in range(3)]

    opt = optax.adagrad(1e-2)
    step, _ = make_step_fns(fam.jloss, opt)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    want_losses = []
    for b in batches:
        jp, state, loss = step(jp, state, {k: jnp.asarray(v) for k, v in b.items()})
        want_losses.append(float(loss))

    model = fam.model(pconfig, device="cpu")
    fam.load(model, params)
    popt = pmodels.Adagrad(model.parameters(), lr=1e-2)
    got_losses = [float(pmodels.train_step(model, popt, {k: t(v) for k, v in b.items()}, fam.ploss)) for b in batches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)

    want_params = fam.model(pconfig, device="cpu")
    want_sos = fam.model(pconfig, device="cpu")
    fam.load(want_params, jax.tree.map(np.asarray, jp))
    fam.load(want_sos, jax.tree.map(np.asarray, state[0].sum_of_squares))
    for (name, p), w, s in zip(model.named_parameters(), want_params.parameters(), want_sos.parameters()):
        np.testing.assert_allclose(n(p), n(w), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(n(popt.accumulator(p)), n(s), rtol=1e-5, err_msg=name)


# --- the slice as a whole: ETL -> DeviceLoader -> model -> Adagrad -----------------------

CATS, CONTS = ["t0", "t1", "w0"], ["I0", "I1", "I2"]


def _criteo_part(seed, rows=2000):
    """Criteo-shaped: a tiny, a mid-size and a hashed wide int column, 3
    floats with ~5% NaN, an int32 label."""
    r = np.random.default_rng(seed)
    d = {
        "t0": r.integers(0, 40, rows).astype(np.int32),
        "t1": ((r.integers(0, 3000, rows) * 7919) % 2**31).astype(np.int32),
        "w0": ((r.zipf(1.3, rows) % 12_000).astype(np.int64) * 2654435761 % 2**31).astype(np.int32),
    }
    for name in CONTS:
        x = r.normal(1.0, 3.0, rows).astype(np.float32)
        x[r.random(rows) < 0.05] = np.nan
        d[name] = x
    d["label"] = r.integers(0, 2, rows).astype(np.int32)
    return d


def _criteo_graph(ops):
    cats = CATS >> ops.Categorify()
    conts = CONTS >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.Normalize()
    return cats + conts + ["label"]


@pytest.mark.parametrize("family", FAMILIES)
def test_slice_whole_etl_loader_model_adagrad(family):
    """The Criteo-shaped workflow fitted by each package →
    DeviceLoader(shuffle=False) → the model (JAX parameters carried across)
    → 3 Adagrad(1e-2) steps, against the JAX package's make_step_fns(loss,
    optax.adagrad(1e-2)) on its own ETL output. Losses and updated
    parameters to 1e-5: the dense inputs differ by log1p ULPs, float32 sums
    run in another order, and both sides round to bfloat16."""
    fam = Family(family)
    parts = [_criteo_part(s) for s in range(3)]
    jwf = jnvt.Workflow(_criteo_graph(jops), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts]))
    pwf = pnvt.Workflow(_criteo_graph(pops), device="cpu")
    pwf.fit(pnvt.Dataset(parts))
    names = dict(cat_names=CATS, cont_names=CONTS, label_names=["label"], batch_size=512, shuffle=False)
    jbatches = list(JDeviceLoader(jwf.transform(jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts])),
                                  **names))[:3]
    pbatches = list(DeviceLoader(pwf.transform(pnvt.Dataset(parts)), device="cpu", **names))[:3]
    cards = pmodels.DLRMConfig.from_schema(pwf.output_schema).cardinalities
    assert cards == jdlrm.DLRMConfig.from_schema(jwf.output_schema).cardinalities
    jconfig, pconfig = fam.configs(cards, len(CONTS))
    params = fam.jax_params(jconfig)

    opt = optax.adagrad(1e-2)
    step, _ = make_step_fns(fam.jloss, opt)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    want_losses = []
    for b in jbatches:
        jp, state, loss = step(jp, state, b)
        want_losses.append(float(loss))

    model = fam.model(pconfig, device="cpu")
    fam.load(model, params)
    popt = pmodels.Adagrad(model.parameters(), lr=1e-2)
    got_losses = [float(pmodels.train_step(model, popt, b, fam.ploss)) for b in pbatches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    want = fam.model(pconfig, device="cpu")
    fam.load(want, jax.tree.map(np.asarray, jp))
    for (name, p), w in zip(model.named_parameters(), want.parameters()):
        np.testing.assert_allclose(n(p), n(w), rtol=1e-5, atol=1e-6, err_msg=name)


# --- parameters, init and what raises ------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_params_round_trip_and_layout(family):
    fam = Family(family)
    jconfig, pconfig = fam.configs()
    model = fam.model(pconfig, seed=3, device="cpu")
    assert model.names == ["a", "b", "c"] and model.offsets == [0, 7, 47]
    assert tuple(model.table.shape) == (347, 8)
    params = fam.jax_params(jconfig)
    fam.load(model, params)
    back = fam.params(model)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    with pytest.raises(ValueError, match="tables"):
        fam.load(model, {**params, "tables": {"a": params["tables"]["a"]}})


@pytest.mark.parametrize("family", FAMILIES)
def test_load_params_carries_adagrad_state(family):
    """optax's sum_of_squares lands in the port's accumulators, table rows
    in sorted column order."""
    fam = Family(family)
    jconfig, pconfig = fam.configs()
    params = fam.jax_params(jconfig)
    rng = np.random.default_rng(9)
    sos = jax.tree.map(lambda a: (rng.random(np.shape(a)) + 0.1).astype(np.float32), params)
    model = fam.model(pconfig, device="cpu")
    opt = pmodels.Adagrad(model.parameters(), lr=1e-2)
    fam.load(model, params, opt, sos)
    np.testing.assert_array_equal(n(opt.accumulator(model.table)), np.concatenate([sos["tables"][k] for k in "abc"]))
    if family == "deepfm":
        np.testing.assert_array_equal(n(opt.accumulator(model.linear)), np.concatenate([sos["linear"][k] for k in "abc"]))
        np.testing.assert_array_equal(n(opt.accumulator(model.bias)), sos["bias"])
    else:
        np.testing.assert_array_equal(n(opt.accumulator(model.cross.weights[1])), sos["cross"][1]["w"])


@pytest.mark.parametrize("family", FAMILIES)
def test_init_distributions(family):
    """The JAX init's distributions from a torch.Generator: tables
    N(0, 1/D); DeepFM's linear zeros and dense_w N(0, 1e-4); DCN's cross W
    N(0, 1/N) and b zeros; MLP weights N(0, 2/fan_in). The same seed gives
    the same parameters."""
    fam = Family(family)
    _, pconfig = fam.configs({"a": 20_000, "b": 30_000}, 13, embedding_dim=16, deep_mlp=(64,))
    m1, m2 = fam.model(pconfig, seed=7, device="cpu"), fam.model(pconfig, seed=7, device="cpu")
    for p, q in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(p, q)
    table = m1.table.detach()
    assert abs(float(table.std()) - 0.25) < 0.01 and abs(float(table.mean())) < 0.01
    w = m1.deep.weights[0].detach()
    assert abs(float(w.std()) - (2.0 / w.shape[0]) ** 0.5) < 0.05 * (2.0 / w.shape[0]) ** 0.5
    if family == "deepfm":
        assert float(m1.linear.abs().max()) == 0.0 and float(m1.bias.detach()) == 0.0
        assert m1.dense_w.shape == (13,) and float(m1.dense_w.abs().max()) < 0.06
    else:
        cw = m1.cross.weights[0].detach()
        assert cw.shape == (45, 45) and abs(float(cw.std()) - 45**-0.5) < 0.05 * 45**-0.5
        assert all(float(b.abs().max()) == 0.0 for b in m1.cross.biases)


@pytest.mark.parametrize("family", FAMILIES)
def test_default_device_is_cuda(family):
    fam = Family(family)
    _, pconfig = fam.configs()
    if torch.cuda.is_available():
        assert fam.model(pconfig).table.device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fam.model(pconfig)


@pytest.mark.parametrize(
    "call",
    [
        lambda: kfm.fm_fwd(torch.zeros(4, 2, 8), torch.zeros(4, 1), [torch.zeros(4, dtype=torch.int32)],
                           [0], [3], torch.zeros(3), torch.zeros(1)),
        lambda: kfm.fm_fwd(torch.zeros(4, 1, 8), torch.zeros(4, 1), [torch.zeros(4, dtype=torch.int64)],
                           [0], [3], torch.zeros(3), torch.zeros(1)),
        lambda: kfm.fm_fwd(torch.zeros(4, 8, 8)[:, ::2], torch.zeros(4, 1), [torch.zeros(4, dtype=torch.int32)] * 4,
                           [0] * 4, [3] * 4, torch.zeros(3), torch.zeros(1)),
        lambda: kfm.fm_fwd(torch.zeros(4, 1, 8), torch.zeros(4, 1), [torch.zeros(4, dtype=torch.int32)],
                           [0], [4], torch.zeros(3), torch.zeros(1)),
        lambda: kcross.cross_fwd(torch.zeros(4, 6), torch.zeros(5), torch.zeros(4, 6), torch.zeros(4, 6)),
        lambda: kcross.cross_fwd(torch.zeros(4, 6), torch.zeros(6), torch.zeros(6, 4).T, torch.zeros(4, 6)),
        lambda: kcross.cross_bwd(torch.zeros(4, 6, dtype=torch.float64), torch.zeros(4, 6), torch.zeros(6),
                                 torch.zeros(4, 6)),
    ],
    ids=["fields_vs_ids", "int64_ids", "strided_field_block", "entries_outside_linear", "bias_shape",
         "column_strided_x0", "float64_g"],
)
def test_fm_and_cross_wrappers_reject_wrong_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()
