"""The MLP and cross-layer products (K21) of nvtabular_tpu_torch against the
JAX reference.

``kernels.mlp_mm`` holds the plain versions of kernel K21
(``csrc/mlp_mm.cu``: each layer's ``h @ w`` with the layer's epilogue in
its store, ``dz @ w.T`` and ``h.T @ dz``) and ``MLPProduct``, the layer's autograd
function. The same numpy inputs go through JAX's ``jnp.dot(bf16, bf16,
preferred_element_type=float32)`` and its ``jax.vjp``, ``mlp_apply`` and
``dcn_forward`` on the CPU, and through ``MLPProduct`` with ``plain=True``
(``torch.matmul`` in float32 on bfloat16-rounded values). Both sum the same
exact products in float32 in other orders: each sum is held to 2 gamma_K
(|A| |B|), gamma_K = K u / (1 - K u), u = 2^-24, computed in float64; a
value rounded to bfloat16 after it may land on its neighbour (one ULP). The
kernel is held against the plain versions in test_torch_gpu.py.

The kernel's split of a float32 operand into three bfloat16 pieces
(``split_pieces``, a copy of its arithmetic) is checked here: exact for
every finite value of magnitude at least 2^-110, within 2^-134 below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvtabular_tpu_torch as pnvt
from nvtabular_tpu.models import deepfm as jdeepfm
from nvtabular_tpu.models import layers as jlayers
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch.kernels import LAUNCHES, reset_launches
from nvtabular_tpu_torch.kernels import mlp_mm as kmm
from nvtabular_tpu_torch.models import deepfm as pdeepfm
from nvtabular_tpu_torch.models.layers import concatenate_tables
from nvtabular_tpu_torch.models.pytree import tree_leaves, tree_map

U = 2.0**-24


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def bf16(a):
    """numpy float32 values rounded to bfloat16 (as JAX's astype)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def product_bound(A, B, terms):
    """2 gamma_terms (|A| |B|) in float64."""
    return 2 * terms * U / (1 - terms * U) * (np.abs(A).astype(np.float64) @ np.abs(B).astype(np.float64))


def bf16_ulp(a):
    """bfloat16's spacing at |a| (2^-133 near zero)."""
    e = np.floor(np.log2(np.maximum(np.abs(a).astype(np.float64), 2.0**-126)))
    return np.exp2(e - 7)


# --- the product and its gradients against jnp.dot and jax.vjp ------------------------------------------------
SHAPES = [(100, 13, 512), (100, 13, 1), (64, 367, 16), (7, 429, 429), (100, 256, 1), (3, 1, 5)]


@pytest.mark.parametrize("M,K,N", SHAPES, ids=[f"{m}x{k}x{n_}" for m, k, n_ in SHAPES])
def test_product_plain_matches_jax_dot(M, K, N):
    """MLPProduct's plain forward (no bias: a cross layer's store) against
    jnp.dot of the bfloat16 operands with float32 sums, within 2 gamma_K
    (|A| |B|); dgrad and wgrad for a float32 cotangent against jax.vjp,
    whose transposes round to bfloat16: the port's float32 gradients,
    rounded, within the sums' bound (K + 1 terms: JAX rounds each product
    of the float32 cotangent) and one ULP."""
    rng = np.random.default_rng(M * 100 + K + N)
    h = bf16(rng.normal(size=(M, K)).astype(np.float32))
    w = bf16((rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32))
    g = rng.normal(size=(M, N)).astype(np.float32)

    def f(hb, wb):
        return jnp.dot(hb, wb, preferred_element_type=jnp.float32)

    want, vjp = jax.vjp(f, jnp.asarray(h).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16))
    want_dh, want_dw = (np.asarray(a.astype(jnp.float32)) for a in vjp(jnp.asarray(g)))
    ph, pw = t(h).requires_grad_(True), t(w).requires_grad_(True)
    got = kmm.mlp_product(ph, pw, None, exact=True, plain=True)
    got.backward(t(g))
    assert got.dtype == torch.float32 and ph.grad.dtype == torch.float32
    assert np.all(np.abs(n(got).astype(np.float64) - np.asarray(want)) <= product_bound(h, w, K))
    for mine, theirs, bnd in ((ph.grad, want_dh, product_bound(g, w.T, N + 1)),
                              (pw.grad, want_dw, product_bound(h.T, g, M + 1))):
        rounded = bf16(n(mine))
        lim = bnd + bf16_ulp(np.maximum(np.abs(rounded), np.abs(theirs)))
        assert np.all(np.abs(rounded.astype(np.float64) - theirs) <= lim)


@pytest.mark.parametrize("exact", [True, False], ids=["bf16", "f32"])
def test_product_kernel_wrappers_run_the_plain_versions_on_cpu(exact):
    """On CPU tensors the wrappers run the plain versions (nothing counted):
    the same bits as plain=True, forward with the fused epilogue, dgrad and
    wgrad."""
    rng = np.random.default_rng(3)
    h, w = t(bf16(rng.normal(size=(37, 20)).astype(np.float32))), t(bf16(rng.normal(size=(20, 9)).astype(np.float32)))
    b, g = t(rng.normal(size=9).astype(np.float32)), t(rng.normal(size=(37, 9)).astype(np.float32))
    reset_launches()
    out, mask = kmm.mlp_mm_fwd(h, w, b, True, torch.bfloat16, exact)
    want, want_mask = kmm.mlp_mm_fwd_plain(h, w, b, True, torch.bfloat16)
    assert torch.equal(out, want) and torch.equal(mask, want_mask)
    assert torch.equal(kmm.mlp_mm_dgrad(g, w, False, exact), g @ w.t())
    assert torch.equal(kmm.mlp_mm_wgrad(h, g, exact, False), h.t() @ g)
    assert not any(LAUNCHES[k] for k in ("mlp_mm_fwd", "mlp_mm_dgrad", "mlp_mm_wgrad", "mlp_mm_fwd_epilogue"))


def test_product_without_a_bias_stores_the_product_alone():
    rng = np.random.default_rng(4)
    h, w = t(rng.normal(size=(5, 3)).astype(np.float32)), t(rng.normal(size=(3, 2)).astype(np.float32))
    with pytest.raises(ValueError):
        kmm.mlp_mm_fwd(h, w, None, True)
    with pytest.raises(ValueError):
        kmm.mlp_product(h, w, None, round_dtype=torch.bfloat16)
    out, mask = kmm.mlp_mm_fwd(h, w, None, False)
    assert mask is None and torch.equal(out, h @ w)


@pytest.mark.parametrize("kind", ["matmul", "k21", "float64", "reversed"])
def test_plain_products_sum_the_same_products(kind):
    """Each order plain_products gives the plain path sums the same exact
    products: the layer's output and both gradients within 2 gamma_K (|A|
    |B|) of float64 sums ("matmul" and, on the CPU, "k21": the plain
    versions' bits); the fused epilogue after the product; the plain
    versions again once the block ends."""
    rng = np.random.default_rng(5)
    h = t(bf16(rng.normal(size=(50, 37)).astype(np.float32))).requires_grad_(True)
    w = t(bf16((rng.normal(size=(37, 11)) / 6).astype(np.float32))).requires_grad_(True)
    b = t(rng.normal(size=11).astype(np.float32)).requires_grad_(True)
    g = t(rng.normal(size=(50, 11)).astype(np.float32))

    def layer():
        out = kmm.mlp_product(h, w, b, relu=False, round_dtype=None, exact=True, plain=True)
        dh, dw, db = torch.autograd.grad(out, (h, w, b), g)
        return out.detach(), dh, dw, db

    want = layer()
    with kmm.plain_products(kind):
        got = layer()
    assert all(torch.equal(a, c) for a, c in zip(layer(), want))
    hd, wd, gd = h.detach().double(), w.detach().double(), g.double()
    exact = (hd @ wd + b.detach().double(), gd @ wd.t(), hd.t() @ gd)
    bounds = (product_bound(n(h), n(w), 37) + 2 * U * np.abs(n(exact[0])), product_bound(n(g), n(w).T, 11),
              product_bound(n(h).T, n(g), 50))
    for mine, ex, bnd in zip(got, exact, bounds):
        assert np.all(np.abs(n(mine).astype(np.float64) - n(ex)) <= bnd)
    assert torch.equal(got[3], want[3])  # db: K19's plain backward, the same on every order
    if kind in ("matmul", "k21"):
        assert all(torch.equal(a, c) for a, c in zip(got, want))
    with pytest.raises(ValueError):
        with kmm.plain_products("cublas"):
            pass


def test_wrappers_check_operands_on_both_devices():
    """The CPU paths of K21's wrappers refuse what the kernel refuses: a
    dtype other than float32, a 1-D operand, inner dimensions that differ,
    a bias of the wrong width, a round other than bfloat16 or float16."""
    h, w, b = torch.zeros(4, 3), torch.zeros(3, 2), torch.zeros(2)
    for call in (lambda: kmm.mlp_mm_fwd(h.double(), w, b, True), lambda: kmm.mlp_mm_fwd(h[0], w, b, True),
                 lambda: kmm.mlp_mm_fwd(h, w.t(), b, True), lambda: kmm.mlp_mm_fwd(h, w, torch.zeros(3), True),
                 lambda: kmm.mlp_mm_dgrad(torch.zeros(4, 5), w), lambda: kmm.mlp_mm_wgrad(h, torch.zeros(5, 2))):
        with pytest.raises((TypeError, ValueError)):
            call()
    with pytest.raises(NotImplementedError):
        kmm.mlp_mm_fwd(h, w, b, True, torch.float64)
    with pytest.raises(ValueError):
        kmm.mm_launch("mlp_mm_fwd", h, False, True, w, False, True)  # the kernel takes CUDA tensors


# --- an MLP and a DCN cross stack through MLPProduct against mlp_apply and dcn_forward ------------------------
@pytest.mark.parametrize("final_activation", [False, True])
@pytest.mark.parametrize("sizes", [[13, 32, 16, 1], [429, 64, 16]], ids=["13-32-16-1", "429-64-16"])
def test_mlp_through_mlp_product_matches_jax(sizes, final_activation):
    """mlp_apply with plain=True (each layer one MLPProduct) against JAX's
    mlp_apply and jax.vjp for the same cotangent, in bfloat16 compute:
    outputs and dx within rtol and atol 1e-3 (a hidden value at a bfloat16
    rounding boundary may round the other way), dw and db within 1e-4 of
    their largest entry (sums over 300 rows whose terms cancel)."""
    rng = np.random.default_rng(len(sizes) + sizes[0])
    jparams = [{"w": (rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
                "b": (rng.normal(size=b) * 0.1).astype(np.float32)} for a, b in zip(sizes[:-1], sizes[1:])]
    x = rng.normal(size=(300, sizes[0])).astype(np.float32)
    cot = rng.normal(size=(300, sizes[-1])).astype(np.float32)

    def f(params, x):
        return jlayers.mlp_apply(params, x, final_activation=final_activation)

    want, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))
    want_params, want_dx = vjp(jnp.asarray(cot))
    params = [{k: t(v).requires_grad_(True) for k, v in layer.items()} for layer in jparams]
    px = t(x).requires_grad_(True)
    got = pmodels.mlp_apply(params, px, final_activation=final_activation, plain=True)
    got.backward(t(cot))
    np.testing.assert_allclose(n(got), want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(n(px.grad), want_dx, rtol=1e-3, atol=1e-3)
    for layer, want_layer in zip(params, want_params):
        for k in ("w", "b"):
            w_ = np.asarray(want_layer[k])
            assert np.abs(n(layer[k].grad) - w_).max() <= 1e-4 * max(np.abs(w_).max(), 1e-30)


def _port_dcn_plain(params, batch):
    """dcn_forward through the plain versions: the cross stack and both MLPs
    with plain=True (every product one MLPProduct)."""
    names, table, offsets, sizes = concatenate_tables(params["tables"])
    x0 = pdeepfm._feature_row(table, [batch[k] for k in names], offsets, sizes, batch)
    x = pdeepfm.cross_apply(params["cross"], x0, plain=True)
    deep = pmodels.mlp_apply(params["deep"], x0, final_activation=True, plain=True)
    return pmodels.mlp_apply(params["out"], torch.cat([x, deep], dim=1), plain=True).reshape(-1)


def test_dcn_cross_stack_through_mlp_product_matches_jax():
    """DCN-v2 (3 cross layers of width 45, a 16-wide tower) through the plain
    MLPProduct against JAX's dcn_forward and the gradient of dcn_loss on one
    batch: logits within 1e-3, the loss within rtol 1e-5, every leaf's
    gradient within 1e-4 of its largest entry (test_torch_functional.py's
    limits); the cross products' gradient x0 * g is float32 on both sides."""
    cards = {"b": 40, "a": 7, "c": 300}
    kw = dict(cardinalities=cards, num_dense=5, embedding_dim=8, deep_mlp=(16,), num_cross_layers=3)
    jconfig = jdeepfm.DCNConfig(**kw)
    params = jax.tree.map(np.asarray, jdeepfm.dcn_init(jax.random.PRNGKey(2), jconfig))
    rng = np.random.default_rng(9)
    batch = {"dense": rng.normal(size=(256, 5)).astype(np.float32),
             "label": rng.integers(0, 2, 256).astype(np.float32)}
    for name, card in cards.items():
        batch[name] = rng.integers(0, card, 256).astype(np.int32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree.map(jnp.asarray, params)
    want_loss, want_grads = jax.value_and_grad(jdeepfm.dcn_loss)(jparams, jbatch)
    want_logits = np.asarray(jdeepfm.dcn_forward(jparams, jbatch))

    pparams = tree_map(lambda x: x.requires_grad_(True), pnvt.params_from_jax(params, device="cpu"))
    pbatch = {k: t(v) for k, v in batch.items()}
    reset_launches()
    logits = _port_dcn_plain(pparams, pbatch)
    loss = pmodels.bce_with_logits(logits, pbatch["label"], plain=True)
    loss.backward()
    assert not any(LAUNCHES.values())
    np.testing.assert_allclose(n(logits), want_logits, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for got, want in zip(tree_leaves(pparams), jax.tree.leaves(want_grads)):
        want = np.asarray(want)
        assert got.grad.shape == want.shape
        assert float(np.abs(n(got.grad) - want).max()) <= 1e-4 * max(float(np.abs(want).max()), 1e-30)


# --- the split of a float32 operand -----------------------------------------------------------------------------
def split_sample(n: int, seed: int = 0) -> torch.Tensor:
    """``n`` finite float32 values, seeded, over the whole exponent range
    (random 32-bit patterns, the non-finite ones dropped and refilled) with
    float32's and bfloat16's edges among them: signed zeros, the largest
    finite value, values past bfloat16's largest, the least normal, float32
    subnormals and values at 2^-110 and just below."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32).copy()
    bad = ~np.isfinite(x)
    x[bad] = rng.standard_normal(int(bad.sum())).astype(np.float32)
    f = np.finfo(np.float32)
    edges = np.array([0.0, -0.0, f.max, -f.max, 3.3961e38, np.float32(f.tiny), f.smallest_subnormal,
                      -3 * f.smallest_subnormal, 2.0**-110, np.nextafter(np.float32(2.0**-110), np.float32(0)),
                      1.0 + 2.0**-8 + 2.0**-20, -(1.0 + 2.0**-9 + 2.0**-23)], np.float32)
    x[: len(edges)] = edges[: n]
    return torch.from_numpy(x)


def test_split_pieces_rebuild_every_finite_float32_value():
    """hi + mid + lo rebuilds every finite float32 value of a seeded sample
    of 200,000 (random bit patterns over the whole exponent range, and the
    edges) exactly where |x| >= 2^-110; below, lo's bits fall under
    bfloat16's least subnormal 2^-133 and the sum is within 2^-134 of x (the
    threshold is tight: values in [2^-111, 2^-110) miss). Past bfloat16's
    largest finite value hi is rounded toward zero; each piece is a
    bfloat16 value and |mid| <= 2^-7 |hi| (a full ULP of hi where it was
    rounded toward zero), |lo| <= 2^-8 |mid| + 2^-134."""
    x = split_sample(200_000, seed=1)
    assert bool(torch.isfinite(x).all())
    hi, mid, lo = kmm.split_pieces(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert bool(torch.isfinite(hi.float()).all())
    total = hi.double() + mid.double() + lo.double()
    xd = x.double()
    big = xd.abs() >= 2.0**-110
    assert torch.equal(total[big], xd[big])
    assert float((total[~big] - xd[~big]).abs().max()) <= 2.0**-134
    edge = (xd.abs() >= 2.0**-111) & ~big
    assert bool((total[edge] != xd[edge]).any())  # the bound is where the split stops being exact
    assert bool((mid.double().abs() <= 2.0**-7 * hi.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0**-8 * mid.double().abs() + 2.0**-134).all())
    past = x.abs() > 3.3895313892515355e38  # bfloat16's largest finite value
    assert bool(past.any()) and bool((hi[past].float().abs() == 3.3895313892515355e38).all())


def test_split_pieces_of_non_finite_values_are_hi_alone():
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0])
    hi, mid, lo = kmm.split_pieces(x)
    assert torch.isnan(hi[0]) and hi[1] == float("inf") and hi[2] == -float("inf")
    assert torch.signbit(hi[3]) and not bool(mid.float().any()) and not bool(lo.float().any())
