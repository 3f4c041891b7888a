"""The MLP layer epilogue and the rounds (K19) and the loss (K20) of
nvtabular_tpu_torch against the JAX reference.

``kernels.mlp_epilogue`` and ``kernels.bce`` hold the plain versions of
kernels K19 (``csrc/mlp_epilogue.cu``: the bias add, ReLU and the hidden
layer's round, their gradients, and the grouped round of an MLP's input and
weights) and K20 (``csrc/bce.cu``: the mean binary cross-entropy and its
gradient). The same numpy inputs go through ``mlp_apply`` /
``bce_with_logits`` of the JAX package on the CPU (``jax.vjp``,
``jax.value_and_grad``) and through the port's ``MLP`` / ``bce_with_logits``,
which run these plain versions on CPU tensors. The kernels are held against
the plain versions in test_torch_gpu.py.

XLA's CPU flushes subnormal floats to zero (``jax.nn.relu``'s gradient at
1e-40 is 0 there), PyTorch's CPU does not: the inputs here hold no
subnormal pre-activation; the GPU tests hold the kernel's mask at one.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvtabular_tpu.models import layers as jlayers
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch.kernels import LAUNCHES
from nvtabular_tpu_torch.kernels import bce as kbce
from nvtabular_tpu_torch.kernels import mlp_epilogue as kep
from nvtabular_tpu_torch.kernels import mlp_mm as kmm
from nvtabular_tpu_torch.kernels.adagrad import MAX_SEGMENTS, adagrad_plan

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
EDGES = np.array([-0.0, np.nan, np.inf, -np.inf, 1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -2.0, 0.0, 65520.0],
                 np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bits_nan(got, want):
    """Equal bits, NaN where NaN (payloads aside)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


# --- the epilogue's and the round's plain versions against jnp ---------------------------------------------
MODES = {"relu_round": (True, "bfloat16"), "relu_round_f16": (True, "float16"), "relu": (True, None),
         "bias": (False, None), "round": (False, "bfloat16")}


def _epilogue_case(rng, B=37, N=13):
    y = (rng.normal(size=(B, N)) * 3).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32)
    b[0] = -0.0
    y.reshape(-1)[: len(EDGES)] = EDGES  # column 0: -0.0 + -0.0 = -0.0 at z
    y[3::5, N - 1] = -b[N - 1]  # exact cancellation: z = +0.0
    g = rng.normal(size=(B, N)).astype(np.float32)
    g.reshape(-1)[20:25] = [np.nan, np.inf, -np.inf, 1.0 + 2.0**-8, -0.0]
    return y, b, g


def _jax_epilogue(relu, rnd):
    def f(y, b):
        z = y + b
        if relu:
            z = jax.nn.relu(z)
        return z if rnd is None else z.astype(DTYPES[rnd][1]).astype(jnp.float32)
    return f


@pytest.mark.parametrize("mode", list(MODES))
def test_epilogue_plain_matches_jax(mode):
    """round_c(relu(y + b)) and its vjp: the output and dz bit-equal to
    JAX's (NaN where NaN; relu(-0.0) = +0.0, a NaN pre-activation takes no
    gradient, an infinite g stays out of masked elements), db within
    float32 sums in another order; the mask is z > 0."""
    relu, rnd = MODES[mode]
    y, b, g = _epilogue_case(np.random.default_rng(0))
    want, vjp = jax.vjp(_jax_epilogue(relu, rnd), jnp.asarray(y), jnp.asarray(b))
    want_dz, want_db = vjp(jnp.asarray(g))
    py = t(y)
    mask = kep.mlp_epilogue_fwd_plain(py, t(b), relu, DTYPES[rnd][0] if rnd else None)
    assert_bits_nan(n(py), np.asarray(want))
    if relu:
        np.testing.assert_array_equal(n(mask), (y + b) > 0)
        assert not np.signbit(n(py)[0, 0])  # -0.0 + -0.0 -> relu -> +0.0
    else:
        assert mask is None
    dz, db = kep.mlp_epilogue_bwd_plain(t(g), mask, relu, DTYPES[rnd][0] if rnd else None)
    assert_bits_nan(n(dz), np.asarray(want_dz))
    np.testing.assert_allclose(n(db), np.asarray(want_db), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_round_group_plain_matches_jax_casts(dtype):
    """Each tensor's round trip through bfloat16 / float16, bit-equal to
    jnp's astype (round to nearest even, overflow to inf), NaN where NaN."""
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=s).astype(np.float32) * 300 for s in [(0,), (1,), (3,), (5,), (37, 13)]]
    xs[-1].reshape(-1)[: len(EDGES)] = EDGES
    got = kep.round_group([t(x) for x in xs], DTYPES[dtype][0])
    for x, a in zip(xs, got):
        assert_bits_nan(n(a), np.asarray(jnp.asarray(x).astype(DTYPES[dtype][1]).astype(jnp.float32)))


# --- the MLP through them against mlp_apply --------------------------------------------------------------
def _mlp_pair(rng, sizes, final_activation, compute_dtype):
    jparams = jlayers.mlp_init(jax.random.PRNGKey(int(rng.integers(1 << 30))), sizes)
    mlp = pmodels.MLP(sizes, final_activation=final_activation, compute_dtype=compute_dtype, device="cpu")
    with torch.no_grad():
        for w, b, layer in zip(mlp.weights, mlp.biases, jparams):
            w.copy_(t(layer["w"]))
            b.copy_(t(rng.normal(size=layer["b"].shape).astype(np.float32) * 0.1))
            layer["b"] = jnp.asarray(n(b))
    return jparams, mlp


def _close(got, want, rtol, atol, most=True):
    """float32 sums in another order: within rtol/atol and, with ``most``,
    99% of the entries to float32 precision (a value at a bfloat16 rounding
    boundary may round the other way, test_torch_models.py
    test_mlp_bfloat16_matches_jax)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert not most or np.isclose(got, want, rtol=1e-5, atol=1e-6).mean() > 0.99


@pytest.mark.parametrize("final_activation", [False, True])
@pytest.mark.parametrize("sizes", [[13, 64, 32, 16], [37, 33, 1]], ids=["13-64-32-16", "37-33-1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward_and_vjp_match_jax(dtype, sizes, final_activation):
    """MLP's output, dx and every dw and db against jax.vjp of mlp_apply for
    the same cotangent: in float32 only the sums' order differs (rtol 1e-5);
    in bfloat16 test_mlp_bfloat16_matches_jax's tolerances (rtol and atol
    1e-3, 99% within float32 precision). dw and db sum 300 rows whose terms
    cancel: within 1e-4 of them, not 99% to float32 precision."""
    rng = np.random.default_rng(6)
    torch_dtype, jax_dtype = DTYPES[dtype]
    jparams, mlp = _mlp_pair(rng, sizes, final_activation, torch_dtype)
    x = rng.normal(size=(300, sizes[0])).astype(np.float32)
    cot = rng.normal(size=(300, sizes[-1])).astype(np.float32)

    def f(params, x):
        return jlayers.mlp_apply(params, x, final_activation=final_activation, compute_dtype=jax_dtype)

    want, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))
    want_params, want_dx = vjp(jnp.asarray(cot))
    px = t(x).requires_grad_(True)
    got = mlp(px)
    got.backward(t(cot))
    rtol, atol = (1e-5, 1e-5) if dtype == "float32" else (1e-3, 1e-3)
    _close(n(got), want, rtol, atol)
    _close(n(px.grad), want_dx, rtol, atol)
    for w, b, layer in zip(mlp.weights, mlp.biases, want_params):
        _close(n(w.grad), layer["w"], rtol, max(atol, 1e-4), most=False)
        _close(n(b.grad), layer["b"], rtol, max(atol, 1e-4), most=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_relu_follows_jax_at_negative_zero(dtype):
    """Fault 10: a pre-activation of -0.0 (a zero input times negative
    weights, plus a bias of -0.0) gives jax.nn.relu's +0.0, where
    torch.relu gave -0.0."""
    torch_dtype, jax_dtype = DTYPES[dtype]
    mlp = pmodels.MLP([1, 2], final_activation=True, compute_dtype=torch_dtype, device="cpu")
    with torch.no_grad():
        mlp.weights[0].copy_(t([[-1.0, -2.0]]))
        mlp.biases[0].fill_(-0.0)
    x = np.zeros((3, 1), np.float32)
    params = [{"w": jnp.asarray([[-1.0, -2.0]], jnp.float32), "b": jnp.asarray([-0.0, -0.0], jnp.float32)}]
    want = np.asarray(jlayers.mlp_apply(params, jnp.asarray(x), final_activation=True, compute_dtype=jax_dtype))
    got = n(mlp(t(x)))
    assert not np.signbit(want).any()
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_vjp_follows_jax_at_a_nan_pre_activation(dtype):
    """Fault 10: a NaN input row makes every pre-activation of its row NaN;
    jax.nn.relu's gradient there is 0 (a select on z > 0), where autograd's
    threshold_backward passed the gradient on. dx, dw and db equal JAX's in
    where they are NaN and close elsewhere."""
    rng = np.random.default_rng(7)
    torch_dtype, jax_dtype = DTYPES[dtype]
    sizes = [5, 16, 8, 1]
    jparams, mlp = _mlp_pair(rng, sizes, False, torch_dtype)
    x = rng.normal(size=(40, 5)).astype(np.float32)
    x[3, 2] = np.nan
    cot = rng.normal(size=(40, 1)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, x: jlayers.mlp_apply(p, x, compute_dtype=jax_dtype),
                        jax.tree.map(jnp.asarray, jparams), jnp.asarray(x))
    want_params, want_dx = vjp(jnp.asarray(cot))
    px = t(x).requires_grad_(True)
    got = mlp(px)
    got.backward(t(cot))
    rtol, atol = (1e-5, 1e-5) if dtype == "float32" else (1e-3, 1e-3)
    pairs = [(px.grad, want_dx)] + [(p.grad, layer[k]) for w, b, layer in zip(mlp.weights, mlp.biases, want_params)
                                     for p, k in ((w, "w"), (b, "b"))]
    assert not np.isnan(np.asarray(want_dx)).any() and (np.asarray(want_dx)[3] == 0).all()  # the NaN row takes 0
    for a, w in pairs:
        a, w = n(a), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(w))
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(w), rtol=rtol, atol=atol)


def test_epilogue_in_place_leaves_the_product_s_saved_inputs_intact():
    """The epilogue runs in the product's store (K21's MLPProduct: one
    launch a layer on the card, no second [B, N] pass): the product's saved
    inputs, the rounded h and W, stay as they were, and the gradients equal
    those of the same layer written out of place."""
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    rng = np.random.default_rng(8)
    h0, w0 = rng.normal(size=(64, 13)).astype(np.float32), rng.normal(size=(13, 32)).astype(np.float32)
    b0, g = rng.normal(size=32).astype(np.float32), rng.normal(size=(64, 32)).astype(np.float32)
    h, w, b = (t(a).requires_grad_(True) for a in (h0, w0, b0))
    hr, wr = kep.round_tensors([h, w], torch.bfloat16)
    saved = hr.clone(), wr.clone()
    out = kmm.mlp_product(hr, wr, b, relu=True, round_dtype=torch.bfloat16)
    assert out.data_ptr() not in (hr.data_ptr(), wr.data_ptr())
    assert torch.equal(hr, saved[0]) and torch.equal(wr, saved[1])
    out.backward(t(g))
    h2, w2, b2 = (t(a).requires_grad_(True) for a in (h0, w0, b0))
    z = h2.to(torch.bfloat16).float() @ w2.to(torch.bfloat16).float() + b2
    ref = torch.where(z > 0, z, 0.0).to(torch.bfloat16).float()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    ref.backward(t(g))
    for a, r in ((h, h2), (w, w2), (b, b2)):
        torch.testing.assert_close(a.grad, r.grad, rtol=0, atol=0)


def test_round_group_takes_no_gradient_where_its_input_needs_none():
    """DLRM's bottom input needs no gradient: its rounded copy is marked
    non-differentiable, so the product computes no dx and the backward's
    round leaves that segment out."""
    x = torch.randn(8, 3)
    w = torch.randn(3, 4, requires_grad=True)
    xr, wr = kep.round_tensors([x, w], torch.bfloat16)
    assert not xr.requires_grad and wr.requires_grad
    (xr @ wr).sum().backward()
    assert x.grad is None and w.grad is not None
    torch.testing.assert_close(w.grad, xr.sum(0)[:, None].expand(3, 4).to(torch.bfloat16).float())


# --- the loss against bce_with_logits -------------------------------------------------------------------
LOGIT_EDGES = {"finite": [0.0, -0.0, 1e-30, -1e-30, 100.0, -100.0], "nonfinite": [np.inf, -np.inf, np.nan]}


def _bce_case(B, edges, rng):
    """Logits and labels [B]: at B = 5 five of the edges, at 65,537 every
    edge logit with each label first, the rest random."""
    logits = (rng.normal(size=B) * 4).astype(np.float32)
    labels = (rng.random(B) < 0.3).astype(np.float32)
    labels[::7] = 0.3
    vals = LOGIT_EDGES["finite"] + (LOGIT_EDGES["nonfinite"] if edges == "nonfinite" else [])
    combos = [(v, y) for v in vals for y in (0.0, 1.0, 0.3)]
    if B < len(combos):
        combos = {"finite": [(0.0, 1.0), (1e-30, 0.3), (-1e-30, 0.0), (100.0, 0.0), (-100.0, 1.0)],
                  "nonfinite": [(0.0, 1.0), (np.inf, 0.0), (-np.inf, 1.0), (np.nan, 0.3), (-0.0, 0.3)]}[edges]
    for i, (v, y) in enumerate(combos):
        logits[i], labels[i] = v, y
    return logits, labels


@pytest.mark.parametrize("edges", ["finite", "nonfinite"])
@pytest.mark.parametrize("B", [5, 65537])
def test_bce_plain_and_gradient_match_jax(B, edges):
    """The loss within rtol 1e-6 (sums in another order, log1p's ULPs) and
    the gradient within rtol 1e-6 (exp's ULPs) of jax.value_and_grad's, NaN
    where NaN: at logits 0, +-1e-30, +-100, +-inf and NaN with labels 0, 1
    and 0.3, the tie of maximum at 0 splitting its gradient and abs's
    gradient +1 there."""
    logits, labels = _bce_case(B, edges, np.random.default_rng(B))
    want, want_g = jax.value_and_grad(jlayers.bce_with_logits)(jnp.asarray(logits), jnp.asarray(labels))
    pl = t(logits).requires_grad_(True)
    loss = pmodels.bce_with_logits(pl, t(labels))
    loss.backward()
    if np.isnan(want):
        assert torch.isnan(loss)
    else:
        np.testing.assert_allclose(n(loss), np.asarray(want), rtol=1e-6)
    got_g, want_g = n(pl.grad), np.asarray(want_g)
    np.testing.assert_array_equal(np.isnan(got_g), np.isnan(want_g))
    np.testing.assert_allclose(np.nan_to_num(got_g), np.nan_to_num(want_g), rtol=1e-6, atol=1e-12)


def test_bce_gradient_follows_jax_at_a_zero_logit():
    """Fault 9: jax.grad(jnp.abs)(0.0) is 1, autograd's abs gradient at 0 is
    0. At logits [0, 2, -3, nan, inf] with labels [1, 0, 1, 1, 0] JAX's
    gradient is -y / B = -0.2 at the zero logit; the port gave -0.1."""
    logits = np.array([0.0, 2.0, -3.0, np.nan, np.inf], np.float32)
    labels = np.array([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    want = np.asarray(jax.grad(jlayers.bce_with_logits)(jnp.asarray(logits), jnp.asarray(labels)))
    pl = t(logits).requires_grad_(True)
    pmodels.bce_with_logits(pl, t(labels)).backward()
    got = n(pl.grad)
    assert abs(want[0] + 0.2) < 1e-6 and abs(got[0] - want[0]) <= 1e-6 * abs(want[0])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), rtol=1e-6)


def test_bce_plain_divides_grad_output_by_b():
    """grad_output / B is a division: at B = 3 the quotient 2.5 / 3 and the
    product 2.5 * (1 / 3) differ in float32. A logit of +inf with label 0
    takes exactly that quotient; every other element follows the plain
    expression's terms."""
    logits = torch.tensor([np.inf, 1.5, 0.0])
    labels = torch.tensor([0.0, 0.3, 1.0])
    got = n(kbce.bce_bwd_plain(logits, labels, torch.tensor(2.5)))
    g = np.float32(2.5) / np.float32(3)
    assert g != np.float32(2.5) * (np.float32(1) / np.float32(3))
    assert got[0] == g
    h = g / np.float32(2)  # l = 0, y = 1: e = 1, so c = g / 2
    assert got[2] == (-h + -g) + g * np.float32(0.5)
    e = np.float32(np.exp(np.float32(-1.5)))
    c = g / (e + np.float32(1)) * e
    np.testing.assert_allclose(got[1], (-c + -g * np.float32(0.3)) + g, rtol=1e-6)


def test_bce_refuses_labels_that_need_a_gradient():
    with pytest.raises(ValueError):
        pmodels.bce_with_logits(torch.zeros(4), torch.zeros(4, requires_grad=True))


# --- the host plans and the wrappers' checks --------------------------------------------------------------
@pytest.mark.parametrize("count", [1, 65, 130])
def test_round_group_plan_and_plain_at_many_tensors(count):
    """1, 65 and 130 tensors of lengths 0, 1, 3 and 5 and a row-strided
    view: launches of at most MAX_SEGMENTS nonempty tensors, each
    tensor's round equal to its casts, outputs contiguous."""
    rng = np.random.default_rng(count)
    ts = [t(rng.normal(size=[0, 1, 3, 5][i % 4]).astype(np.float32)) for i in range(count - 1)]
    ts.append(t(rng.normal(size=(9, 44)).astype(np.float32))[:, :41])  # the tabular MLP's input, as a view
    plan = adagrad_plan([x.numel() for x in ts])
    live = [i for i, x in enumerate(ts) if x.numel()]
    assert [i for idx, _ in plan for i in idx] == live
    assert len(plan) == -(-len(live) // MAX_SEGMENTS)
    assert kep._segment(ts[-1]) == (41, 44) and kep._segment(torch.zeros(3, 41)) == (0, 0)
    got = kep.round_group(ts, torch.bfloat16)
    for x, a in zip(ts, got):
        assert a.is_contiguous() and a.shape == x.shape
        assert torch.equal(a, x.to(torch.bfloat16).float())


def test_round_group_plan_past_2_31_floats():
    """A plan from lengths alone: the 64-bit unit prefix past 2^31 floats."""
    (idx, start), = adagrad_plan([2**31 + 5, 3, 2**33])
    assert idx == [0, 1, 2] and start == [0, 2**29 + 2, 2**29 + 3, 2**29 + 3 + 2**31]


@pytest.mark.parametrize("B, N, vec, want", [
    (65536, 512, 4, (32, 4, 264)), (65536, 256, 4, (32, 2, 528)), (65536, 16, 4, (4, 1, 1024)),
    (65536, 1, 1, (1, 1, 256)), (7, 13, 1, (16, 1, 1)), (1, 367, 1, (32, 12, 1)), (0, 3, 1, (4, 1, 1)),
    (2**26, 1, 1, (1, 1, 1056)),
])
def test_epilogue_plan(B, N, vec, want):
    """tx lanes across tx * vec columns (the power of two that covers N /
    vec, at most a warp), col_tiles that cover N, row blocks that take the
    steps of 256 / tx rows in turn, about TARGET_BLOCKS blocks in all."""
    tx, col_tiles, row_blocks = kep.epilogue_plan(B, N, vec)
    assert (tx, col_tiles, row_blocks) == want
    assert tx * vec * col_tiles >= N > tx * vec * (col_tiles - 1)
    assert 1 <= row_blocks <= max(1, -(-B // (kep.THREADS // tx)))


def test_epilogue_plan_refuses_bad_shapes():
    for args in ((4, 0, 1), (4, 6, 4), (-1, 4, 1), (4, 4, 2)):
        with pytest.raises(ValueError):
            kep.epilogue_plan(*args)


def test_wrappers_check_their_inputs():
    y, w, b = torch.zeros(4, 3), torch.eye(3), torch.zeros(3)
    for bad in ((torch.zeros(4, 3, dtype=torch.float64), w, b), (y, w, torch.zeros(4)), (y, torch.eye(4), b),
                (torch.zeros(12), w, b)):
        with pytest.raises((TypeError, ValueError)):
            kmm.mlp_mm_fwd(*bad, relu=True)  # the forward epilogue runs in K21's store
    with pytest.raises(ValueError):
        kep.mlp_epilogue_bwd(torch.zeros(4, 3), None, relu=True)  # ReLU's gradient needs the mask
    with pytest.raises(NotImplementedError):
        kmm.mlp_mm_fwd(y, w, b, True, torch.float64)
    with pytest.raises(ValueError):
        kep.round_group([torch.zeros(4), torch.zeros(4, dtype=torch.float64)], torch.bfloat16)
    with pytest.raises(ValueError):
        kep.round_group([torch.zeros(4, 4)[:, ::2]], torch.bfloat16)  # rows not contiguous
    with pytest.raises(NotImplementedError):
        kep.round_group([torch.zeros(4)], torch.float32)
    with pytest.raises(ValueError):
        kbce.bce_fwd(torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError):
        kbce.bce_bwd(torch.zeros(4), torch.zeros(4), torch.zeros(2))
    before = dict(LAUNCHES)
    kmm.mlp_mm_fwd(y, w, b, True, torch.bfloat16)
    kbce.bce_fwd(torch.zeros(4), torch.zeros(4))
    assert LAUNCHES == before  # the plain versions count nothing


def test_constants_match_the_sources():
    """THREADS, the round kinds and bce's blocks, which the plans repeat,
    are csrc/mlp_epilogue.cu's and csrc/bce.cu's; round_group's segment
    limit is K18's."""
    csrc = Path(kep.__file__).parent.parent / "csrc"
    ep, bce = (csrc / "mlp_epilogue.cu").read_text(), (csrc / "bce.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const(ep, "kThreads") == kep.THREADS and const(ep, "kMaxSegments") == MAX_SEGMENTS
    assert const(ep, "kWarp") == kep.WARP and const(ep, "kMaxRowBlocks") == kep.MAX_ROW_BLOCKS
    assert const(bce, "kThreads") == kbce.THREADS and const(bce, "kItems") == kbce.ITEMS
    assert const(bce, "kMaxBlocks") == kbce.MAX_BLOCKS
    assert kep.ROUND_KINDS == {None: 0, torch.bfloat16: 1, torch.float16: 2}
