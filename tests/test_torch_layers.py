"""The self-interaction mode of kernel K13b and the xDeepFM CIN layer (kernel
K13d) of nvtabular_tpu_torch against the JAX package on the CPU.

The same numpy inputs go through ``dot_product_interaction(...,
self_interaction=True)`` and ``xdeepfm_outer_product`` of
``nvtabular_tpu/models/layers.py`` and of the port, which runs the kernels'
plain versions here; gradients are held against ``jax.vjp`` for the same
output cotangent. Tolerances: float32 sums in another order than XLA's CPU
dot_general (the CIN's over Hk * F pair products, and dw's over B * D
terms), so each entry within 1e-5 of the sum of its terms' magnitudes plus
1e-6. The CUDA kernels are held against these plain versions in
test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvtabular_tpu.models import layers as jlayers
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch.kernels import LAUNCHES
from nvtabular_tpu_torch.kernels import cin as kcin
from nvtabular_tpu_torch.kernels import interaction as kint

RTOL, ATOL = 1e-5, 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_within_terms(got, want, magnitude):
    """|got - want| <= RTOL * (the sum of the terms' magnitudes) + ATOL."""
    got, want, magnitude = n(got), np.asarray(want), np.asarray(magnitude)
    assert got.shape == want.shape
    excess = np.abs(got - want) - (RTOL * magnitude + ATOL)
    assert (excess <= 0).all(), f"max excess {excess.max()} at {np.unravel_index(excess.argmax(), excess.shape)}"


# --- K13b with self_interaction=True ------------------------------------------------------
@pytest.mark.parametrize("F,D", [(5, 8), (1, 3), (27, 16), (1, 16), (28, 12), (27, 66)])
def test_self_interaction_and_grad_match_jax(F, D):
    """F (F + 1) / 2 dots in np.tril_indices(F, 0) order, the diagonal's
    gradient 2 g_ii x_i; F = 1 has the one self pair ((1, 16): one row of
    a row block of 8 in the backward kernel's plan); (28, 12) takes four
    blocks; (27, 66) more items a sample than the block has threads."""
    rng = np.random.default_rng(F)
    B = 37
    x = rng.normal(size=(B, F, D)).astype(np.float32)
    cot = rng.normal(size=(B, F * (F + 1) // 2)).astype(np.float32)

    def jfn(f):
        return jlayers.dot_product_interaction(f, self_interaction=True)

    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    mag, mvjp = jax.vjp(jfn, jnp.abs(jnp.asarray(x)))
    (mag_dx,) = mvjp(jnp.abs(jnp.asarray(cot)))

    px = t(x).requires_grad_(True)
    got = pmodels.dot_product_interaction(px, self_interaction=True)
    got.backward(t(cot))
    assert got.shape == (B, F * (F + 1) // 2)
    assert_within_terms(got, want, mag)
    assert_within_terms(px.grad, want_dx, mag_dx)
    assert sum(LAUNCHES.values()) == 0  # CPU tensors never launch a kernel


def test_self_interaction_pairs_are_the_strict_pairs_and_the_diagonal():
    """The self mode's output holds the strict mode's dots and each
    feature's squared norm, at np.tril_indices(F, 0)'s positions."""
    x = torch.randn(4, 6, 5, generator=torch.Generator().manual_seed(1))
    full = kint.interaction_fwd(x, self_interaction=True)
    strict = kint.interaction_fwd(x)
    rows, cols = np.tril_indices(6, 0)
    off = rows != cols
    torch.testing.assert_close(full[:, off], strict, rtol=0, atol=0)
    torch.testing.assert_close(full[:, ~off], (x * x).sum(-1), rtol=1e-6, atol=1e-6)


def test_dlrm_interaction_with_a_lead_writes_after_it():
    """dot_interaction with a lead and the self mode: [lead, self dots]."""
    x = torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(2))
    lead = torch.randn(3, 8, generator=torch.Generator().manual_seed(3))
    out = kint.dot_interaction(x, lead, self_interaction=True)
    assert out.shape == (3, 8 + 10)
    torch.testing.assert_close(out[:, :8], lead, rtol=0, atol=0)
    torch.testing.assert_close(out[:, 8:], kint.interaction_fwd_plain(x, True), rtol=0, atol=0)



INF, NAN = float("inf"), float("nan")
NONFINITE_X = {
    # (b, i, d, value): the entries of x set before the gradient
    "inf": [(0, 5, 3, INF)],
    "neg_inf": [(1, 9, 7, -INF)],
    "nan": [(0, 26, 15, NAN)],
    "inf_and_nan": [(0, 5, 3, INF), (1, 9, 7, NAN)],
    "two_in_one_column": [(1, 4, 6, INF), (1, 20, 6, -INF)],
}


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
@pytest.mark.parametrize("case", sorted(NONFINITE_X))
def test_interaction_grad_follows_jax_at_nonfinite_x(case, self_interaction):
    """The plain backward (which the kernels equal bit for bit) against
    jax.vjp of dot_product_interaction where x has inf, -inf or NaN: the
    reference's dense products take every zero weight of the scattered [F,
    F] gradient, so dX[b, i, d] is NaN wherever another row's x[b, j, d] is
    not finite, and in the strict mode also where x[b, i, d] itself is not;
    the self mode's own row of a lone inf is +-inf (2 g_ii * inf). NaN and
    inf positions exactly; finite entries within 1e-5 of their terms'
    magnitudes + 1e-6."""
    rng = np.random.default_rng(27)
    B, F, D = 2, 27, 16
    x = rng.normal(size=(B, F, D)).astype(np.float32)
    for b, i, d, v in NONFINITE_X[case]:
        x[b, i, d] = v
    cot = rng.normal(size=(B, kint.num_pairs(F, self_interaction))).astype(np.float32)

    def jfn(f):
        return jlayers.dot_product_interaction(f, self_interaction=self_interaction)

    _, vjp = jax.vjp(jfn, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    finite_x = np.where(np.isfinite(x), x, 0.0).astype(np.float32)
    _, mvjp = jax.vjp(jfn, jnp.abs(jnp.asarray(finite_x)))
    mag = np.asarray(mvjp(jnp.abs(jnp.asarray(cot)))[0])
    got = n(kint.interaction_bwd_plain(t(x), t(cot), self_interaction))

    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    columns = {(b, d) for b, _, d, _ in NONFINITE_X[case]}
    assert int(np.isnan(want).sum()) >= len(columns) * (F - 1)  # every other row of each such column
    finite = np.isfinite(want)
    assert_within_terms(got[finite], want[finite], mag[finite])


# --- K13d: the xDeepFM CIN layer -----------------------------------------------------------
CIN_CASES = [
    # (B, Hk, F, D, Hn, same): layer 1 (x_k is x_0), a deeper layer (Hk != F), odd D
    (33, 6, 6, 8, 10, True),
    (29, 7, 5, 4, 9, False),
    (17, 3, 4, 5, 1, False),
    (0, 3, 4, 5, 2, False),
    # Hk + F = 926: past what the forward stages whole (x_k in chunks on the card)
    (3, 900, 26, 2, 3, False),
]


@pytest.mark.parametrize("B,Hk,F,D,Hn,same", CIN_CASES, ids=["layer1_same", "hk_ne_f", "odd_d", "empty", "hk_f_926"])
def test_xdeepfm_outer_product_and_grads_match_jax(B, Hk, F, D, Hn, same):
    rng = np.random.default_rng(B + Hk)
    x0 = rng.normal(size=(B, F, D)).astype(np.float32)
    xk = x0 if same else rng.normal(size=(B, Hk, D)).astype(np.float32)
    w = (rng.normal(size=(Hk * F, Hn)) / np.sqrt(Hk * F)).astype(np.float32)
    cot = rng.normal(size=(B, Hn, D)).astype(np.float32)

    if same:
        def jfn(a, ww):
            return jlayers.xdeepfm_outer_product(a, a, ww)
        args = (x0, w)
    else:
        def jfn(a, b, ww):
            return jlayers.xdeepfm_outer_product(a, b, ww)
        args = (xk, x0, w)
    want, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(cot))
    mag, mvjp = jax.vjp(jfn, *[jnp.abs(jnp.asarray(a)) for a in args])
    mag_grads = mvjp(jnp.abs(jnp.asarray(cot)))

    leaves = [t(a).requires_grad_(True) for a in args]
    got = pmodels.xdeepfm_outer_product(leaves[0], leaves[0], leaves[1]) if same else \
        pmodels.xdeepfm_outer_product(*leaves)
    assert got.shape == (B, Hn, D) and got.dtype == torch.float32
    got.backward(t(cot))
    assert_within_terms(got, want, mag)
    for leaf, w_grad, m_grad in zip(leaves, want_grads, mag_grads):
        # x_k is x_0: autograd sums the two gradients, as jax.vjp does
        assert_within_terms(leaf.grad, w_grad, m_grad)


def test_cin_plain_versions_are_the_layer_and_its_vjp():
    """cin_fwd / cin_bwd on CPU tensors are the plain versions; the layer's
    autograd gives cin_bwd's three gradients."""
    g = torch.Generator().manual_seed(4)
    xk, x0 = torch.randn(6, 3, 4, generator=g), torch.randn(6, 5, 4, generator=g)
    w, cot = torch.randn(15, 7, generator=g), torch.randn(6, 7, 4, generator=g)
    leaves = [a.clone().requires_grad_(True) for a in (xk, x0, w)]
    out = kcin.cin(*leaves)
    out.backward(cot)
    torch.testing.assert_close(out.detach(), kcin.cin_fwd_plain(xk, x0, w), rtol=0, atol=0)
    for leaf, want in zip(leaves, kcin.cin_bwd(xk, x0, w, cot)):
        torch.testing.assert_close(leaf.grad, want, rtol=1e-6, atol=1e-6)
    z = kcin.outer_product_plain(xk, x0)
    torch.testing.assert_close(z[:, 2 * 5 + 3], xk[:, 2] * x0[:, 3], rtol=0, atol=0)  # i-major pair index


@pytest.mark.parametrize(
    "call,error",
    [
        (lambda: pmodels.xdeepfm_outer_product(torch.zeros(2, 3, 4, dtype=torch.int32),
                                               torch.zeros(2, 5, 4, dtype=torch.int32),
                                               torch.zeros(15, 6)), TypeError),
        (lambda: pmodels.xdeepfm_outer_product(torch.zeros(2, 3, 4), torch.zeros(2, 5, 4), torch.zeros(14, 6)),
         ValueError),
        (lambda: pmodels.xdeepfm_outer_product(torch.zeros(2, 3, 4), torch.zeros(3, 5, 4), torch.zeros(15, 6)),
         ValueError),
        (lambda: pmodels.xdeepfm_outer_product(torch.zeros(2, 3, 4), torch.zeros(2, 5, 4)[:, :, :3],
                                               torch.zeros(15, 6)), ValueError),
        (lambda: pmodels.xdeepfm_outer_product(torch.zeros(2, 3, 4, dtype=torch.bfloat16),
                                               torch.zeros(2, 5, 4, dtype=torch.float16), torch.zeros(15, 6)),
         TypeError),
        (lambda: pmodels.xdeepfm_outer_product(torch.zeros(2, 3, 4), torch.zeros(2, 5, 4),
                                               torch.zeros(15, 6, dtype=torch.bfloat16)), TypeError),
    ],
    ids=["int32", "w_rows", "batch_mismatch", "d_mismatch", "mixed_x_dtypes", "w_16_bit_under_float32"],
)
def test_xdeepfm_outer_product_rejects_wrong_inputs(call, error):
    with pytest.raises(error):
        call()
