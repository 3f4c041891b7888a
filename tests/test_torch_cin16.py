"""Kernel K13d's 16-bit case: the xDeepFM CIN layer of nvtabular_tpu_torch
in bfloat16 and float16 against the JAX package on the CPU.

The same seeded numpy inputs, rounded to the layer's dtype T, go through
``xdeepfm_outer_product`` of ``nvtabular_tpu/models/layers.py`` and of the
port, which runs its kernel's plain versions here (the CUDA kernels are held
against these in test_torch_gpu.py); gradients against ``jax.vjp`` for one
output cotangent in T. The reference rounds z = x_k * x_0 to T before its
float32 pair sum and rounds the output to T; its vjp widens g, rounds dz =
sum_h w g to T, rounds each product dz * x_0 and dz * x_k to T and sums them
with ``reduce_sum`` in T, and rounds dw's float32 sum to w's dtype.

Tolerances. u is T's unit roundoff (bfloat16 2^-8, float16 2^-11) and an
ULP the spacing of T at a value:

* out: within one ULP of T. Both sum the same rounded z in float32, in
  other orders; where the sum lies near a rounding boundary of T the two
  round to neighbours (at these sizes most entries are bit-equal).
* dw: float32 sums over B * D in another order, 1e-5 of the sum of the
  terms' magnitudes plus 1e-6; a 16-bit dw also one ULP of its dtype.
* dx_k, dx_0: XLA's CPU ``reduce_sum`` in T adds the rounded products one
  by one and rounds every partial sum to T, where the port sums in float32
  and rounds once; each of the n partial sums moves by at most u of the
  running sum, so the two lie within (n + 2) u of the sum of the terms'
  magnitudes (the 2: dz's and the result's own rounds). Against the
  rounding points with float32 sums (``_points``, numpy) the port is within
  one ULP of T.

All-bfloat16 cannot run through XLA's CPU dot (``BF16 x BF16 = F32`` is
unsupported there), so its JAX side takes w widened to float32, which is
exact, and rounds its float32 dw to bfloat16 (that rounding is the only
difference of the all-bfloat16 vjp, which rounds dw's float32 sum to w's
dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvtabular_tpu.models import layers as jlayers
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch.kernels import cin as kcin

TORCH = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
JAX = {"bfloat16": jnp.bfloat16, "float16": jnp.float16, "float32": jnp.float32}
UNIT = {"bfloat16": 2.0**-8, "float16": 2.0**-11}
SHAPES = [  # B, Hk, F, D, Hn, x_k is x_0
    (5, 4, 6, 8, 7, False),
    (7, 1, 5, 3, 4, False),
    (6, 3, 1, 5, 9, False),
    (0, 3, 4, 5, 2, False),
    (4, 26, 26, 16, 20, True),
]
SHAPE_IDS = ["hk_ne_f", "hk_1_odd_d", "f_1", "empty", "layer1_same"]
DTYPES = [("float16", "float16"), ("float16", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")]
DTYPE_IDS = ["f16", "f16_w32", "bf16_w32", "bf16"]


def f32(a) -> np.ndarray:
    """A JAX or torch array as float32 numpy (exact for 16-bit values)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def rounded(a: np.ndarray, dt: str) -> np.ndarray:
    """float32 values rounded to dt and widened again."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(JAX[dt]).astype(jnp.float32))


def ulps(got: np.ndarray, want: np.ndarray, dt: str) -> np.ndarray:
    """T values apart in ULPs of T (both arrays hold values of T)."""
    def ordered(a):
        bits = torch.from_numpy(np.ascontiguousarray(a)).to(TORCH[dt]).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits).numpy()

    return np.abs(ordered(got) - ordered(want))


def assert_within(got, want, tol, what):
    excess = np.abs(f32(got) - want) - tol
    assert (excess <= 0).all(), f"{what}: max excess {excess.max()} at {np.unravel_index(excess.argmax(), excess.shape)}"


def _inputs(shape, dt, wdt):
    B, Hk, F, D, Hn, same = shape
    rng = np.random.default_rng(B * 1000 + Hk * 10 + F)
    x0 = rounded(rng.normal(size=(B, F, D)).astype(np.float32), dt)
    xk = x0 if same else rounded(rng.normal(size=(B, Hk, D)).astype(np.float32), dt)
    w = (rng.normal(size=(Hk * F, Hn)) / np.sqrt(Hk * F)).astype(np.float32)
    w = w if wdt == "float32" else rounded(w, wdt)
    g = rounded(rng.normal(size=(B, Hn, D)).astype(np.float32), dt)
    return xk, x0, w, g


def _points(xk, x0, w, g, dt, wdt):
    """The rounding points with float32 sums, in numpy: (out, dx_k, dx_0,
    dw) and the magnitudes of the terms each sums."""
    B, Hk, D = xk.shape
    F = x0.shape[1]
    z = rounded(xk[:, :, None] * x0[:, None], dt).reshape(B, Hk * F, D)
    out = rounded(np.einsum("kh,bkd->bhd", w, z), dt)
    dz = rounded(np.einsum("kh,bhd->bkd", w, g), dt).reshape(B, Hk, F, D)
    pk, p0 = rounded(dz * x0[:, None], dt), rounded(dz * xk[:, :, None], dt)
    dw = np.einsum("bkd,bhd->kh", z, g)
    dw = dw if wdt == "float32" else rounded(dw, wdt)
    mags = (np.einsum("kh,bkd->bhd", np.abs(w), np.abs(z)), np.abs(pk).sum(2), np.abs(p0).sum(1),
            np.einsum("bkd,bhd->kh", np.abs(z), np.abs(g)))
    return (out, rounded(pk.sum(2), dt), rounded(p0.sum(1), dt), dw), mags


def _port(xk, x0, w, g, dt, wdt, same):
    """The port's layer and its autograd gradients: (out, grads)."""
    leaves = [torch.from_numpy(a).to(TORCH[d]).requires_grad_(True)
              for a, d in ((x0, dt), (w, wdt))] if same else \
        [torch.from_numpy(a).to(TORCH[d]).requires_grad_(True) for a, d in ((xk, dt), (x0, dt), (w, wdt))]
    out = pmodels.xdeepfm_outer_product(leaves[0], leaves[0], leaves[1]) if same else \
        pmodels.xdeepfm_outer_product(*leaves)
    assert out.dtype == TORCH[dt] and out.shape == (xk.shape[0], w.shape[1], xk.shape[2])
    out.backward(torch.from_numpy(g).to(TORCH[dt]))
    for leaf in leaves:
        assert leaf.grad.dtype == leaf.dtype
    return out, [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("dt,wdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_cin16_forward_and_vjp_match_jax(shape, dt, wdt):
    """The port's 16-bit layer and its gradients against ``jax.vjp`` at the
    tolerances of the module docstring; x_k may be x_0 itself, whose two
    gradients both sides add in T."""
    same = shape[5]
    xk, x0, w, g = _inputs(shape, dt, wdt)
    jw = "float32" if wdt == "bfloat16" else wdt  # all-bfloat16: w widened for XLA's CPU dot (exact)
    if same:
        def jfn(a, ww):
            return jlayers.xdeepfm_outer_product(a, a, ww)
        args = (jnp.asarray(x0, JAX[dt]), jnp.asarray(w, JAX[jw]))
    else:
        def jfn(a, b, ww):
            return jlayers.xdeepfm_outer_product(a, b, ww)
        args = (jnp.asarray(xk, JAX[dt]), jnp.asarray(x0, JAX[dt]), jnp.asarray(w, JAX[jw]))
    want, vjp = jax.vjp(jfn, *args)
    assert want.dtype == JAX[dt]
    want_grads = [f32(a) for a in vjp(jnp.asarray(g, JAX[dt]))]
    if wdt == "bfloat16":
        want_grads[-1] = rounded(want_grads[-1], "bfloat16")

    out, grads = _port(xk, x0, w, g, dt, wdt, same)
    assert (ulps(f32(out), f32(want), dt) <= 1).all()
    _, (_, mk, m0, mw) = _points(xk, x0, w, g, dt, wdt)
    u = UNIT[dt]
    B, Hk, F, D, Hn, _ = shape
    dw_tol = 1e-5 * mw + 1e-6 + (0 if wdt == "float32" else 2 * UNIT[wdt] * np.abs(want_grads[-1]))
    assert_within(grads[-1], want_grads[-1], dw_tol, "dw")
    tol_k, tol_0 = (F + 2) * u * mk, (Hk + 2) * u * m0
    if same:  # dx_k + dx_0, added in T: one more round
        sums = want_grads[0]
        assert_within(grads[0], sums, tol_k + tol_0 + u * np.abs(sums), "dx")
    else:
        assert_within(grads[0], want_grads[0], tol_k, "dx_k")
        assert_within(grads[1], want_grads[1], tol_0, "dx_0")


@pytest.mark.parametrize("dt,wdt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("shape", SHAPES[:4], ids=SHAPE_IDS[:4])
def test_cin16_plain_versions_round_at_the_reference_points(shape, dt, wdt):
    """cin_fwd / cin_bwd on CPU tensors against the rounding points with
    float32 sums written out in numpy (``_points``): out, dx_k and dx_0
    within one ULP of T (float32 sums in another order), dw as in the
    vjp test."""
    xk, x0, w, g = _inputs(shape, dt, wdt)
    (out, dxk, dx0, dw), (_, _, _, mw) = _points(xk, x0, w, g, dt, wdt)
    T, TW = TORCH[dt], TORCH[wdt]
    args = [torch.from_numpy(xk).to(T), torch.from_numpy(x0).to(T), torch.from_numpy(w).to(TW)]
    got = kcin.cin_fwd(*args)
    assert got.dtype == T
    assert (ulps(f32(got), out, dt) <= 1).all()
    gk, g0, gw = kcin.cin_bwd(*args, torch.from_numpy(g).to(T))
    assert (gk.dtype, g0.dtype, gw.dtype) == (T, T, TW)
    assert (ulps(f32(gk), dxk, dt) <= 1).all() and (ulps(f32(g0), dx0, dt) <= 1).all()
    dw_tol = 1e-5 * mw + 1e-6 + (0 if wdt == "float32" else 2 * UNIT[wdt] * np.abs(dw))
    assert_within(gw, dw, dw_tol, "dw")


def test_cin16_products_round_before_the_sum():
    """z rounds to T before the pair sum: w picks z[0, 0] = (1 + 2^-7)^2 =
    1 + 2^-6 + 2^-14 and z[1, 1] = 2^-8. Rounded first, 1 + 2^-6 + 2^-8 is
    a tie that bfloat16 rounds to the even 1 + 2^-6; the unrounded sum lies
    2^-14 past the tie and would round up to 1 + 3 * 2^-7."""
    xk = np.array([[[1.0 + 2.0**-7], [1.0]]], np.float32)  # [1, 2, 1]
    x0 = np.array([[[1.0 + 2.0**-7], [2.0**-8]]], np.float32)
    w = np.array([[1.0], [0.0], [0.0], [1.0]], np.float32)
    want = jlayers.xdeepfm_outer_product(jnp.asarray(xk, jnp.bfloat16), jnp.asarray(x0, jnp.bfloat16),
                                         jnp.asarray(w))
    got = kcin.cin_fwd(torch.from_numpy(xk).to(torch.bfloat16), torch.from_numpy(x0).to(torch.bfloat16),
                       torch.from_numpy(w))
    assert f32(got).ravel().tolist() == f32(want).ravel().tolist() == [1.0 + 2.0**-6]
