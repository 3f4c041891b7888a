"""The training step's Adagrad update (K18) of nvtabular_tpu_torch against optax.

``kernels.adagrad.adagrad_update_plain`` is the plain version of kernel
K18 (``csrc/adagrad.cu``), the port of the update that the JAX train step
runs inside ``jax.jit`` (``optax.adagrad(1e-2)``: ``scale_by_rss``, the
learning rate and ``apply_updates``). The same numpy inputs go through
optax on the CPU and through the plain version; ``adagrad_plan``, the host
plan of the kernel's launches, is held at its edges. The kernel itself is
held against the plain version in test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch.kernels import LAUNCHES
from nvtabular_tpu_torch.kernels import adagrad as kada

LR = 1e-2
# optax on XLA's CPU against PyTorch's CPU ops: rsqrt and a contracted
# multiply-add may round the last bit differently, as in the existing
# Adagrad tests
TOL = dict(rtol=1e-5, atol=1e-7)


def _case(name, rng):
    """(params, accumulators or None for optax's initial 0.1, three steps' gradients)."""
    shapes = [(1,), (3,), (5,), (7,), (13, 3), (1001,), (37, 16)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(3)]
    accs = None
    if name == "zero_rows":  # a table whose gradient is zero in most rows
        for g in grads:
            g[-1][rng.random(37) < 0.7] = 0.0
    elif name == "signed_zeros":
        for p in params:
            p.reshape(-1)[::2] = -0.0
        for g in grads:
            for x in g:
                x.reshape(-1)[::3] = -0.0
                x.reshape(-1)[1::3] = 0.0
    elif name == "nonfinite_grads":
        grads[0][5].reshape(-1)[[3, 10]] = [np.nan, np.inf]
        grads[1][4].reshape(-1)[[0, 7]] = [-np.inf, np.nan]
        grads[2][2][1] = np.inf
    elif name == "nan_accumulator":
        accs = [np.full(s, 0.1, np.float32) for s in shapes]
        accs[5][[0, 500]] = np.nan
        accs[6][4] = np.nan
    return params, accs, grads


def _optax_steps(params, accs, grads):
    opt = optax.adagrad(LR)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    if accs is not None:
        state = (state[0]._replace(sum_of_squares=[jnp.asarray(a) for a in accs]),) + tuple(state[1:])
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
    return [np.asarray(p) for p in jp], [np.asarray(a) for a in state[0].sum_of_squares]


def _plain_steps(params, accs, grads):
    pp = [torch.from_numpy(p.copy()) for p in params]
    pa = [torch.full_like(p, pmodels.training.INITIAL_ACCUMULATOR) for p in pp] if accs is None else \
        [torch.from_numpy(a.copy()) for a in accs]
    for g in grads:
        kada.adagrad_update_plain(pp, pa, [torch.from_numpy(x) for x in g], LR)
    return [p.numpy() for p in pp], [a.numpy() for a in pa]


@pytest.mark.parametrize("name", ["odd_lengths", "zero_rows", "signed_zeros", "nonfinite_grads", "nan_accumulator"])
def test_adagrad_update_plain_matches_optax(name):
    """Three steps over seven tensors of odd lengths (1, 3, 5, 7, 39, 1001,
    592): parameters and accumulators within TOL, NaN where optax has NaN
    (a NaN or inf gradient makes the parameter NaN: 0 * inf; a NaN
    accumulator gives scale 0 and leaves the parameter), and the signs of
    zero parameters as optax leaves them (-0.0 minus +0.0 is +0.0)."""
    params, accs, grads = _case(name, np.random.default_rng(11))
    want_p, want_a = _optax_steps(params, accs, grads)
    got_p, got_a = _plain_steps(params, accs, grads)
    for i, (gp, wp, ga, wa) in enumerate(zip(got_p, want_p, got_a, want_a)):
        np.testing.assert_allclose(gp, wp, **TOL, err_msg=f"param {i}")
        np.testing.assert_allclose(ga, wa, **TOL, err_msg=f"accumulator {i}")
        zeros = wp == 0
        np.testing.assert_array_equal(np.signbit(gp[zeros]), np.signbit(wp[zeros]), err_msg=f"param {i}")
    if name == "nonfinite_grads":
        assert np.isnan(got_p[5].reshape(-1)[[3, 10]]).all() and np.isnan(got_p[2][1])
    if name == "nan_accumulator":
        assert np.isnan(got_a[5][[0, 500]]).all()
        np.testing.assert_array_equal(got_p[5][[0, 500]] != params[5][[0, 500]], [False, False])


@pytest.mark.parametrize("p_fill", [0.5, -0.0, 0.0, np.nan])
def test_zero_gradient_elements_unchanged_against_optax(p_fill):
    """Elements whose gradient bits are all zero (+0.0) in every step keep
    their parameter and accumulator bits, in optax and in the plain version:
    what lets the kernel skip them."""
    rng = np.random.default_rng(12)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    table[::3] = p_fill
    grads = []
    for _ in range(3):
        g = rng.normal(size=table.shape).astype(np.float32)
        g[rng.random(64) < 0.75] = 0.0
        grads.append([g])
    untouched = np.all([g[0] == 0 for g in grads], axis=0) & ~np.any([np.signbit(g[0]) for g in grads], axis=0)
    assert untouched.any()
    want_p, want_a = _optax_steps([table], None, grads)
    got_p, got_a = _plain_steps([table], None, grads)
    bits = lambda a: a.view(np.uint32)[untouched]  # noqa: E731
    init_acc = np.full(table.shape, 0.1, np.float32)
    for p, a in ((want_p[0], want_a[0]), (got_p[0], got_a[0])):
        if np.isnan(p_fill):  # NaN stays NaN; its payload is the adder's
            assert np.array_equal(np.isnan(p[untouched]), np.isnan(table[untouched]))
            keep = untouched & ~np.isnan(table)
            np.testing.assert_array_equal(p.view(np.uint32)[keep], table.view(np.uint32)[keep])
        else:
            np.testing.assert_array_equal(bits(p), bits(table))
        np.testing.assert_array_equal(bits(a), bits(init_acc))


def test_adagrad_step_runs_the_update_once_for_parameters_with_gradients():
    """Adagrad.step hands every parameter with a gradient to adagrad_update
    and leaves the others: on the CPU the plain version runs and no kernel
    launch is counted."""
    ps = [torch.nn.Parameter(torch.ones(5)), torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2, 2))]
    opt = pmodels.Adagrad(ps, lr=LR)
    ps[0].grad = torch.full((5,), 2.0)
    ps[2].grad = torch.zeros(2, 2)
    before = dict(LAUNCHES)
    opt.step()
    assert LAUNCHES == before
    want = 1.0 - LR * 2.0 / np.sqrt(np.float32(4.1) + np.float32(1e-7))
    np.testing.assert_allclose(ps[0].detach().numpy(), np.full(5, want, np.float32), rtol=1e-6)
    assert torch.equal(opt.accumulator(ps[0]), torch.full((5,), 4.1))
    assert torch.equal(ps[1].detach(), torch.ones(3)) and torch.equal(opt.accumulator(ps[1]), torch.full((3,), 0.1))
    assert torch.equal(ps[2].detach(), torch.ones(2, 2))
    assert ps[0]._version > 0  # in place, as autograd sees it


@pytest.mark.parametrize("bad", ["float64", "shape", "strided", "lists", "device"])
def test_adagrad_update_rejects_what_the_kernel_does_not_take(bad):
    p, a, g = torch.zeros(8), torch.full((8,), 0.1), torch.ones(8)
    if bad == "float64":
        g = g.double()
    elif bad == "shape":
        a = torch.full((2, 4), 0.1)
    elif bad == "strided":
        g = torch.ones(16)[::2]
    elif bad == "device":
        g = g.to("meta")
    with pytest.raises((TypeError, ValueError)):
        if bad == "lists":
            kada.adagrad_update([p, p], [a], [g], LR)
        else:
            kada.adagrad_update([p], [a], [g], LR)
    assert torch.equal(p, torch.zeros(8))


def _check_plan(lengths, plan):
    live = [i for i, n in enumerate(lengths) if n > 0]
    assert [i for idx, _ in plan for i in idx] == live
    for idx, start in plan:
        assert 1 <= len(idx) <= kada.MAX_SEGMENTS and len(start) == len(idx) + 1 and start[0] == 0
        assert [b - a for a, b in zip(start, start[1:])] == [-(-lengths[i] // kada.UNIT) for i in idx]


@pytest.mark.parametrize(
    "lengths, groups",
    [
        ([16], 1),  # one tensor
        ([5] * 65, 2),  # one past a launch's tensors
        ([3] * 130, 3),
        ([0, 1, 3, 5, 0, 4], 1),  # empty tensors take no unit
        ([0, 0], 0),  # nothing to launch
        ([22_343_004 * 16, 2**31 + 3, 2**33 + 1, 7], 1),  # past 2^31 floats in all and in one tensor
    ],
    ids=["one", "65", "130", "small", "empty", "past_2_31"],
)
def test_adagrad_plan(lengths, groups):
    plan = kada.adagrad_plan(lengths)
    assert len(plan) == groups
    _check_plan(lengths, plan)
    if groups:
        assert sum(start[-1] for _, start in plan) == sum(-(-n // 4) for n in lengths)


def test_adagrad_plan_values():
    """The prefix of 4-float units: lengths 1, 3, 5 and 8 take 1, 1, 2 and 2;
    the past-2^31 total is exact."""
    assert kada.adagrad_plan([0, 1, 3, 5, 8]) == [([1, 2, 3, 4], [0, 1, 2, 4, 6])]
    (idx, start), = kada.adagrad_plan([2**31 + 3, 2**32])
    assert idx == [0, 1] and start == [0, 2**29 + 1, 2**29 + 1 + 2**30]
    with pytest.raises(ValueError):
        kada.adagrad_plan([4, -1])


def test_adagrad_constants_match_the_source():
    """MAX_SEGMENTS, UNIT and EPS, which the plan and the plain version
    repeat, are csrc/adagrad.cu's kMaxSegments (the C entry refuses more
    tensors), its float4 unit and kEps."""
    import re
    from pathlib import Path

    src = (Path(kada.__file__).parent.parent / "csrc" / "adagrad.cu").read_text()
    assert int(re.search(r"constexpr int kMaxSegments = (\d+);", src).group(1)) == kada.MAX_SEGMENTS
    assert re.search(r"\(len \+ 3\) / 4", src) and kada.UNIT == 4
    assert float(re.search(r"constexpr float kEps = ([\d.e-]+)f;", src).group(1)) == kada.EPS


def test_adagrad_plan_random_lengths():
    rng = np.random.default_rng(13)
    for _ in range(20):
        lengths = [int(x) for x in rng.integers(0, 12, rng.integers(1, 200))]
        _check_plan(lengths, kada.adagrad_plan(lengths))


def test_adagrad_steps_of_a_dlrm_match_optax_through_the_update():
    """Three Adagrad steps of a small DLRM's parameters through
    Adagrad.step (the plain version of K18 on the CPU), for gradients made
    with numpy, against optax's on the same parameters: within TOL."""
    config = pmodels.DLRMConfig({"a": 11, "b": 7, "c": 30}, num_dense=3, embedding_dim=4, bottom_mlp=(8, 4),
                                top_mlp=(8, 1))
    model = pmodels.DLRM(config, seed=0, device="cpu")
    params = [p.detach().numpy().copy() for p in model.parameters()]
    rng = np.random.default_rng(14)
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params] for _ in range(3)]
    for g in grads:
        g[0][rng.random(params[0].shape[0]) < 0.8] = 0.0  # the table's untouched rows
    opt = pmodels.Adagrad(model.parameters(), lr=LR)
    for g in grads:
        for p, x in zip(model.parameters(), g):
            p.grad = torch.from_numpy(x)
        opt.step()
    want_p, want_a = _optax_steps(params, None, grads)
    for p, wp, wa in zip(model.parameters(), want_p, want_a):
        np.testing.assert_allclose(p.detach().numpy(), wp, **TOL)
        np.testing.assert_allclose(opt.accumulator(p).numpy(), wa, **TOL)
