"""nvtabular_tpu_torch's CUDA kernels against their plain PyTorch versions.

Every test needs a CUDA device and skips inside the test without one (the
kernels have no CPU mode). On a GPU machine, which has no JAX, run them
without the suite's conftest (it imports JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import nvtabular_tpu_torch as nvt
from nvtabular_tpu_torch import kernels, ops
from nvtabular_tpu_torch.kernels import cont_chain as kcc
from nvtabular_tpu_torch.ops import lookup as plookup

I32_MAX, I32_MIN = 2**31 - 1, -(2**31)
EXTREMES = np.array([I32_MAX, I32_MIN, I32_MIN + 1, -I32_MAX, 0, -1], dtype=np.int32)

pytestmark = pytest.mark.gpu


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _queries(rng, keysets, n):
    rows = []
    for keys in keysets:
        miss = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64)
        v = np.where(rng.random(n) < 0.2, miss, rng.choice(keys, n)).astype(np.int32)
        v[: len(EXTREMES)] = EXTREMES
        rows.append(v)
    return torch.from_numpy(np.stack(rows))


def _tables(rng):
    tiny_keys = [
        rng.permutation(np.arange(-3000, 3000, 3)).astype(np.int32),
        np.array([I32_MAX, I32_MIN], np.int32),
        rng.permutation(np.arange(50)).astype(np.int32),
    ]
    tiny = plookup.BatchedTiny([plookup.TinyLookup(k, np.arange(len(k)) + 3) for k in tiny_keys])
    direct_keys = [np.arange(I32_MAX - 9999, I32_MAX + 1), np.arange(I32_MIN, I32_MIN + 7000, 2)]
    direct = plookup.BatchedDirect([plookup.build_direct(k, np.arange(len(k)) + 3) for k in direct_keys])
    wide = [
        rng.permutation(np.unique(rng.integers(I32_MIN, I32_MAX, 50_000))).astype(np.int32),
        rng.permutation(np.unique(rng.integers(-9000, 9000, 6000))).astype(np.int32),
    ]
    cuckoo = plookup.BatchedCuckoo([plookup.build_cuckoo(k, np.arange(len(k)) + 3) for k in wide])
    return [(tiny, tiny_keys), (direct, direct_keys), (cuckoo, wide)]


@pytest.mark.parametrize("with_validity", [False, True])
def test_lookup_kernels_match_plain(with_validity):
    _require_cuda()
    rng = np.random.default_rng(6)
    for blut, keysets in _tables(rng):
        sel = list(range(len(keysets))) + [0]
        values = _queries(rng, [keysets[s] for s in sel], 100_003)
        validity = torch.from_numpy(rng.random(values.shape) > 0.1) if with_validity else None
        sel_t = torch.tensor(sel, dtype=torch.int32)
        offs = torch.tensor([7 * i for i in range(len(sel))], dtype=torch.int32)
        want = blut.encode(values, validity, sel_t, offs)
        dev = blut.to("cuda")
        got = dev.encode(
            values.cuda(), None if validity is None else validity.cuda(), sel_t.cuda(), offs.cuda()
        )
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), type(blut).__name__


@pytest.mark.parametrize("with_validity", [False, True])
def test_cont_chain_kernel_matches_plain(with_validity):
    """rtol=1e-5, atol=1e-6: the kernel's log1pf and PyTorch's CPU log1p
    may differ by a few float32 ULPs."""
    _require_cuda()
    rng = np.random.default_rng(7)
    x = rng.normal(1.0, 3.0, (13, 100_003)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    validity = torch.from_numpy(rng.random(x.shape) > 0.1) if with_validity else None
    params = torch.tensor([[0.25, 0.0, 8.0, 0.3, 1.7]] * 12 + [[0.0, 0.0, 0.0, 0.5, 1.0]], dtype=torch.float32)
    flags = torch.full((13,), kcc.FILL | kcc.LO | kcc.HI | kcc.LOG | kcc.NORM, dtype=torch.int32)
    want = kcc.cont_chain(torch.from_numpy(x), validity, params, flags)
    got = kcc.cont_chain(
        torch.from_numpy(x).cuda(), None if validity is None else validity.cuda(), params.cuda(), flags.cuda()
    )
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def test_workflow_on_cuda_matches_cpu_and_counts_launches():
    _require_cuda()
    rng = np.random.default_rng(8)

    def part(seed):
        r = np.random.default_rng(seed)
        x = r.normal(1.0, 3.0, (2, 30_000)).astype(np.float32)
        x[r.random(x.shape) < 0.05] = np.nan
        return {
            "tiny": r.integers(0, 300, 30_000).astype(np.int32),
            "direct": r.integers(0, 20_000, 30_000).astype(np.int32),
            "wide": ((r.integers(0, 20_000, 30_000) * 2654435761) % 2**31).astype(np.int32),
            "tiny2": r.integers(-40, 40, 30_000).astype(np.int32),
            "x0": x[0],
            "x1": x[1],
        }

    def graph():
        cats = ["tiny", "direct", "wide", "tiny2"] >> ops.Categorify()
        conts = ["x0", "x1"] >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.Normalize()
        return cats + conts

    parts = [part(s) for s in range(3)]
    gpu = nvt.Workflow(graph())
    gpu.fit(nvt.Dataset(parts))
    cpu = nvt.Workflow(graph(), device="cpu")
    nvt.load_fitted_state(cpu, nvt.fitted_state(gpu))
    batch = nvt.TableBatch.from_pydict(part(9))
    kernels.reset_launches()
    got = gpu.transform(batch)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"tiny_lookup": 1, "direct_lookup": 1, "cuckoo_lookup": 1, "cont_chain": 1}
    want = cpu.transform(batch)
    for name in want.column_names:
        g, w = got[name].values.cpu(), want[name].values
        if name.startswith("x"):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(g, w), name


def test_wrappers_reject_wrong_inputs():
    _require_cuda()
    keys = torch.zeros((1, 4), dtype=torch.int32, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    sel = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        kernels.lookup.tiny_lookup(
            torch.zeros((1, 8), dtype=torch.int64, device="cuda"), None, keys, keys, lens, sel, sel
        )
    with pytest.raises(ValueError):
        kernels.lookup.tiny_lookup(
            torch.zeros((1, 8), dtype=torch.int32, device="cuda"), None, keys, keys, lens, sel.cpu(), sel
        )
