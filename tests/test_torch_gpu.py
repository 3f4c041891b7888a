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
from nvtabular_tpu_torch import kernels, models, ops
from nvtabular_tpu_torch.kernels import cont_chain as kcc
from nvtabular_tpu_torch.kernels import embedding as kemb
from nvtabular_tpu_torch.kernels import interaction as kint
from nvtabular_tpu_torch.kernels import permute as kperm
from nvtabular_tpu_torch.loader import DeviceLoader
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
    on_path = {"tiny_lookup", "direct_lookup", "cuckoo_lookup", "cont_chain"}
    assert kernels.LAUNCHES == {k: int(k in on_path) for k in kernels.LAUNCHES}
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


@pytest.mark.parametrize("perm_dtype", [torch.int64, torch.int32])
def test_permute_rows_kernel_matches_plain(perm_dtype):
    """Bit-identical: a permutation moves bits."""
    _require_cuda()
    g = torch.Generator().manual_seed(0)
    n = 100_003
    arrays = {
        "c": torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, generator=g),
        "dense": torch.randn((n, 13), generator=g),
        "label": torch.randint(0, 2, (n,), generator=g).float(),
        "wide": torch.randint(-(2**62), 2**62, (n,), generator=g),
    }
    perm = torch.randperm(n, generator=g).to(perm_dtype)
    want = kperm.permute_rows(arrays, perm)
    kernels.reset_launches()
    got = kperm.permute_rows({k: v.cuda() for k, v in arrays.items()}, perm.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["permute_rows"] == 1
    for k in arrays:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_permute_rows_kernel_never_reads_out_of_bounds():
    _require_cuda()
    x = torch.arange(10, dtype=torch.int32, device="cuda")
    perm = torch.tensor([9, -1, 10, 2**40, 0, 1, 2, 3, 4, 5], device="cuda")
    got = kperm.permute_rows({"x": x}, perm)["x"].cpu()
    assert got.tolist() == [9, 0, 0, 0, 0, 1, 2, 3, 4, 5]


def _columns(g, B, sizes, out_of_range):
    ids = []
    for c, v in enumerate(sizes):
        i = (torch.rand(B, generator=g) ** 2.5 * v).to(torch.int32)
        if out_of_range and c % 3 == 1:
            i[:6] = torch.tensor([v, v + 5, -1, -v, -v - 1, 2**31 - 1], dtype=torch.int32)
        ids.append(i)
    return ids


@pytest.mark.parametrize("D", [16, 6])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_embedding_kernels_match_plain(D, out_of_range):
    """Gather: bit-identical (NaN rows included), written into slots 1..C of
    a [B, 1 + C, D] buffer. Scatter-add gradient: the atomics sum each row's
    contributions in a varying order, so an element may differ by a few
    float32 ULPs of the sum of its terms' magnitudes (1e-5 of it allowed);
    an element whose terms cancel can differ far more relative to itself."""
    _require_cuda()
    g = torch.Generator().manual_seed(1)
    sizes = [3, 40, 1000, 7, 60_000, 5, 200, 12_345] * 3 + [4, 90]
    B = 4099
    offsets = [0]
    for v in sizes[:-1]:
        offsets.append(offsets[-1] + v)
    table = torch.randn((sum(sizes), D), generator=g)
    ids = _columns(g, B, sizes, out_of_range)
    want = kemb.embedding_gather(table, ids, offsets, sizes)
    dev_ids = [i.cuda() for i in ids]
    feats = torch.zeros((B, 1 + len(sizes), D), device="cuda")
    kernels.reset_launches()
    kemb.embedding_gather(table.cuda(), dev_ids, offsets, sizes, out=feats[:, 1:])
    grad = torch.randn((B, len(sizes), D), generator=g)
    want_grad = kemb.embedding_scatter_grad(grad, ids, offsets, sizes, table.shape[0])
    gbuf = torch.zeros((B, 1 + len(sizes), D), device="cuda")
    gbuf[:, 1:] = grad.cuda()
    got_grad = kemb.embedding_scatter_grad(gbuf[:, 1:], dev_ids, offsets, sizes, table.shape[0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_gather"] == 1 and kernels.LAUNCHES["embedding_scatter_grad"] == 1
    got = feats[:, 1:].cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(feats[:, 0].cpu(), torch.zeros(B, D))
    magnitude = kemb.embedding_scatter_grad(grad.abs(), ids, offsets, sizes, table.shape[0])
    assert bool(((got_grad.cpu() - want_grad).abs() <= 1e-5 * magnitude + 1e-6).all())


@pytest.mark.parametrize("F,D", [(27, 16), (5, 8), (2, 3)])
def test_interaction_kernels_match_plain(F, D):
    """rtol 1e-5, atol 1e-5: float32 sums of D (forward) or F - 1 (backward)
    products in another order than cuBLAS's and autograd's."""
    _require_cuda()
    g = torch.Generator().manual_seed(2)
    B = 1001  # not a multiple of the samples per block
    P = F * (F - 1) // 2
    x = torch.randn((B, F, D), generator=g)
    grad = torch.randn((B, P), generator=g)
    want = kint.interaction_fwd(x)
    want_dx = kint.interaction_bwd(x, grad)
    xc = x.cuda()
    buf = torch.zeros((B, D + P), device="cuda")
    kernels.reset_launches()
    kint.interaction_fwd(xc, out=buf[:, D:])
    gbuf = torch.zeros((B, D + P), device="cuda")
    gbuf[:, D:] = grad.cuda()
    got_dx = kint.interaction_bwd(xc, gbuf[:, D:])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["interaction_fwd"] == 1 and kernels.LAUNCHES["interaction_bwd"] == 1
    torch.testing.assert_close(buf[:, D:].cpu(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(buf[:, :D].cpu(), torch.zeros(B, D))
    torch.testing.assert_close(got_dx.cpu(), want_dx, rtol=1e-5, atol=1e-5)


def test_dlrm_step_through_kernels_matches_plain_reference():
    """One DLRM loss and gradient through the kernels against
    models.reference_forward (the plain versions, autograd through
    PyTorch) on the card, in float32 compute: only summation orders differ
    (rtol 1e-4 on the loss and the logits; gradients within 1e-4 of their
    largest entry)."""
    _require_cuda()
    config = models.DLRMConfig({"a": 3, "b": 500, "c": 40_000}, num_dense=13, embedding_dim=16)
    model = models.DLRM(config, seed=1, compute_dtype=torch.float32)
    batch = {k: torch.from_numpy(v).cuda() for k, v in models.make_synthetic_batch(config, 4096, seed=2).items()}
    kernels.reset_launches()
    logits = model(batch)
    loss = models.bce_with_logits(logits, batch["label"])
    loss.backward()
    torch.cuda.synchronize()
    for name in ("embedding_gather", "embedding_scatter_grad", "interaction_fwd", "interaction_bwd"):
        assert kernels.LAUNCHES[name] == 1, name
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    ref_logits = models.reference_forward(model, batch)
    ref_loss = models.bce_with_logits(ref_logits, batch["label"])
    ref_loss.backward()
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=1e-6)
    for got, p in zip(grads, model.parameters()):
        assert float((got - p.grad).abs().max()) <= 1e-4 * float(p.grad.abs().max())


def test_device_loader_on_cuda_permutes_each_chunk_once():
    _require_cuda()
    parts = [
        {"rid": np.arange(p * 5000, (p + 1) * 5000, dtype=np.int32),
         "x": np.arange(p * 5000, (p + 1) * 5000, dtype=np.float32)}
        for p in range(3)
    ]
    loader = DeviceLoader(nvt.Dataset(parts), 2048, cat_names=["rid"], cont_names=["x"], label_names=[])
    kernels.reset_launches()
    rows = torch.cat([b["rid"] for b in loader])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["permute_rows"] == 3
    assert rows.device.type == "cuda" and rows.numel() == 15_000 // 2048 * 2048
    assert torch.unique(rows).numel() == rows.numel()
