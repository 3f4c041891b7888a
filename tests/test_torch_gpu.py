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
from nvtabular_tpu_torch.kernels import bucketize as kbkt
from nvtabular_tpu_torch.kernels import cin as kcin
from nvtabular_tpu_torch.kernels import cont_chain as kcc
from nvtabular_tpu_torch.kernels import cross as kcross
from nvtabular_tpu_torch.kernels import difference_lag as kdl
from nvtabular_tpu_torch.kernels import embedding as kemb
from nvtabular_tpu_torch.kernels import embedding_bag as kbag
from nvtabular_tpu_torch.kernels import exchange as kex
from nvtabular_tpu_torch.kernels import fm as kfm
from nvtabular_tpu_torch.kernels import groupby as kgb
from nvtabular_tpu_torch.kernels import hash as khash
from nvtabular_tpu_torch.kernels import hash_pair as khp
from nvtabular_tpu_torch.kernels import interaction as kint
from nvtabular_tpu_torch.kernels import moments as kmom
from nvtabular_tpu_torch.kernels import permute as kperm
from nvtabular_tpu_torch.kernels import ragged as kragged
from nvtabular_tpu_torch.loader import DeviceLoader
from nvtabular_tpu_torch.ops import lookup as plookup
from nvtabular_tpu_torch.ops.lookup import kind_of

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


@pytest.mark.parametrize("codes", [(2, 1), (123_457, 123_457)], ids=["categorify", "group_index"])
@pytest.mark.parametrize("with_validity", [False, True])
def test_lookup_kernels_match_plain(with_validity, codes):
    """Categorify's miss and null codes, and a group index's (num_groups
    for both, no column offsets)."""
    _require_cuda()
    rng = np.random.default_rng(6)
    miss, null = codes
    for blut, keysets in _tables(rng):
        sel = list(range(len(keysets))) + [0]
        values = _queries(rng, [keysets[s] for s in sel], 100_003)
        validity = torch.from_numpy(rng.random(values.shape) > 0.1) if with_validity else None
        sel_t = torch.tensor(sel, dtype=torch.int32)
        offs = torch.tensor([7 * i if miss == 2 else 0 for i in range(len(sel))], dtype=torch.int32)
        want = blut.encode(values, validity, sel_t, offs, miss, null)
        dev = blut.to("cuda")
        got = dev.encode(
            values.cuda(), None if validity is None else validity.cuda(), sel_t.cuda(), offs.cuda(), miss, null
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


def _hash_columns(n, seed):
    r = np.random.default_rng(seed)
    f = r.normal(0.0, 1e4, n).astype(np.float32)
    f[:5] = [np.nan, np.inf, -0.0, 0.0, -np.inf]
    return {
        "int32": r.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32),
        "int64_in": r.integers(I32_MIN, I32_MAX, n, dtype=np.int64),
        "int64_wide": r.integers(-(2**62), 2**62, n, dtype=np.int64),
        "float32": f,
        "bool": r.random(n) < 0.5,
    }


@pytest.mark.parametrize("num_buckets", [10_000, 2**32 - 1, None])
def test_hashed_cross_kernel_matches_plain(num_buckets):
    """Bit-identical: integer arithmetic only; every column kind in one
    launch, and each alone."""
    _require_cuda()
    cols = {k: torch.from_numpy(v) for k, v in _hash_columns(100_003, 9).items()}
    for group in (list(cols.values()), *[[c] for c in cols.values()]):
        want = khash.hashed_cross(group, num_buckets, seed=7)
        kernels.reset_launches()
        got = khash.hashed_cross([c.cuda() for c in group], num_buckets, seed=7)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["hashed_cross"] == 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("row_offset", [0, 2**32 - 50_000, 3 * 2**40 + 17])
@pytest.mark.parametrize("kfold", [3, 5])
def test_fold_ids_kernel_matches_plain(row_offset, kfold):
    """Across the 2**32 boundary of the row index (the reference's 32-bit
    carry)."""
    _require_cuda()
    want = khash.fold_ids(row_offset, 100_003, kfold, 42, "cpu")
    got = khash.fold_ids(row_offset, 100_003, kfold, 42, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_new_kernels_take_empty_inputs_and_the_current_stream():
    _require_cuda()
    kernels.reset_launches()
    empty_i, empty_f = torch.zeros(0, dtype=torch.int32, device="cuda"), torch.zeros(0, device="cuda")
    assert khash.hashed_cross([empty_i, empty_f], 10).shape == (0,)
    assert khash.fold_ids(5, 0, 3, 42, "cuda").shape == (0,)
    assert kbkt.bucketize(empty_f, torch.tensor([1.0], device="cuda")).shape == (0,)
    assert sum(kernels.LAUNCHES.values()) == 0  # nothing to launch
    x = torch.randn(300_001, device="cuda") * 10
    bounds = torch.tensor([-5.0, 0.0, 5.0], device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = kbkt.bucketize(x, bounds)
        codes = khash.hashed_cross([x], 97)
    side.synchronize()
    assert torch.equal(got.cpu(), kbkt.bucketize(x.cpu(), bounds.cpu()))
    assert torch.equal(codes.cpu(), khash.hashed_cross([x.cpu()], 97))


def _te_state(rng, sizes, T, kfold):
    """Random flat TE stats for groups of ``sizes`` groups each."""
    sums, counts, fs, fc, stat_off, fold_off = [], [], [], [], [], []
    at = fat = 0
    for ng in sizes:
        for _ in range(T):
            c = rng.integers(0, 50, ng + 1).astype(np.float32)
            c[-1] = 0
            sums.append((c * rng.random(ng + 1) * 5).astype(np.float32))
            counts.append(c)
            stat_off.append(at)
            at += ng + 1
            part = np.floor(c[None, :] * rng.random((kfold, ng + 1)) / kfold).astype(np.float32)
            fs.append((part * 2.5).reshape(-1))
            fc.append(part.reshape(-1))
            fold_off.append(fat)
            fat += kfold * (ng + 1)
    return kgb.TEState(
        sums=torch.from_numpy(np.concatenate(sums)), counts=torch.from_numpy(np.concatenate(counts)),
        stat_off=torch.tensor(stat_off), fsums=torch.from_numpy(np.concatenate(fs)),
        fcnts=torch.from_numpy(np.concatenate(fc)), fold_off=torch.tensor(fold_off),
        strides=torch.tensor([ng + 1 for ng in sizes]),
        means=torch.from_numpy(rng.random(T).astype(np.float32) * 4), p_smooth=0.0, kfold=kfold, fold_seed=42,
    )


@pytest.mark.parametrize("kfold", [3, 1])
@pytest.mark.parametrize("p_smooth", [20.0, 0.0])
def test_te_encode_kernel_matches_plain(kfold, p_smooth):
    """Bit-identical: each product and sum rounds on its own on both sides
    (no FMA in the kernel), and the division is IEEE on both."""
    _require_cuda()
    rng = np.random.default_rng(10)
    sizes, T, n = [161_999, 300, 0], 2, 100_003
    st = _te_state(rng, sizes, T, kfold)
    st.p_smooth = p_smooth
    gidx = torch.from_numpy(np.stack([rng.integers(0, ng + 1, n) for ng in sizes]).astype(np.int32))
    want = kgb.te_encode(gidx, st, 2**32 - 7)
    kernels.reset_launches()
    got = kgb.te_encode(gidx.cuda(), st.to("cuda"), 2**32 - 7)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["te_encode"] == 1
    assert torch.equal(got.cpu(), want)


def test_stat_gather_kernel_matches_plain():
    _require_cuda()
    rng = np.random.default_rng(11)
    n, sizes = 100_003, [62_000, 40]
    gidx = torch.from_numpy(np.stack([rng.integers(0, ng + 1, n) for ng in sizes]).astype(np.int32))
    ints = [rng.integers(0, 2**31 - 1, ng + 1).astype(np.int32) for ng in sizes]
    floats = [rng.normal(0, 1, ng + 1).astype(np.float32) for ng in sizes for _ in range(2)]
    floats[0][-1] = np.nan
    st = kgb.GatherState(
        itable=torch.from_numpy(np.concatenate(ints)), ftable=torch.from_numpy(np.concatenate(floats)),
        groups=torch.tensor([0, 1, 0, 0, 1, 1], dtype=torch.int32),
        offs=torch.tensor([0, sizes[0] + 1, 0, sizes[0] + 1, 2 * sizes[0] + 2, 2 * sizes[0] + sizes[1] + 3]),
        ki=2,
    )
    want = kgb.stat_gather(gidx, st)
    kernels.reset_launches()
    got = kgb.stat_gather(gidx.cuda(), st.to("cuda"))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stat_gather"] == 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu().view(torch.int32), want[1].view(torch.int32))  # NaN pad slots too


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32, torch.int64])
def test_bucketize_kernel_matches_plain(dtype):
    """Values on the bounds, NaN and infinities included."""
    _require_cuda()
    g = torch.Generator().manual_seed(12)
    x = (torch.rand(200_003, generator=g, dtype=torch.float64) * 1.2e6 - 1e5)
    bounds = torch.tensor([60.0, 3600.0, 43200.0, 86400.0, 604800.0], dtype=torch.float64)
    x[:5] = bounds
    if dtype.is_floating_point:
        x[5:8] = torch.tensor([float("nan"), float("inf"), -float("inf")], dtype=torch.float64)
    x, bounds = x.to(dtype), bounds.to(dtype)
    want = kbkt.bucketize(x, bounds)
    kernels.reset_launches()
    got = kbkt.bucketize(x.cuda(), bounds.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bucketize"] == 1
    assert torch.equal(got.cpu(), want)
    assert set(got.unique().tolist()) == set(range(6))


def _movielens_part(seed, n=40_000):
    r = np.random.default_rng(seed)
    users = r.zipf(1.2, n).clip(1, 20_000).astype(np.int64)
    return {
        "userId": users,
        "movieId": r.zipf(1.1, n).clip(1, 300).astype(np.int64),
        "rating": (r.integers(1, 11, n) / 2.0).astype(np.float32),
        "ts_delta": r.exponential(86400.0, n).astype(np.float32),
    }


def _movielens_graph():
    te = ["userId", "movieId"] >> ops.TargetEncoding("rating", kfold=3, p_smooth=20)
    jg = ["movieId"] >> ops.JoinGroupby(cont_cols=["ts_delta"], stats=["mean", "count", "std"])
    lam = ["ts_delta"] >> ops.LambdaOp(np.log1p) >> ops.Bucketize([1.0, 8.0, 11.0, 12.0])
    cross = ["userId", "movieId"] >> ops.HashedCross(10_000)
    return te + jg + lam + cross + ["rating"]


def test_movielens_workflow_on_cuda_matches_cpu_and_counts_launches():
    """The advanced MovieLens workflow fitted on the card, carried to the CPU
    by convert: codes, counts and buckets exact, floats within rtol=1e-6."""
    _require_cuda()
    parts = [_movielens_part(s) for s in range(3)]
    gpu = nvt.Workflow(_movielens_graph())
    gpu.fit(nvt.Dataset(parts))
    cpu = nvt.Workflow(_movielens_graph(), device="cpu")
    nvt.load_fitted_state(cpu, nvt.fitted_state(gpu))
    batch = nvt.TableBatch.from_pydict(_movielens_part(9))
    batch.row_offset = 2**32 - 1000
    kernels.reset_launches()
    got = gpu.transform(batch)
    torch.cuda.synchronize()
    # userId's keys take a direct map, movieId's (<= 512) a tiny table: TE
    # indexes both groups, JoinGroupby movieId again
    want = {"direct_lookup": 1, "tiny_lookup": 2, "te_encode": 1, "stat_gather": 1, "hashed_cross": 1, "bucketize": 1}
    assert kernels.LAUNCHES == {k: want.get(k, 0) for k in kernels.LAUNCHES}
    assert gpu.executor.host_handoffs == 1
    ref = cpu.transform(batch)
    assert got.column_names == ref.column_names
    for name in ref.column_names:
        g, w = got[name].values.cpu(), ref[name].values
        if w.is_floating_point():
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7, equal_nan=True)
        else:
            assert torch.equal(g, w), name


def _ragged(seed, rows=100_003, max_len=9, dtype=torch.int32):
    """Rows of 0..max_len values: the first row empty, the last one ending
    the values."""
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(0, max_len + 1, (rows,), generator=g)
    lengths[0], lengths[-1] = 0, max_len
    offsets = torch.zeros(rows + 1, dtype=torch.int64)
    offsets[1:] = torch.cumsum(lengths, 0)
    values = torch.randint(-(2**31), 2**31 - 1, (int(offsets[-1]),), generator=g)
    return values.to(dtype) if dtype != torch.float32 else torch.randn(values.shape, generator=g), offsets


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32])
@pytest.mark.parametrize("L", [4, 12], ids=["cut", "longer_than_every_row"])
def test_ragged_to_padded_kernel_matches_plain(L, dtype):
    """Bit-identical padded values and mask; rows longer than L are cut."""
    _require_cuda()
    values, offsets = _ragged(3, dtype=dtype)
    want, want_mask = kragged.ragged_to_padded_plain(values, offsets, L, -5)
    kernels.reset_launches()
    got, mask = kragged.ragged_to_padded(values.cuda(), offsets.cuda(), L, -5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ragged_to_padded"] == 1
    assert got.dtype == dtype and mask.dtype == torch.float32
    assert torch.equal(got.cpu(), want) and torch.equal(mask.cpu(), want_mask)


@pytest.mark.parametrize("start,end,pad_len", [(0, 3, 3), (1, 4, 3), (-2, 0, 2), (-3, -1, 2), (-3, 2, 5), (2, 7, 5)])
def test_ragged_slice_padded_kernel_matches_plain(start, end, pad_len):
    _require_cuda()
    values, offsets = _ragged(4)
    want, want_len = kragged.ragged_slice_padded_plain(values, offsets, start, end, pad_len, 7)
    kernels.reset_launches()
    got, new_len = kragged.ragged_slice_padded(values.cuda(), offsets.cuda(), start, end, pad_len, 7)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ragged_slice_padded"] == 1
    assert torch.equal(got.cpu(), want) and torch.equal(new_len.cpu(), want_len)


def _bag(g, B, L, V, D):
    """Padded ids under a mask, an all-masked row, negative ids in real
    slots, out-of-range ids in a real and a masked slot."""
    values = torch.randint(0, V, (B, L), generator=g, dtype=torch.int32)
    mask = (torch.arange(L)[None, :] < torch.randint(0, L + 1, (B, 1), generator=g)).float()
    mask[0] = 0.0
    mask[1:4] = 1.0
    values[1, :2] = torch.tensor([-1, -V], dtype=torch.int32)
    values[2, 1] = V
    mask[4, :] = torch.tensor([1.0] + [0.0] * (L - 1))
    values[4, L - 1] = -V - 1
    return torch.randn((V, D), generator=g), values, mask, torch.randn((B, D), generator=g)


@pytest.mark.parametrize("combiner", ["mean", "sum"])
@pytest.mark.parametrize("V,D", [(23, 16), (5000, 16), (23, 6)], ids=["shared_contended", "global", "scalar"])
def test_embedding_bag_kernels_match_plain(V, D, combiner):
    """The forward bit for bit (NaN rows included), written into a slot of a
    wider buffer; the backward within 1e-5 of the sum of its terms'
    magnitudes (atomics sum in a varying order). 23 rows of 16 take the
    shared-memory backward under full contention (65,536 x 4 ids on 23
    rows), 5,000 rows the global atomics."""
    _require_cuda()
    g = torch.Generator().manual_seed(5)
    B, L = 65_536, 4
    table, values, mask, grad = _bag(g, B, L, V, D)
    dt, dv, dm = table.cuda(), values.cuda(), mask.cuda()
    want = kbag.embedding_bag_fwd_plain(dt, dv, dm, combiner)
    buf = torch.zeros((B, D + 8), device="cuda")
    gbuf = torch.zeros((B, D + 8), device="cuda")
    gbuf[:, 4 : 4 + D] = grad.cuda()
    kernels.reset_launches()
    kbag.embedding_bag_fwd(dt, dv, dm, combiner, out=buf[:, 4 : 4 + D])
    got_grad = kbag.embedding_bag_bwd(gbuf[:, 4 : 4 + D], dv, dm, V, combiner)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_bag_fwd"] == 1 and kernels.LAUNCHES["embedding_bag_bwd"] == 1
    got = buf[:, 4 : 4 + D]
    assert torch.equal(got.isnan(), want.isnan()) and bool(got[:, 0].isnan()[[2, 4]].all())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.equal(buf[:, :4], torch.zeros(B, 4, device="cuda"))
    want_grad = kbag.range_bag_grad_plain(grad.cuda(), dv, dm, 0, V, V, combiner)
    magnitude = kbag.range_bag_grad_plain(grad.cuda().abs(), dv, dm, 0, V, V, combiner)
    assert bool(((got_grad - want_grad).abs() <= 1e-5 * magnitude + 1e-6).all())


def test_ragged_and_bag_kernels_take_empty_inputs_and_the_current_stream():
    _require_cuda()
    kernels.reset_launches()
    empty_i = torch.zeros(0, dtype=torch.int32, device="cuda")
    one = torch.zeros(1, dtype=torch.int64, device="cuda")
    padded, mask = kragged.ragged_to_padded(empty_i, one, 4)
    assert padded.shape == (0, 4) and mask.shape == (0, 4)
    assert kragged.ragged_slice_padded(empty_i, one, 0, 3, 3)[0].shape == (0, 3)
    table = torch.randn((23, 16), device="cuda")
    ids, m = torch.zeros((0, 4), dtype=torch.int32, device="cuda"), torch.zeros((0, 4), device="cuda")
    assert kbag.embedding_bag_fwd(table, ids, m).shape == (0, 16)
    assert torch.equal(kbag.embedding_bag_bwd(torch.zeros((0, 16), device="cuda"), ids, m, 23),
                       torch.zeros((23, 16), device="cuda"))
    assert sum(kernels.LAUNCHES.values()) == 0  # nothing to launch
    empty_rows = torch.zeros(5, dtype=torch.int64, device="cuda")  # four empty rows over no values
    padded, mask = kragged.ragged_to_padded(empty_i, empty_rows, 4, 9)
    assert torch.equal(padded.cpu(), torch.full((4, 4), 9, dtype=torch.int32)) and not bool(mask.any())
    values, offsets = _ragged(6)
    g = torch.Generator().manual_seed(6)
    _, bv, bm, _ = _bag(g, 50_000, 4, 23, 16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got, _ = kragged.ragged_to_padded(values.cuda(), offsets.cuda(), 4)
        bag = kbag.embedding_bag_fwd(table, bv.cuda(), bm.cuda())
    side.synchronize()
    assert torch.equal(got.cpu(), kragged.ragged_to_padded_plain(values, offsets, 4)[0])
    want = kbag.embedding_bag_fwd_plain(table.cpu(), bv, bm)
    assert torch.equal(torch.nan_to_num(bag.cpu()), torch.nan_to_num(want))


def _multihot_part(seed, n=40_000):
    r = np.random.default_rng(seed)
    lengths = r.integers(1, 5, n)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    return {
        "userId": nvt.Column(r.zipf(1.2, n).clip(1, 20_000).astype(np.int64)),
        "movieId": nvt.Column(r.zipf(1.1, n).clip(1, 3_000).astype(np.int64)),
        "genres": nvt.Column(r.integers(1, 21, int(offsets[-1])), offsets),
        "rating": nvt.Column((r.integers(1, 11, n) / 2.0).astype(np.float32)),
        "ts_delta": nvt.Column(r.exponential(86400.0, n).astype(np.float32)),
    }


def _multihot_graph():
    cats = ["userId", "movieId", "genres"] >> ops.Categorify()
    conts = ["ts_delta"] >> ops.LogOp() >> ops.Normalize()
    label = ["rating"] >> ops.LambdaOp(lambda col: (np.asarray(col) > 3).astype(np.float32))
    return cats + conts + label


def test_multihot_path_on_cuda_matches_cpu_and_counts_launches():
    """The MovieLens multihot path at a small size: the config-1 workflow
    fitted on the card and carried to the CPU (codes, offsets and labels
    exact, ts_delta within log1p ULPs), the loader's padding, one tabular
    MLP step through the kernels against the plain versions in float32, and
    ListSlice(0, 3, pad=True) through K11's slice."""
    _require_cuda()
    tables = [nvt.TableBatch(_multihot_part(s)) for s in range(3)]
    gpu = nvt.Workflow(_multihot_graph())
    gpu.fit(nvt.Dataset(tables))
    cpu = nvt.Workflow(_multihot_graph(), device="cpu")
    nvt.load_fitted_state(cpu, nvt.fitted_state(gpu))
    probe = nvt.TableBatch(_multihot_part(9))
    kernels.reset_launches()
    got = gpu.transform(probe)
    torch.cuda.synchronize()
    # userId takes a direct map; movieId (<= 4096 keys) and genres (20) tiny
    # tables, the scalar column and the list's flat values in a launch each
    want_launches = {"direct_lookup": 1, "tiny_lookup": 2, "cont_chain": 1}
    assert kernels.LAUNCHES == {k: want_launches.get(k, 0) for k in kernels.LAUNCHES}
    assert gpu.executor.host_handoffs == 1
    want = cpu.transform(probe)
    assert got.column_names == want.column_names == ["userId", "movieId", "genres", "ts_delta", "rating"]
    for name in want.column_names:
        g, w = got[name], want[name]
        if name == "ts_delta":
            torch.testing.assert_close(g.values.cpu(), w.values, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(g.values.cpu(), w.values), name
    assert torch.equal(got["genres"].offsets.cpu(), want["genres"].offsets)

    loader = DeviceLoader(gpu.transform(nvt.Dataset(tables)), 8192, cat_names=["userId", "movieId", "genres"],
                          cont_names=["ts_delta"], label_names=["rating"], sparse_max={"genres": 4})
    kernels.reset_launches()
    chunks = list(loader.chunks())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ragged_to_padded"] == kernels.LAUNCHES["permute_rows"] == 3
    single, multi = ops.get_embedding_sizes(gpu)
    config = models.TabularMLPConfig(single, 1, layer_sizes=(256, 128), multihot_embedding_sizes=multi)
    model = models.TabularMLP(config, seed=1, compute_dtype=torch.float32)
    batch = {k: v[:8192] for k, v in chunks[0].items()}
    batch["continuous"] = batch.pop("dense")
    assert int(batch["genres__values"].max()) < multi["genres"][0]
    kernels.reset_launches()
    loss = models.tabular_mlp_loss(model, batch)
    loss.backward()
    torch.cuda.synchronize()
    # one gather and one scatter per id table, one bag and its gradient for genres
    want_launches = {"embedding_gather": 2, "embedding_scatter_grad": 2, "embedding_bag_fwd": 1,
                     "embedding_bag_bwd": 1}
    assert {k: kernels.LAUNCHES[k] for k in want_launches} == want_launches
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    ref = models.bce_with_logits(models.tabular_reference_forward(model, batch).reshape(-1), batch["label"])
    ref.backward()
    torch.testing.assert_close(loss, ref, rtol=1e-4, atol=1e-6)
    for g, p in zip(grads, model.parameters()):
        assert float((g - p.grad).abs().max()) <= 1e-4 * float(p.grad.abs().max())

    sliced = nvt.Workflow(["genres"] >> ops.Categorify() >> ops.ListSlice(0, 3, pad=True))
    sliced.fit(nvt.Dataset(tables))
    kernels.reset_launches()
    out = sliced.transform(probe)["genres"]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ragged_slice_padded"] == 1 and kernels.LAUNCHES["tiny_lookup"] == 1
    cpu_sliced = nvt.Workflow(["genres"] >> ops.Categorify() >> ops.ListSlice(0, 3, pad=True), device="cpu")
    nvt.load_fitted_state(cpu_sliced, nvt.fitted_state(sliced))
    ref = cpu_sliced.transform(probe)["genres"]
    assert torch.equal(out.values.cpu(), ref.values) and torch.equal(out.offsets.cpu(), ref.offsets)


def _nan_equal(got, want):
    """Equal, NaN where NaN (its bits may differ)."""
    return got.shape == want.shape and bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


@pytest.mark.parametrize("kinds", [["int32", "int32"], ["int64", "int32", "int64"], ["int64"] * 4, ["int32"]])
def test_hash_pair_kernel_matches_plain(kinds):
    """Both hashes bit for bit, int64 keys inside and outside int32."""
    _require_cuda()
    g = torch.Generator().manual_seed(13)
    cols = [torch.randint(-(2**62), 2**62, (100_003,), generator=g, dtype=torch.int64) for _ in kinds]
    cols = [c.to(torch.int32) if k == "int32" else c for c, k in zip(cols, kinds)]
    want = khp.hash_pair(cols)
    kernels.reset_launches()
    got = khp.hash_pair([c.cuda() for c in cols])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hash_pair"] == 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("codes", [(0, 500, 500), (13, 2 + 10, 1 + 10)], ids=["group_index", "combo"])
def test_hash_pair_verify_kernel_matches_plain(codes):
    """K10b's codes (hit → row, else num_groups) and K9's (hit → row +
    start + offset, miss → OOV + offset, null member → NULL + offset), with
    null members in two columns and h2 mismatches on hits."""
    _require_cuda()
    hit_offset, oov, null = codes
    g = torch.Generator().manual_seed(14)
    n, G = 100_003, 500
    h2_by_group = torch.randint(-(2**31), 2**31 - 1, (G + 1,), generator=g, dtype=torch.int32)
    h2_by_group[-1] = 0
    idx = torch.randint(0, G + 1, (n,), generator=g, dtype=torch.int32)
    h2 = h2_by_group[idx.long()].clone()
    flip = torch.rand(n, generator=g) < 0.1
    h2[flip] ^= 1
    masks = [torch.rand(n, generator=g) > 0.1, torch.rand(n, generator=g) > 0.2]
    want = khp.hash_pair_verify(idx, h2, h2_by_group, masks, G, hit_offset, oov, null)
    kernels.reset_launches()
    got = khp.hash_pair_verify(idx.cuda(), h2.cuda(), h2_by_group.cuda(), [m.cuda() for m in masks], G,
                               hit_offset, oov, null)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hash_pair_verify"] == 1
    assert torch.equal(got.cpu(), want)
    assert set(want.unique().tolist()) >= {oov, null, hit_offset + 1}


def test_hash_lanes_kernel_matches_plain():
    _require_cuda()
    g = torch.Generator().manual_seed(15)
    lo, hi = (torch.randint(0, 2**32, (100_003,), generator=g, dtype=torch.int64) for _ in range(2))
    want = khp.hash_lanes(lo, hi, 9)
    kernels.reset_launches()
    got = khp.hash_lanes(lo.cuda(), hi.cuda(), 9)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["hash_lanes"] == 1 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shifts", [[1, -1], [1, -1, 2, 0, -7], [-3]])
@pytest.mark.parametrize("key_kinds", [["int64"], ["int64", "int32"], ["float32"], []])
def test_difference_lag_kernel_matches_plain(key_kinds, shifts):
    """Bit-equal (any NaN for NaN): int64, int32 and NaN float keys,
    negative shifts, NaN values."""
    _require_cuda()
    g = torch.Generator().manual_seed(16)
    n = 100_003
    keys = []
    for kind in key_kinds:
        k = torch.sort(torch.randint(0, n // 5, (n,), generator=g)).values
        if kind == "float32":
            k = k.to(torch.float32)
            k[torch.rand(n, generator=g) < 0.05] = float("nan")
        keys.append(k.to(torch.int32) if kind == "int32" else k)
    values = [torch.randn(n, generator=g) * 1e3 for _ in range(2)]
    values[0][torch.rand(n, generator=g) < 0.05] = float("nan")
    want = kdl.difference_lag(keys, values, shifts)
    kernels.reset_launches()
    got = kdl.difference_lag([k.cuda() for k in keys], [v.cuda() for v in values], shifts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["difference_lag"] == 1
    assert _nan_equal(got.cpu(), want)


def test_hash_pair_and_lag_kernels_take_empty_inputs_and_the_current_stream():
    _require_cuda()
    kernels.reset_launches()
    empty_i, empty_l = torch.zeros(0, dtype=torch.int32, device="cuda"), torch.zeros(0, dtype=torch.int64, device="cuda")
    h1, h2 = khp.hash_pair([empty_i, empty_l])
    assert h1.shape == h2.shape == (0,)
    table = torch.zeros(4, dtype=torch.int32, device="cuda")
    assert khp.hash_pair_verify(empty_i, empty_i, table, [], 3, 0, 3, 3).shape == (0,)
    assert khp.hash_lanes(empty_l, empty_l).shape == (0,)
    assert kdl.difference_lag([empty_l], [torch.zeros(0, device="cuda")], [1, -1]).shape == (2, 1, 0)
    assert sum(kernels.LAUNCHES.values()) == 0  # nothing to launch
    g = torch.Generator().manual_seed(17)
    keys = [torch.randint(0, 50, (300_001,), generator=g), torch.randint(0, 3, (300_001,), generator=g)]
    x = torch.randn(300_001, generator=g)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair = khp.hash_pair([k.cuda() for k in keys])
        lag = kdl.difference_lag([keys[0].cuda()], [x.cuda()], [2, -1])
    side.synchronize()
    want = khp.hash_pair(keys)
    assert torch.equal(pair[0].cpu(), want[0]) and torch.equal(pair[1].cpu(), want[1])
    assert _nan_equal(lag.cpu(), kdl.difference_lag([keys[0]], [x], [2, -1]))


@pytest.fixture
def no_plain_on_cuda(monkeypatch):
    """Every kernel module's plain version raises when handed a CUDA tensor:
    the path under test must launch the kernels."""
    import nvtabular_tpu_torch.kernels as kpkg

    mods = [kbkt, kcc, kcross, kdl, kemb, kbag, kfm, kgb, khash, khp, kint, kperm, kragged]
    from nvtabular_tpu_torch.kernels import lookup as klookup

    mods.append(klookup)

    def guard(fn):
        def wrapped(*args, **kw):
            flat = list(args) + list(kw.values())
            for a in list(flat):
                if isinstance(a, (list, tuple)):
                    flat.extend(a)
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in flat):
                raise AssertionError(f"{fn.__name__} called on the card")
            return fn(*args, **kw)

        return wrapped

    for mod in mods:
        for name in dir(mod):
            if name.endswith("_plain") and callable(getattr(mod, name)):
                monkeypatch.setattr(mod, name, guard(getattr(mod, name)))
    yield kpkg


def _criteo_part(seed, n=30_000):
    cards = {"C0": 227605432, "C5": 3, "C8": 63, "C9": 130229467, "C12": 10, "C15": 155, "C16": 4, "C18": 14,
             "C19": 292775614, "C24": 108, "C25": 36}
    r = np.random.default_rng(seed)
    data = {}
    for name, card in cards.items():
        raw = (card * r.random(n) ** 2.5).astype(np.int64)
        data[name] = ((raw * np.int64(2654435761)) % np.int64(2**31)).astype(np.int32)
    x = r.normal(1.0, 3.0, n).astype(np.float32)
    x[r.random(n) < 0.05] = np.nan
    data["I0"] = x
    data["label"] = r.integers(0, 2, n).astype(np.int32)
    return data


def _crossed_graph():
    te = [["C5", "C8"], ["C12", "C16", "C18"], ["C15", "C24"]] >> ops.TargetEncoding("label", kfold=5, p_smooth=20)
    jg = [["C5", "C8"], ["C15", "C24"]] >> ops.JoinGroupby(cont_cols=["I0"], stats=["count", "mean"])
    combo = [["C8", "C15"], ["C12", "C25"]] >> ops.Categorify(encode_type="combo")
    hb = ["C0", "C9", "C19"] >> ops.HashBucket(10_000_000)
    return te + jg + combo + hb + ["label"]


def test_crossed_workflow_on_cuda_matches_cpu_and_counts_launches(no_plain_on_cuda):
    """chip_smoke.py phase 12's workflow at a small size, fitted on the card
    and carried to the CPU: group indexes, combo codes and bucket ids exact,
    TE and stat columns within rtol=1e-6; a hash pair, a probe and a verify
    per group, no plain version on the card."""
    _require_cuda()
    gpu = nvt.Workflow(_crossed_graph())
    gpu.fit(nvt.Dataset([_criteo_part(s) for s in range(3)]))
    cpu = nvt.Workflow(_crossed_graph(), device="cpu")
    nvt.load_fitted_state(cpu, nvt.fitted_state(gpu))
    probe = nvt.TableBatch.from_pydict(_criteo_part(9))
    probe.row_offset = 2**32 - 1000
    kernels.reset_launches()
    got = gpu.transform(probe)
    torch.cuda.synchronize()
    te = next(n.op for n in gpu.graph.nodes if isinstance(n.op, ops.TargetEncoding))
    jg = next(n.op for n in gpu.graph.nodes if isinstance(n.op, ops.JoinGroupby))
    cat = next(n.op for n in gpu.graph.nodes if isinstance(n.op, ops.Categorify))
    luts = [k.lookup_struct() for k in [*te.overall_stats.values(), *jg.keyed.values()]]
    luts += [v.lookup_struct()[0] for v in cat.vocabs.values()]
    kinds = [kind_of(lut) for lut in luts]
    want = {"hash_pair": 7, "hash_pair_verify": 7, "tiny_lookup": kinds.count("tiny"),
            "cuckoo_lookup": kinds.count("cuckoo"), "te_encode": 1, "stat_gather": 1, "hashed_cross": 3}
    assert kernels.LAUNCHES == {k: want.get(k, 0) for k in kernels.LAUNCHES}
    ref = cpu.transform(probe)
    assert got.column_names == ref.column_names
    for name in ref.column_names:
        g, w = got[name].values.cpu(), ref[name].values
        if w.is_floating_point():
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7, equal_nan=True)
        else:
            assert torch.equal(g, w), name


def test_sessions_workflow_on_cuda_launches_once_a_batch(no_plain_on_cuda):
    """DifferenceLag over userId-sorted batches: one K12a launch a batch,
    bit-equal to the CPU run (NaN for NaN)."""
    _require_cuda()

    def part(seed, n=50_000):
        r = np.random.default_rng(seed)
        return {
            "userId": np.sort(r.zipf(1.2, n).clip(1, 20_000)).astype(np.int64),
            "rating": (r.integers(1, 11, n) / 2.0).astype(np.float32),
            "ts_delta": r.exponential(86400.0, n).astype(np.float32),
        }

    def graph():
        return (["rating", "ts_delta"] >> ops.DifferenceLag("userId", shift=[1, -1])) + ["userId"]

    parts = [part(s) for s in range(3)]
    gpu, cpu = nvt.Workflow(graph()), nvt.Workflow(graph(), device="cpu")
    kernels.reset_launches()
    outs = [gpu.transform(nvt.TableBatch.from_pydict(p)) for p in parts]
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {k: 3 * (k == "difference_lag") for k in kernels.LAUNCHES}
    for p, out in zip(parts, outs):
        ref = cpu.transform(nvt.TableBatch.from_pydict(p))
        assert out.column_names == ref.column_names
        for name in ref.column_names:
            assert _nan_equal(out[name].values.cpu(), ref[name].values), name


# --- K4's hashed branch and K8 (Categorify's OOV buckets and float keys) ----------------
@pytest.mark.parametrize("with_validity", [False, True])
def test_lookup_kernels_hashed_miss_match_plain(with_validity):
    """K1-K3 with a per-column ``nbuckets``: 1 (the scalar miss), 1000 (not a
    power of two: a mask would differ from the modulo) and 2**31 - 1."""
    _require_cuda()
    rng = np.random.default_rng(16)
    for blut, keysets in _tables(rng):
        sel = list(range(len(keysets))) + [0]
        values = _queries(rng, [keysets[s] for s in sel], 100_003)
        validity = torch.from_numpy(rng.random(values.shape) > 0.1) if with_validity else None
        sel_t = torch.tensor(sel, dtype=torch.int32)
        offs = torch.tensor([11 * i for i in range(len(sel))], dtype=torch.int32)
        nbs = torch.tensor(([1000, 1, 2**31 - 1] * 2)[: len(sel)], dtype=torch.int32)
        want = blut.encode(values, validity, sel_t, offs, nbuckets=nbs)
        got = blut.to("cuda").encode(values.cuda(), None if validity is None else validity.cuda(), sel_t.cuda(),
                                     offs.cuda(), nbuckets=nbs.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), type(blut).__name__
        misses = want[0][(want[0] >= 2) & (want[0] < 1002)]
        assert len(torch.unique(misses)) > 900, type(blut).__name__


def _float_probe(rng, keys, n):
    miss = rng.normal(0.0, 50.0, n).astype(np.float32)
    v = np.where(rng.random(n) < 0.3, miss, rng.choice(keys, n) if len(keys) else miss).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-40, -1e-40, np.float32(-1e30), np.float32(1e30)]
    v[: len(special)] = special
    if len(keys):
        v[len(special):len(special) + 2] = [np.min(keys), np.max(keys)]
        v[len(special) + 2:len(special) + 4] = [np.nextafter(np.min(keys), -np.inf), np.nextafter(np.max(keys), np.inf)]
    return v


@pytest.mark.parametrize("nb", [1, 1000])
@pytest.mark.parametrize("with_validity", [False, True])
def test_sorted_lookup_kernel_matches_plain(with_validity, nb):
    """K8 against its plain version: NaN, ±inf, signed zeros, subnormals,
    values below the smallest key and above the largest, vocabularies of
    length 0, 1 and many (one with ±inf and both zeros among its keys)."""
    _require_cuda()
    rng = np.random.default_rng(17)
    vocabs = [
        np.unique(rng.normal(0.0, 30.0, 20_000).round(2)),
        np.zeros(0),
        np.array([0.5]),
        np.array([np.inf, -np.inf, 0.0, -0.0, 1.0, 1.0 + 2.0**-40, 1e-40, 3.5]),
    ]
    luts = [plookup.SortedLookup(rng.permutation(v), np.arange(len(v)) + 2 + nb) for v in vocabs]
    table = plookup.BatchedSorted(luts)
    sel = [0, 1, 2, 3, 0]
    values = torch.from_numpy(np.stack([_float_probe(rng, vocabs[s].astype(np.float32), 100_003) for s in sel]))
    validity = torch.from_numpy(rng.random(values.shape) > 0.1) if with_validity else None
    sel_t = torch.tensor(sel, dtype=torch.int32)
    offs = torch.tensor([5 * i for i in range(len(sel))], dtype=torch.int32)
    nbs = torch.full((len(sel),), nb, dtype=torch.int32)
    want = table.encode(values, validity, sel_t, offs, nbuckets=nbs)
    got = table.to("cuda").encode(values.cuda(), None if validity is None else validity.cuda(), sel_t.cuda(),
                                  offs.cuda(), nbuckets=nbs.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert (want[1] < 2 + nb + 5).all()  # the empty vocabulary: OOV or null only
    assert (want[:, 0] == torch.tensor([1 + 5 * i for i in range(len(sel))], dtype=torch.int32)).all()  # NaN


def test_sorted_lookup_takes_empty_inputs_and_the_current_stream():
    _require_cuda()
    table = plookup.BatchedSorted([plookup.SortedLookup(np.array([1.0, 2.0]), np.array([3, 4]))]).to("cuda")
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    kernels.reset_launches()
    assert table.encode(torch.zeros((1, 0), device="cuda"), None, one, one).shape == (1, 0)
    assert kernels.LAUNCHES["sorted_lookup"] == 0
    x = torch.randn((1, 300_001), device="cuda").round()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = table.encode(x, None, one, one, nbuckets=one + 7)
    side.synchronize()
    cpu = plookup.BatchedSorted([plookup.SortedLookup(np.array([1.0, 2.0]), np.array([3, 4]))])
    z = torch.zeros(1, dtype=torch.int32)
    assert torch.equal(got.cpu(), cpu.encode(x.cpu(), None, z, z, nbuckets=z + 7))
    with pytest.raises(TypeError):
        table.encode(x.double(), None, one, one)


def test_buckets_workflow_on_cuda_matches_cpu_and_counts_launches(no_plain_on_cuda):
    """chip_smoke.py phase 15's workflow at a small size: Criteo-shaped int
    columns and float columns through Categorify(freq_threshold=2,
    num_buckets=1000), fitted on the card and carried to the CPU; one launch
    a table kind for the ints, one sorted_lookup for the floats, codes
    exact, no plain version on the card."""
    _require_cuda()

    def part(seed, n=30_000):
        data = _criteo_part(seed, n)
        r = np.random.default_rng(100 + seed)
        for i in range(3):
            x = r.normal(1.0, 3.0, n).astype(np.float32)
            x[r.random(n) < 0.05] = np.nan
            data[f"F{i}"] = x
        return data

    ints = ["C0", "C5", "C8", "C9", "C12", "C15", "C19"]
    floats = ["F0", "F1", "F2"]

    def graph():
        cats = ints >> ops.Categorify(freq_threshold=2, max_size=10_000_000, num_buckets=1000)
        conts = floats >> ops.Categorify(freq_threshold=2, num_buckets=1000)
        return cats + conts + ["label"]

    gpu = nvt.Workflow(graph())
    gpu.fit(nvt.Dataset([part(s) for s in range(3)]))
    cpu = nvt.Workflow(graph(), device="cpu")
    nvt.load_fitted_state(cpu, nvt.fitted_state(gpu))
    probe = nvt.TableBatch.from_pydict(part(9))
    kernels.reset_launches()
    got = gpu.transform(probe)
    torch.cuda.synchronize()
    cat = next(n.op for n in gpu.graph.nodes if isinstance(n.op, ops.Categorify) and "C0" in n.op.vocabs)
    want = {f"{k}_lookup": 1 for k in cat._get_batched() if k != "sorted"} | {"sorted_lookup": 1}
    assert kernels.LAUNCHES == {k: want.get(k, 0) for k in kernels.LAUNCHES}
    ref = cpu.transform(probe)
    for name in ref.column_names:
        assert torch.equal(got[name].values.cpu(), ref[name].values), name
    for name in ["C0", "C9", "C19"] + floats:  # the long tails miss the vocabulary
        codes = ref[name].values
        assert ((codes >= 2) & (codes < 1002)).any(), name


def _fm_case(g, B, F, D, nd, out_of_range):
    sizes = [int(v) for v in torch.randint(1, 5000, (F,), generator=g)]
    offsets = [0]
    for v in sizes[:-1]:
        offsets.append(offsets[-1] + v)
    ids = _columns(g, B, sizes, False)
    if out_of_range:  # in every other column, column 0 included
        for c in range(0, F, 2):
            v = sizes[c]
            ids[c][:6] = torch.tensor([v, v + 5, -1, -v, -v - 1, 2**31 - 1], dtype=torch.int32)
    return sizes, offsets, ids, torch.randn(sum(sizes), generator=g), torch.randn(nd, generator=g)


def _wide(t, pad, device="cpu"):
    """``t`` [B, ...] copied into the first columns of a [B, width + pad]
    buffer on ``device``: a strided view, each row contiguous."""
    B = t.shape[0]
    flat = t.reshape(B, -1)
    buf = torch.zeros((B, flat.shape[1] + pad), device=device)
    buf[:, : flat.shape[1]] = flat.to(device)
    return buf[:, : flat.shape[1]].unflatten(1, t.shape[1:]) if t.dim() > 2 else buf[:, : flat.shape[1]]


@pytest.mark.parametrize(
    "B,F,D,strided,out_of_range",
    [(65_537, 26, 16, True, False), (1001, 26, 8, False, True), (1001, 1, 16, True, True), (4099, 1, 8, False, False),
     (1001, 5, 6, True, True)],
    ids=["criteo_strided", "d8_out_of_range", "one_field", "one_field_d8", "d6_generic"],
)
def test_fm_kernels_match_plain(B, F, D, strided, out_of_range):
    """K16 against its plain versions. Forward: 1e-5 of the sum of its
    terms' magnitudes (sum_d (s_d^2 + sum_f v_fd^2), the linear weights and
    the dense products), NaN where an id is out of range. Backward: dv =
    g (s - v) within 1e-5 of |g| sum_f |v_fd|; ddense = g w exact; the
    linear scatter and the dense_w column sums in a varying order, within
    1e-5 of the sums of their terms' magnitudes."""
    _require_cuda()
    gen = torch.Generator().manual_seed(11)
    nd = 13
    sizes, offsets, ids, linear, dense_w = _fm_case(gen, B, F, D, nd, out_of_range)
    v, dense, g = torch.randn((B, F, D), generator=gen), torch.randn((B, nd), generator=gen), torch.randn(B, generator=gen)
    want = kfm.fm_fwd(v, dense, ids, offsets, sizes, linear, dense_w)
    want_b = kfm.fm_bwd(v, dense, ids, offsets, sizes, dense_w, g, linear.shape[0])
    pad = 5 if strided else 0
    vc, dc = (_wide(v, pad, "cuda"), _wide(dense, pad, "cuda")) if strided else (v.cuda(), dense.cuda())
    cids = [i.cuda() for i in ids]
    dvbuf = torch.full((B, F * D + nd + 2), 7.0, device="cuda")
    kernels.reset_launches()
    got = kfm.fm_fwd(vc, dc, cids, offsets, sizes, linear.cuda(), dense_w.cuda())
    dv, ddense, dlinear, ddense_w = kfm.fm_bwd(
        vc, dc, cids, offsets, sizes, dense_w.cuda(), g.cuda(), linear.shape[0],
        dv_out=dvbuf[:, : F * D].unflatten(1, (F, D)), ddense_out=dvbuf[:, F * D : F * D + nd],
    )
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fm_fwd"] == 1 and kernels.LAUNCHES["fm_bwd"] == 1
    s, q = v.sum(1), (v * v).sum(1)
    rows, valid = kemb.table_rows(ids, offsets, sizes)
    scale = (s * s + q).sum(1) + torch.where(valid, linear[rows].abs(), 0.0).sum(1) + (dense * dense_w).abs().sum(1)
    got = got.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(want).any()) == out_of_range
    ok = ~torch.isnan(want)
    assert bool(((got - want).abs()[ok] <= 1e-5 * scale[ok] + 1e-6).all())
    ga = g.abs()
    assert bool(((dv.cpu() - want_b[0]).abs() <= 1e-5 * ga[:, None, None] * v.abs().sum(1, keepdim=True) + 1e-6).all())
    assert torch.equal(ddense.cpu(), want_b[1])
    assert bool((dvbuf[:, F * D + nd :] == 7.0).all())  # the buffer's other columns untouched
    mag = kfm.fm_bwd_plain(v, dense.abs(), ids, offsets, sizes, dense_w, ga, linear.shape[0])
    assert bool(((dlinear.cpu() - want_b[2]).abs() <= 1e-5 * mag[2] + 1e-6).all())
    assert bool(((ddense_w.cpu() - want_b[3]).abs() <= 1e-5 * mag[3] + 1e-6).all())


@pytest.mark.parametrize("B,N,strided", [(65_537, 429, True), (1001, 29, False), (5, 1, False)])
def test_cross_kernels_match_plain(B, N, strided):
    """K17 against its plain versions: the forward and the elementwise
    gradients are the same rounded operations, bit-equal; db sums B
    products in a varying order, within 1e-5 of the sum of their
    magnitudes."""
    _require_cuda()
    gen = torch.Generator().manual_seed(12)
    xw, x0, x, g = (torch.randn((B, N), generator=gen) for _ in range(4))
    b = torch.randn(N, generator=gen)
    want = kcross.cross_fwd(xw, b, x0, x)
    want_dxw, want_dx0, want_db = kcross.cross_bwd(g, xw, b, x0)
    cuda = (lambda a: _wide(a, 3, "cuda")) if strided else (lambda a: a.cuda())
    xwc, x0c, xc, gc = cuda(xw), cuda(x0), cuda(x), cuda(g)
    kernels.reset_launches()
    got = kcross.cross_fwd(xwc, b.cuda(), x0c, xc)
    dxw, dx0, db = kcross.cross_bwd(gc, xwc, b.cuda(), x0c)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cross_fwd"] == 1 and kernels.LAUNCHES["cross_bwd"] == 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(dxw.cpu(), want_dxw) and torch.equal(dx0.cpu(), want_dx0)
    assert bool(((db.cpu() - want_db).abs() <= 1e-5 * (g * x0).abs().sum(0) + 1e-6).all())


def test_fm_and_cross_kernels_take_empty_inputs_and_the_current_stream():
    _require_cuda()
    kernels.reset_launches()
    z = torch.zeros((0, 2, 8), device="cuda")
    ids = [torch.zeros(0, dtype=torch.int32, device="cuda")] * 2
    lin, w = torch.zeros(6, device="cuda"), torch.zeros(3, device="cuda")
    dense = torch.zeros((0, 3), device="cuda")
    assert kfm.fm_fwd(z, dense, ids, [0, 3], [3, 3], lin, w).shape == (0,)
    _, _, dlinear, dw = kfm.fm_bwd(z, dense, ids, [0, 3], [3, 3], w, torch.zeros(0, device="cuda"), 6)
    assert dlinear.shape == (6,) and float(dlinear.abs().sum()) == 0.0 and dw.shape == (3,)
    e = torch.zeros((0, 7), device="cuda")
    assert kcross.cross_fwd(e, torch.zeros(7, device="cuda"), e, e).shape == (0, 7)
    assert sum(kernels.LAUNCHES.values()) == 0  # nothing to launch
    gen = torch.Generator().manual_seed(13)
    xw, x0 = torch.randn((3000, 45), generator=gen), torch.randn((3000, 45), generator=gen)
    b = torch.randn(45, generator=gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xwc, bc, x0c = xw.cuda(), b.cuda(), x0.cuda()
        got = kcross.cross_fwd(xwc, bc, x0c, x0c)
    side.synchronize()
    assert torch.equal(got.cpu(), kcross.cross_fwd(xw, b, x0, x0))


@pytest.mark.parametrize("family", ["deepfm", "dcn"])
def test_deepfm_and_dcn_steps_through_kernels_match_plain_reference(family):
    """One loss and gradient through the kernels against the reference
    forward (the plain versions, autograd through PyTorch) on the card, in
    float32 compute: only summation orders differ (rtol 1e-4 on the loss
    and the logits; gradients within 1e-4 of their largest entry)."""
    _require_cuda()
    cards = {"a": 3, "b": 500, "c": 40_000}
    if family == "deepfm":
        model = models.DeepFM(models.DeepFMConfig(cards, num_dense=13), seed=1, compute_dtype=torch.float32)
        reference, want = models.deepfm_reference_forward, {"fm_fwd": 1, "fm_bwd": 1}
    else:
        model = models.DCN(models.DCNConfig(cards, num_dense=13), seed=1, compute_dtype=torch.float32)
        reference, want = models.dcn_reference_forward, {"cross_fwd": 3, "cross_bwd": 3}
    batch = {
        k: torch.from_numpy(v).cuda()
        for k, v in models.make_synthetic_batch(models.DLRMConfig(cards, num_dense=13), 4096, seed=2).items()
    }
    with torch.no_grad():  # a trained-looking state: every parameter nonzero
        for p in model.parameters():
            p.add_(torch.randn(p.shape, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3)) * 0.01)
    kernels.reset_launches()
    logits = model(batch)
    loss = models.bce_with_logits(logits, batch["label"])
    loss.backward()
    torch.cuda.synchronize()
    want |= {"embedding_gather": 1, "embedding_scatter_grad": 1}
    assert kernels.LAUNCHES == {k: want.get(k, 0) for k in kernels.LAUNCHES}
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    ref_logits = reference(model, batch)
    ref_loss = models.bce_with_logits(ref_logits, batch["label"])
    ref_loss.backward()
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=1e-6)
    for (name, p), got in zip(model.named_parameters(), grads):
        assert float((got - p.grad).abs().max()) <= 1e-4 * float(p.grad.abs().max()), name


# --- K15: the sharded vocabulary count, moments and row-sharded lookups ------------------
def _exchange_keys(n, seed):
    """Power-law int32 ids with pads and the int32 extremes among them."""
    rng = np.random.default_rng(seed)
    keys = ((rng.zipf(1.2, n) * 2654435761) % (1 << 31)).astype(np.int64) - (1 << 30)
    keys = keys.astype(np.int32)
    if n >= 64:
        keys[rng.choice(n, 16, replace=False)] = kex.PAD
        keys[:4] = [I32_MIN, I32_MAX - 1, -1, 0]
    return torch.from_numpy(keys)


@pytest.mark.parametrize("n", [0, 5, 1024, 300_007])
@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("factor", [2.5, 0.2], ids=["fits", "overflows"])
def test_exchange_route_matches_plain(ndev, n, factor):
    """K15a's routing: the send buffer and the overflow bit-equal to the
    plain version, a forced overflow included (factor 0.2)."""
    _require_cuda()
    keys = _exchange_keys(n, seed=ndev)
    cap = max(int(np.ceil(n * factor / ndev)), 8)
    kernels.reset_launches()
    send, overflow = kex.exchange_route(keys.cuda(), ndev, cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["exchange_route"] == 1
    want_send, want_over = kex.exchange_route_plain(keys, ndev, cap)
    assert torch.equal(send.cpu(), want_send)
    assert int(overflow[0]) == int(want_over[0])
    if factor < 1 and n > 1000:
        assert int(want_over[0]) > 0


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 3])
def test_radix_sort_matches_plain(n):
    _require_cuda()
    keys = _exchange_keys(n, seed=n)
    kernels.reset_launches()
    got = kex.radix_sort(keys.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["radix_sort"] == (1 if n else 0)
    assert torch.equal(got.cpu(), kex.radix_sort_plain(keys))
    assert torch.equal(got.cpu(), torch.sort(keys).values)


@pytest.mark.parametrize("D", [16, 5])
def test_range_gather_and_bag_match_plain(D):
    """K15b on model shard 1 of 4 of a [4000, D] table (float4 and scalar
    accesses): the gather bit-equal, the bag bit-equal (the same roundings
    in the same order)."""
    _require_cuda()
    gen = torch.Generator().manual_seed(D)
    table = torch.randn((4000, D), generator=gen)
    local, start = table[1000:2000].contiguous(), 1000
    ids = torch.randint(-5, 4005, (70_001,), generator=gen, dtype=torch.int32)
    values = torch.randint(-5, 4005, (20_001, 6), generator=gen, dtype=torch.int32)
    mask = (torch.rand((20_001, 6), generator=gen) < 0.7).float()
    kernels.reset_launches()
    got = kemb.embedding_range_gather(local.cuda(), ids.cuda(), start)
    got_bag = kbag.embedding_range_bag(local.cuda(), values.cuda(), mask.cuda(), start)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_range_gather"] == 1 and kernels.LAUNCHES["embedding_range_bag"] == 1
    assert torch.equal(got.cpu(), kemb.embedding_range_gather_plain(local, ids, start))
    assert torch.equal(got_bag.cpu(), kbag.embedding_range_bag_plain(local, values, mask, start))


@pytest.mark.parametrize("rows", [0, 1, 262_144])
def test_column_moments_match_plain(rows):
    """K15c: count, min and max exact; mean and M2 within rtol 1e-5 (float64
    sums against float32 ones); an all-NaN column gives count 0, mean 0 and
    +inf / -inf."""
    _require_cuda()
    gen = torch.Generator().manual_seed(rows)
    x = torch.randn((rows, 13), generator=gen) * 3.0 + 1.0
    x[torch.rand((rows, 13), generator=gen) < 0.05] = float("nan")
    x[:, 12] = float("nan")
    kernels.reset_launches()
    got = kmom.column_moments(x.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["column_moments"] == 1
    want = kmom.column_moments_plain(x)
    for i in (0, 3, 4):
        assert torch.equal(got[i].cpu(), want[i])
    for i in (1, 2):
        torch.testing.assert_close(got[i].cpu(), want[i], rtol=1e-5, atol=1e-6)
    assert int(got[0][12]) == 0 and float(got[1][12]) == 0.0


def test_categorify_fit_mesh_on_one_rank_nccl_matches_single_process(tmp_path):
    """A 1-rank NCCL group on the card: Categorify counts its columns with
    K15a (route, all_to_all, sort) and fits the vocabularies of the
    single-process fit, value for value and count for count."""
    _require_cuda()
    import torch.distributed as dist

    from nvtabular_tpu_torch.dag.executor import TorchExecutor
    from nvtabular_tpu_torch.parallel import initialize_distributed, local_mesh

    rng = np.random.default_rng(8)
    parts = [
        nvt.TableBatch.from_pydict({
            "a": ((rng.zipf(1.2, 50_000) * 2654435761) % (1 << 31)).astype(np.int32),
            "b": rng.integers(0, 40, 50_000).astype(np.int32),
        })
        for _ in range(3)
    ]
    initialize_distributed("nccl", f"file://{tmp_path / 'store'}", 0, 1, timeout=120)
    try:
        mesh_wf = nvt.Workflow(["a", "b"] >> ops.Categorify(), executor=TorchExecutor("cuda:0", mesh=local_mesh()))
        kernels.reset_launches()
        mesh_wf.fit(nvt.Dataset(parts))
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["exchange_route"] == 2 and kernels.LAUNCHES["radix_sort"] == 2
    finally:
        dist.destroy_process_group()
    wf = nvt.Workflow(["a", "b"] >> ops.Categorify())
    wf.fit(nvt.Dataset(parts))
    got = next(n.op for n in mesh_wf.graph.nodes if isinstance(n.op, ops.Categorify)).vocabs
    want = next(n.op for n in wf.graph.nodes if isinstance(n.op, ops.Categorify)).vocabs
    for key in ("a", "b"):
        np.testing.assert_array_equal(got[key].values_by_code, want[key].values_by_code)
        np.testing.assert_array_equal(got[key].counts, want[key].counts)


def test_multiprocess_fit_across_cards_matches_one_process(tmp_path):
    """An NCCL group of one rank a card, on every card of the machine: the
    Criteo-shaped workflow of test_torch_multiprocess_fit.py fitted through
    the exchange routes and the allgather ones (K15a over NCCL's all_to_all,
    the keyed-row exchange, pickled states gathered across cards) gives the
    vocabularies and group tables of one process's fit on the card, and the
    ranks' transforms equal one process's."""
    _require_cuda()
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two CUDA devices or more (NCCL refuses two ranks on one device)")
    import test_torch_multiprocess_fit as mp

    from torch_groups import run_group

    parts = mp.port_parts()
    wf = nvt.Workflow(mp.graph(ops))
    wf.fit(nvt.Dataset(parts))
    want, want_outs = mp.port_digests(wf), mp.transform_parts(wf, parts, range(mp.PARTS))
    results = run_group(mp.fit_worker, world, tmp_path, "cuda", backend="nccl", timeout=300)
    got_outs = {}
    for res in results:
        for route in ("exchange", "gather"):
            mp._assert_same_fit(res[route]["digests"], want)
        assert res["exchange"]["reduce"]["Categorify"] == {"exchange": mp.CATS, "gather": []}
        got_outs.update(res["outs"])
    assert sorted(got_outs) == list(range(mp.PARTS))
    for i, outs in want_outs.items():
        for name, w in outs.items():
            if name in mp.CONTS:
                np.testing.assert_allclose(got_outs[i][name], w, **mp.OUT_TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(got_outs[i][name], w, err_msg=name)


def _shard_columns(g, B, cards, M, m, D):
    """Tables padded to multiples of M, shard m of M of each concatenated,
    the shard's columns and ids with the edge cases in every other column:
    a padding row, -1 (wraps to it), -Vp (wraps to row 0), and ids no rank
    holds."""
    padded = [-(-v // M) * M for v in cards]
    sizes = [vp // M for vp in padded]
    starts = [m * s for s in sizes]
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s)
    local = torch.randn((sum(sizes), D), generator=g)
    ids = []
    for c, (v, vp) in enumerate(zip(cards, padded)):
        i = (torch.rand(B, generator=g) ** 2.5 * v).to(torch.int32)
        if c % 2:
            i[:7] = torch.tensor([v, -1, -vp, vp, -vp - 1, 2**31 - 1, vp - 1], dtype=torch.int32)
        ids.append(i)
    return local, ids, offsets, sizes, starts, padded


@pytest.mark.parametrize("model_rank", [0, 1])
@pytest.mark.parametrize("D", [16, 5])
def test_range_column_kernels_match_plain(D, model_rank):
    """K15d on model shard 1 of 4 (and shard 0, which writes the NaN rows)
    of 26 padded tables, with float4 (D = 16) and scalar (D = 5) accesses:
    the gather bit-equal to its plain version, NaN where it has NaN; the
    scatter-add within 1e-5 of the sum of its terms' magnitudes (atomics
    sum in a varying order), from a strided view of the gradient."""
    _require_cuda()
    g = torch.Generator().manual_seed(D + model_rank)
    cards = [3, 40, 1001, 7, 60_000, 5, 200, 12_345] * 3 + [4, 90]
    B = 4099
    local, ids, offsets, sizes, starts, padded = _shard_columns(g, B, cards, 4, model_rank, D)
    cols = (offsets, sizes, starts, padded)
    dev_ids = [i.cuda() for i in ids]
    grad = torch.randn((B, len(cards), D), generator=g)
    gbuf = torch.zeros((B, 1 + len(cards), D), device="cuda")
    gbuf[:, 1:] = grad.cuda()
    kernels.reset_launches()
    got = kemb.range_gather_columns(local.cuda(), dev_ids, *cols, model_rank)
    got_grad = kemb.range_scatter_grad(gbuf[:, 1:], dev_ids, *cols, local.shape[0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["range_gather_columns"] == 1 and kernels.LAUNCHES["range_scatter_grad"] == 1
    want = kemb.range_gather_columns_plain(local, ids, *cols, model_rank)
    assert got.is_contiguous() and torch.equal(torch.isnan(got.cpu()), torch.isnan(want))
    assert torch.isnan(want).any() == (model_rank == 0)
    assert torch.equal(torch.nan_to_num(got.cpu()), torch.nan_to_num(want))
    want_grad = kemb.range_scatter_grad_plain(grad, ids, *cols, local.shape[0])
    magnitude = kemb.range_scatter_grad_plain(grad.abs(), ids, *cols, local.shape[0])
    assert bool(((got_grad.cpu() - want_grad).abs() <= 1e-5 * magnitude + 1e-6).all())


def test_range_column_kernels_take_empty_inputs_and_the_current_stream():
    """No ids: an empty gather and a zero gradient; on a side stream the
    kernels follow the stream they are launched on (the gather bit-equal,
    the scatter within 1e-5 of its terms' magnitudes: atomics)."""
    _require_cuda()
    g = torch.Generator().manual_seed(3)
    local, ids, offsets, sizes, starts, padded = _shard_columns(g, 20_001, [50, 3000, 9], 2, 1, 8)
    cols = (offsets, sizes, starts, padded)
    empty = [torch.zeros(0, dtype=torch.int32, device="cuda")] * 3
    assert kemb.range_gather_columns(local.cuda(), empty, *cols, 1).shape == (0, 3, 8)
    zero = kemb.range_scatter_grad(torch.zeros((0, 3, 8), device="cuda"), empty, *cols, local.shape[0])
    assert zero.shape == local.shape and not bool(zero.any())
    side = torch.cuda.Stream()
    grad = torch.randn((20_001, 3, 8), generator=g)
    dl, di, dg = local.cuda(), [i.cuda() for i in ids], grad.cuda()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        got = kemb.range_gather_columns(dl, di, *cols, 1)
        got_grad = kemb.range_scatter_grad(dg, di, *cols, local.shape[0])
    side.synchronize()
    assert torch.equal(got.cpu(), kemb.range_gather_columns_plain(local, ids, *cols, 1))
    want_grad = kemb.range_scatter_grad_plain(grad, ids, *cols, local.shape[0])
    magnitude = kemb.range_scatter_grad_plain(grad.abs(), ids, *cols, local.shape[0])
    assert bool(((got_grad.cpu() - want_grad).abs() <= 1e-5 * magnitude + 1e-6).all())


def test_sharded_step_on_one_rank_nccl_matches_unsharded(tmp_path):
    """A one-rank NCCL group on the card: shard_params, shard_batch and
    make_train_step over a (1, 1) mesh take three Adagrad steps through
    K15d (one range_gather_columns and one range_scatter_grad a step, no
    K13a) from the parameters of an unsharded DLRM, which takes the same
    steps through K13a: losses within rtol 1e-5, tables and MLPs within
    1e-5 (the scatters' atomics sum in varying orders)."""
    _require_cuda()
    import torch.distributed as dist

    from nvtabular_tpu_torch import parallel

    config = models.DLRMConfig({"a": 1001, "b": 499, "c": 7}, num_dense=13, embedding_dim=16, vocab_pad_multiple=4)
    batch = {k: torch.from_numpy(v) for k, v in models.make_synthetic_batch(config, 4096, seed=2).items()}
    batch["a"][:2] = torch.tensor([1001, -1], dtype=torch.int32)  # padding rows
    want_model = models.DLRM(config, seed=1)
    want_opt = models.Adagrad(want_model.parameters())
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    want = [float(models.train_step(want_model, want_opt, dev_batch)) for _ in range(3)]
    parallel.initialize_distributed("nccl", f"file://{tmp_path / 'store'}", 0, 1, timeout=120)
    try:
        mesh = parallel.local_mesh()
        model = models.DLRM(config, seed=1)
        p_specs, b_specs = models.dlrm_param_specs(model), models.batch_specs(config)
        parallel.shard_params(model, p_specs, mesh)
        opt = models.Adagrad(model.parameters())
        step = parallel.make_train_step(models.dlrm_loss, opt, mesh=mesh, param_specs=p_specs, batch_specs=b_specs)
        local = parallel.shard_batch(batch, b_specs, mesh)
        kernels.reset_launches()
        got = [float(step(model, opt, local)) for _ in range(3)]
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["range_gather_columns"] == 3 and kernels.LAUNCHES["range_scatter_grad"] == 3
        assert kernels.LAUNCHES["embedding_gather"] == 0 and kernels.LAUNCHES["embedding_scatter_grad"] == 0
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for p, q in zip(model.parameters(), want_model.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-5)


def test_sharded_train_step_across_cards_matches_one_process(tmp_path):
    """An NCCL group of one rank a card on every card of the machine (data
    2 x model 2 on four; model 2 on two): three sharded Adagrad steps of one
    global batch of a DLRM with two tables and two multihot tables give one
    process's unsharded steps on a card from the same parameters — every
    rank's losses and both kinds of tables stacked from the ranks within
    1e-5 (atomics and the data axis's sums in other orders), the MLPs
    within 1e-5 on one data rank and within STEPS * lr * 2**-8 on two (each
    data rank's weight gradient rounds to bfloat16 before their sum, one
    process's once: test_torch_sharded_train.py) — and the MLP replicas are
    bit-equal across the ranks."""
    _require_cuda()
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two CUDA devices or more (NCCL refuses two ranks on one device)")
    import test_torch_dlrm_multihot as mh

    from torch_groups import run_group

    model_size = 2 if world % 2 == 0 else 1
    params = nvt.dlrm_params(models.DLRM(mh.config(), seed=5, device="cpu"))
    batch = mh.step_batch()
    ref = models.DLRM(mh.config(), device="cuda:0")
    nvt.load_dlrm_params(ref, params)
    opt = models.Adagrad(ref.parameters(), lr=mh.LR)
    want = [float(models.train_step(ref, opt, {k: torch.from_numpy(v).cuda() for k, v in batch.items()}))
            for _ in range(mh.STEPS)]
    want_params = nvt.dlrm_params(ref)
    ranks = run_group(mh.train_worker, world, tmp_path, model_size, params, batch, backend="nccl", timeout=300)
    mlp_tol = dict(rtol=1e-5, atol=1e-5) if world == model_size else dict(rtol=0, atol=mh.STEPS * mh.LR * 2**-8)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want, rtol=1e-5)
        for side in ("bottom", "top"):
            for got, w, first in zip(res["params"][side], want_params[side], ranks[0]["params"][side]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(got[k], w[k], **mlp_tol)
                    assert np.array_equal(got[k].view(np.int32), first[k].view(np.int32))
    for kind in ("tables", "mh_tables"):
        tables = mh._stacked(ranks, model_size, kind)
        for n, w in want_params[kind].items():
            np.testing.assert_allclose(tables[n], w, rtol=1e-5, atol=1e-5, err_msg=n)


# --- K15d's bag, K13b's self-interaction mode and K13d ------------------------------------
def _bag_shard(g, B, L, vp, M, m, D):
    """Shard m of M of a padded [vp, D] multihot table, ids over [-vp - 3,
    vp + 3) (negatives wrap, a few outside the table, some masked) and a
    mask with an all-masked row."""
    rows = vp // M
    local = torch.randn((rows, D), generator=g)
    values = torch.randint(-vp - 3, vp + 3, (B, L), generator=g, dtype=torch.int32)
    mask = (torch.rand((B, L), generator=g) < 0.8).float()
    mask[0] = 0.0
    values[1, 0], mask[1, 0] = vp, 0.0  # masked, no rank's: NaN on model rank 0
    return local, values, mask, m * rows


@pytest.mark.parametrize("combiner", ["mean", "sum"])
@pytest.mark.parametrize("model_rank", [0, 1])
@pytest.mark.parametrize("vp,D", [(24, 64), (24, 5), (40_000, 16)], ids=["genres_shared", "scalar", "global"])
def test_range_bag_kernels_match_plain(vp, D, model_rank, combiner):
    """K15d's bag on model shard model_rank of 4: the take-mode forward
    bit-equal to its plain version (NaN bags on model rank 0 alone),
    written into a slot of a wider buffer; the backward within 1e-5 of the
    sum of its terms' magnitudes (atomics), from a strided gradient, with
    the take rule and the zero rule. 24 rows of 64 take the shared-memory
    sums under full contention (65,536 x 4 ids on 6 rows), 40,000 rows the
    global atomics."""
    _require_cuda()
    g = torch.Generator().manual_seed(vp + D + model_rank)
    B, L = 65_536, 4
    local, values, mask, start = _bag_shard(g, B, L, vp, 4, model_rank, D)
    dl, dv, dm = local.cuda(), values.cuda(), mask.cuda()
    buf = torch.zeros((B, 3, D), device="cuda")
    gbuf = torch.zeros((B, 3, D), device="cuda")
    grad = torch.randn((B, D), generator=g)
    gbuf[:, 1] = grad.cuda()
    kernels.reset_launches()
    kbag.range_bag(dl, dv, dm, start, vp, model_rank, out=buf[:, 1])
    got_grads = {wrap: kbag.range_bag_grad(gbuf[:, 1], dv, dm, start, local.shape[0], vp, combiner, wrap)
                 for wrap in (True, False)}
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["range_bag"] == 1 and kernels.LAUNCHES["range_bag_grad"] == 2
    want = kbag.range_bag_plain(local, values, mask, start, vp, model_rank)
    got = buf[:, 1].cpu()
    assert torch.equal(got.isnan(), want.isnan()) and bool(want[:, 0].isnan().any()) == (model_rank == 0)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert not bool(buf[:, [0, 2]].any())
    for wrap, got_grad in got_grads.items():
        want_grad = kbag.range_bag_grad_plain(grad, values, mask, start, local.shape[0], vp, combiner, wrap)
        magnitude = kbag.range_bag_grad_plain(grad.abs(), values, mask, start, local.shape[0], vp, combiner, wrap)
        assert bool(((got_grad.cpu() - want_grad).abs() <= 1e-5 * magnitude + 1e-6).all()), wrap


def test_range_bag_on_one_rank_is_the_whole_bag_bit_for_bit():
    """On one model rank the take-mode bag sums the whole padded table's rows
    in K13c's order and roundings: bit-equal to embedding_bag_fwd's sum."""
    _require_cuda()
    g = torch.Generator().manual_seed(11)
    local, values, mask, _ = _bag_shard(g, 50_001, 4, 24, 1, 0, 64)
    dl, dv, dm = local.cuda(), values.cuda(), mask.cuda()
    got = kbag.range_bag(dl, dv, dm, 0, 24, 0)
    want = kbag.embedding_bag_fwd(dl, dv, dm, "sum")
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan()) and bool(got.isnan().any())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("F,D", [(27, 16), (5, 8), (1, 3), (4, 5)])
def test_interaction_self_mode_kernels_match_plain(F, D):
    """K13b's self-interaction mode: P = F (F + 1) / 2 dots within one ULP of
    the plain version (the same fmaf steps in the same order, which the
    plain version rounds twice, through float64, about once in 2^29),
    written after a lead, and the backward (2 g_ii x_i on the diagonal) from
    a strided gradient (rtol 1e-5, atol 1e-5); counted apart from the strict
    mode."""
    _require_cuda()
    g = torch.Generator().manual_seed(F + D)
    B, P = 1001, F * (F + 1) // 2
    x = torch.randn((B, F, D), generator=g)
    grad = torch.randn((B, P), generator=g)
    xc = x.cuda()
    buf = torch.zeros((B, D + P), device="cuda")
    gbuf = torch.zeros((B, D + P), device="cuda")
    gbuf[:, D:] = grad.cuda()
    kernels.reset_launches()
    kint.interaction_fwd(xc, out=buf[:, D:], self_interaction=True)
    got_dx = kint.interaction_bwd(xc, gbuf[:, D:], self_interaction=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["interaction_self_fwd"] == 1 and kernels.LAUNCHES["interaction_self_bwd"] == 1
    assert kernels.LAUNCHES["interaction_fwd"] == 0 and kernels.LAUNCHES["interaction_bwd"] == 0
    torch.testing.assert_close(buf[:, D:].cpu(), kint.interaction_fwd_plain(x, True), rtol=2**-23, atol=0)
    assert not bool(buf[:, :D].any())
    torch.testing.assert_close(got_dx.cpu(), kint.interaction_bwd_plain(x, grad, True), rtol=1e-5, atol=1e-5)


def _cin_inputs(g, B, Hk, F, D, Hn, same):
    x0 = torch.randn((B, F, D), generator=g)
    xk = x0 if same else torch.randn((B, Hk, D), generator=g)
    w = torch.randn((Hk * F, Hn), generator=g) / (Hk * F) ** 0.5
    return xk, x0, w, torch.randn((B, Hn, D), generator=g)


def _within_terms(got, want, magnitude, rtol=1e-5, atol=1e-6) -> bool:
    return bool(((got - want).abs() <= rtol * magnitude + atol).all())


@pytest.mark.parametrize(
    "B,Hk,F,D,Hn,same",
    [(2053, 26, 26, 16, 200, True), (517, 200, 26, 16, 200, False), (301, 7, 5, 5, 9, False), (64, 3, 2, 4, 1, False)],
    ids=["layer1", "layer2", "odd", "tiny"],
)
def test_cin_kernels_match_plain(B, Hk, F, D, Hn, same):
    """K13d against its plain version on the card: out, dx_k, dx_0 and dw
    each within 1e-5 of the sum of their terms' magnitudes plus 1e-6
    (float32 sums over Hk * F pairs, Hn maps or B * D columns in another
    order, and atomics in the backward); x_k may be x_0 itself."""
    _require_cuda()
    g = torch.Generator().manual_seed(B)
    xk, x0, w, grad = (t.cuda() for t in _cin_inputs(g, B, Hk, F, D, Hn, same))
    kernels.reset_launches()
    out = kcin.cin_fwd(xk, x0, w)
    dxk, dx0, dw = kcin.cin_bwd(xk, x0, w, grad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cin_fwd"] == 1 and kernels.LAUNCHES["cin_bwd"] == 1
    want = kcin.cin_fwd_plain(xk, x0, w)
    assert _within_terms(out, want, kcin.cin_fwd_plain(xk.abs(), x0.abs(), w.abs()))
    wants = kcin.cin_bwd_plain(xk, x0, w, grad)
    mags = kcin.cin_bwd_plain(xk.abs(), x0.abs(), w.abs(), grad.abs())
    for name, got, want, mag in zip(("dx_k", "dx_0", "dw"), (dxk, dx0, dw), wants, mags):
        assert _within_terms(got, want, mag), (name, float((got - want).abs().max()))


def test_cin_layer_autograd_sums_both_gradients_when_x_k_is_x_0():
    """xdeepfm_outer_product(x, x, w) through the kernels: x's gradient is
    dx_k + dx_0 (the plain layer's autograd on the same inputs, 1e-5 of the
    terms' magnitudes)."""
    _require_cuda()
    g = torch.Generator().manual_seed(3)
    x, _, w, grad = (t.cuda() for t in _cin_inputs(g, 999, 6, 6, 8, 12, True))
    x, w = x.requires_grad_(True), w.requires_grad_(True)
    kernels.reset_launches()
    models.xdeepfm_outer_product(x, x, w).backward(grad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cin_fwd"] == 1 and kernels.LAUNCHES["cin_bwd"] == 1
    xp, wp = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    kcin.cin_fwd_plain(xp, xp, wp).backward(grad)
    xm, wm = x.detach().abs().requires_grad_(True), w.detach().abs().requires_grad_(True)
    kcin.cin_fwd_plain(xm, xm, wm).backward(grad.abs())
    assert _within_terms(x.grad, xp.grad, xm.grad) and _within_terms(w.grad, wp.grad, wm.grad)


def test_new_layer_kernels_take_empty_inputs_and_the_current_stream():
    """No rows: empty outputs and zero gradients, nothing launched where
    there is nothing to launch; on a side stream the kernels follow the
    stream they are launched on."""
    _require_cuda()
    kernels.reset_launches()
    empty_v, empty_m = torch.zeros((0, 4), dtype=torch.int32, device="cuda"), torch.zeros((0, 4), device="cuda")
    local = torch.randn((6, 64), device="cuda")
    assert kbag.range_bag(local, empty_v, empty_m, 6, 24, 1).shape == (0, 64)
    assert not bool(kbag.range_bag_grad(torch.zeros((0, 64), device="cuda"), empty_v, empty_m, 6, 6, 24).any())
    assert kint.interaction_fwd(torch.zeros((0, 5, 8), device="cuda"), self_interaction=True).shape == (0, 15)
    xk, x0, w = torch.zeros((0, 3, 4), device="cuda"), torch.zeros((0, 2, 4), device="cuda"), torch.ones((6, 5), device="cuda")
    assert kcin.cin_fwd(xk, x0, w).shape == (0, 5, 4)
    dxk, dx0, dw = kcin.cin_bwd(xk, x0, w, torch.zeros((0, 5, 4), device="cuda"))
    assert dxk.shape == (0, 3, 4) and dx0.shape == (0, 2, 4) and not bool(dw.any())
    torch.cuda.synchronize()
    assert sum(v for k, v in kernels.LAUNCHES.items() if k not in ("range_bag_grad", "cin_bwd")) == 0
    g = torch.Generator().manual_seed(9)
    local, values, mask, start = _bag_shard(g, 40_001, 4, 24, 4, 1, 64)
    xk, x0, w, grad = _cin_inputs(g, 777, 9, 7, 16, 33, False)
    bag_grad = torch.randn((40_001, 64), generator=g)
    dev = [t.cuda() for t in (local, values, mask, xk, x0, w, grad, bag_grad)]
    x = torch.randn((3001, 27, 16), generator=g)
    dx_in = x.cuda()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        bag = kbag.range_bag(dev[0], dev[1], dev[2], start, 24, 1)
        bgrad = kbag.range_bag_grad(dev[7], dev[1], dev[2], start, 6, 24)
        inter = kint.interaction_fwd(dx_in, self_interaction=True)
        out = kcin.cin_fwd(dev[3], dev[4], dev[5])
        cgrads = kcin.cin_bwd(dev[3], dev[4], dev[5], dev[6])
    side.synchronize()
    assert torch.equal(bag.cpu(), kbag.range_bag_plain(local, values, mask, start, 24, 1))
    want_bgrad = kbag.range_bag_grad_plain(bag_grad, values, mask, start, 6, 24)
    assert _within_terms(bgrad.cpu(), want_bgrad, kbag.range_bag_grad_plain(bag_grad.abs(), values, mask, start, 6, 24))
    torch.testing.assert_close(inter.cpu(), kint.interaction_fwd_plain(x, True), rtol=1e-5, atol=1e-5)
    assert _within_terms(out.cpu(), kcin.cin_fwd_plain(xk, x0, w), kcin.cin_fwd_plain(xk.abs(), x0.abs(), w.abs()))
    mags = kcin.cin_bwd_plain(xk.abs(), x0.abs(), w.abs(), grad.abs())
    for got, want, mag in zip(cgrads, kcin.cin_bwd_plain(xk, x0, w, grad), mags):
        assert _within_terms(got.cpu(), want, mag)


def _multihot_dlrm(seed=1, **kw):
    config = models.DLRMConfig({"a": 3, "b": 500, "c": 40_000}, num_dense=13, embedding_dim=16,
                               multihot_cardinalities={"g": 23, "m": 5000}, multihot_max_len=4, **kw)
    batch = {k: torch.from_numpy(v) for k, v in models.make_synthetic_batch(config, 4096, seed=2).items()}
    batch["g__values"][:2, 0] = torch.tensor([-1, -23], dtype=torch.int32)  # wraps
    return config, batch


def test_multihot_dlrm_step_through_kernels_matches_plain_reference():
    """One DLRM loss and gradient with two multihot tables through the
    kernels (one K13a gather and scatter, one K13c bag forward and backward
    per multihot table, K13b once each) against models.reference_forward on
    the card, in float32 compute: only summation orders differ (rtol 1e-4 on
    the loss and the logits; gradients within 1e-4 of their largest
    entry)."""
    _require_cuda()
    config, batch = _multihot_dlrm()
    model = models.DLRM(config, seed=1, compute_dtype=torch.float32)
    batch = {k: v.cuda() for k, v in batch.items()}
    kernels.reset_launches()
    logits = model(batch)
    loss = models.bce_with_logits(logits, batch["label"])
    loss.backward()
    torch.cuda.synchronize()
    want = {"embedding_gather": 1, "embedding_scatter_grad": 1, "embedding_bag_fwd": 2, "embedding_bag_bwd": 2,
            "interaction_fwd": 1, "interaction_bwd": 1}
    assert kernels.LAUNCHES == {k: want.get(k, 0) for k in kernels.LAUNCHES}
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    ref_logits = models.reference_forward(model, batch)
    ref_loss = models.bce_with_logits(ref_logits, batch["label"])
    ref_loss.backward()
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=1e-6)
    for (name, p), got in zip(model.named_parameters(), grads):
        assert float((got - p.grad).abs().max()) <= 1e-4 * float(p.grad.abs().max()), name


def test_sharded_multihot_step_on_one_rank_nccl_matches_unsharded(tmp_path):
    """A one-rank NCCL group on the card: shard_params, shard_batch and
    make_train_step take three Adagrad steps of a DLRM with two multihot
    tables through K15d and its bag (one range_gather_columns,
    range_scatter_grad a step, one range_bag and range_bag_grad a multihot
    table a step, no K13a or K13c) from the parameters of an unsharded DLRM
    that takes the same steps through K13a and K13c: losses within rtol
    1e-5, tables and MLPs within 1e-5 (atomics in varying orders)."""
    _require_cuda()
    import torch.distributed as dist

    from nvtabular_tpu_torch import parallel

    config, batch = _multihot_dlrm(vocab_pad_multiple=4)
    want_model = models.DLRM(config, seed=1)
    want_opt = models.Adagrad(want_model.parameters())
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    want = [float(models.train_step(want_model, want_opt, dev_batch)) for _ in range(3)]
    parallel.initialize_distributed("nccl", f"file://{tmp_path / 'store'}", 0, 1, timeout=120)
    try:
        mesh = parallel.local_mesh()
        model = models.DLRM(config, seed=1)
        p_specs, b_specs = models.dlrm_param_specs(model), models.batch_specs(config)
        parallel.shard_params(model, p_specs, mesh)
        opt = models.Adagrad(model.parameters())
        step = parallel.make_train_step(models.dlrm_loss, opt, mesh=mesh, param_specs=p_specs, batch_specs=b_specs)
        local = parallel.shard_batch(batch, b_specs, mesh)
        kernels.reset_launches()
        got = [float(step(model, opt, local)) for _ in range(3)]
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        dist.destroy_process_group()
    assert launches == {**{k: 0 for k in launches}, "range_gather_columns": 3, "range_scatter_grad": 3,
                        "range_bag": 6, "range_bag_grad": 6, "interaction_fwd": 3, "interaction_bwd": 3}
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for (name, p), q in zip(model.named_parameters(), want_model.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-5, msg=name)


# --- K5's new modes, K11c and the session path ---------------------------------------------
def _chain_inputs(rng, n=100_003):
    x = rng.normal(1.0, 3.0, (5, n)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[:, :4] = [65504.0, 1e-8, -0.0, np.inf]  # float16's largest, a subnormal, -0, inf
    params = torch.tensor([[0.25, 0.0, 70000.0, 0.4375, 1.5]] * 4 + [[0.0, 0.0, 0.0, 0.0, 0.0]], dtype=torch.float32)
    return torch.from_numpy(x), params


@pytest.mark.parametrize("log", [False, True], ids=["no_log", "log1p"])
@pytest.mark.parametrize("store", [torch.float16, torch.bfloat16, torch.float32])
def test_cont_chain_16bit_store_and_zero_span_match_plain(store, log):
    """Median fill, clip, optional log1p, then min-max with a 16-bit store
    (the last column a zero span: all zeros, NaN included). Without log1p
    the kernel equals its plain version on the card bit for bit; with it,
    within the store type's relative spacing (one to two ULPs: the kernel's
    log1pf and PyTorch's log1p may differ by a float32 ULP before the cast)."""
    _require_cuda()
    x, params = _chain_inputs(np.random.default_rng(31))
    flags = [kcc.FILL | kcc.LO | kcc.HI | (kcc.LOG if log else 0) | kcc.NORM] * 4 + [kcc.FILL | kcc.ZERO]
    flags = torch.tensor(flags, dtype=torch.int32).cuda()
    xc, pc = x.cuda(), params.cuda()
    kernels.reset_launches()
    got = kcc.cont_chain(xc, None, pc, flags, store)
    want = kcc.cont_chain_plain(xc, None, pc, flags, store)
    torch.cuda.synchronize()
    assert got.dtype == store and kernels.LAUNCHES["cont_chain_16" if store != torch.float32 else "cont_chain"] == 1
    assert bool((got[4] == 0).all())
    if not log:
        assert torch.equal(got.float().isnan(), want.float().isnan())
        assert torch.equal(torch.nan_to_num(got.float()), torch.nan_to_num(want.float()))
    else:
        ulp = {torch.float16: 2.0**-10, torch.bfloat16: 2.0**-7, torch.float32: 2.0**-23}[store]
        torch.testing.assert_close(got.float(), want.float(), rtol=ulp, atol=1e-7, equal_nan=True)


@pytest.mark.parametrize("with_validity", [False, True])
def test_cont_chain_mask_matches_plain(with_validity):
    _require_cuda()
    rng = np.random.default_rng(32)
    x, params = _chain_inputs(rng)
    validity = torch.from_numpy(rng.random(x.shape) > 0.1).cuda() if with_validity else None
    flags = torch.full((5,), kcc.FILL, dtype=torch.int32).cuda()
    xc, pc = x.cuda(), params.cuda()
    kernels.reset_launches()
    got, got_mask = kcc.cont_chain(xc, validity, pc, flags, with_mask=True)
    want, want_mask = kcc.cont_chain_plain(xc, validity, pc, flags, with_mask=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cont_chain_mask"] == 1 and got_mask.dtype == torch.bool
    assert torch.equal(got_mask, want_mask) and torch.equal(got, want)


def _ragged_case(rng, rows, total, head_share, empty_share=0.1):
    """Row lengths with one row holding ``head_share`` of ``total`` values
    and ``empty_share`` of the rows empty."""
    weights = rng.pareto(1.2, rows) * (rng.random(rows) > empty_share)
    weights[rows // 3] = 0.0
    lengths = np.floor(weights / max(weights.sum(), 1e-9) * total * (1 - head_share)).astype(np.int64)
    lengths[rows // 3] = int(total * head_share)
    offsets = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    values = (rng.integers(1, 11, int(offsets[-1])) / 2.0).astype(np.float32)
    values[rng.random(len(values)) < 1e-4] *= -1.0
    return values, offsets


def _float64_reduce(values, offsets, num_rows, combiner):
    v, off = torch.from_numpy(values.astype(np.float64)), torch.from_numpy(offsets)
    row = torch.searchsorted(off[1:], torch.arange(len(v)), right=True)
    keep = row < num_rows
    s = torch.zeros(num_rows, dtype=torch.float64).index_add_(0, row[keep], v[keep])
    a = torch.zeros(num_rows, dtype=torch.float64).index_add_(0, row[keep], v[keep].abs())
    if combiner == "mean":
        n = (off[1:] - off[:-1]).clamp(min=1).double()
        return s / n, a / n
    return s, a


@pytest.mark.parametrize("combiner", ["sum", "mean", "min", "max"])
@pytest.mark.parametrize(
    "case", ["head_row_holds_most", "many_short_rows", "nan_and_tails"],
)
def test_ragged_segment_reduce_matches_plain(case, combiner):
    """min and max bit for bit (NaN where the row holds one, ±inf for an
    empty row); sum and mean within 1e-5 of the float64 sum of |v| of the
    row (float32 sums, each in its own order: the kernel's tree of 8-value
    runs, block scans and one atomic a block, the plain version's
    index_add_)."""
    _require_cuda()
    rng = np.random.default_rng({"head_row_holds_most": 40, "many_short_rows": 41, "nan_and_tails": 42}[case])
    if case == "head_row_holds_most":
        values, offsets = _ragged_case(rng, 5_000, 3_000_000, 0.8)
    elif case == "many_short_rows":
        values, offsets = _ragged_case(rng, 400_000, 1_200_000, 0.0, empty_share=0.3)
    else:
        values, offsets = _ragged_case(rng, 3_000, 200_000, 0.2)
        values[rng.random(len(values)) < 1e-3] = np.nan
        values = np.concatenate([values, np.ones(5000, np.float32)])  # past offsets[-1]
    rows = len(offsets) - 1
    num_rows = rows + 1 if case == "nan_and_tails" and combiner != "mean" else rows
    v, off = torch.from_numpy(values).cuda(), torch.from_numpy(offsets).cuda()
    kernels.reset_launches()
    got = kragged.ragged_segment_reduce(v, off, num_rows, combiner)
    want = kragged.ragged_segment_reduce_plain(v, off, num_rows, combiner)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ragged_segment_reduce"] == 1 and got.shape == (num_rows,)
    if combiner in ("min", "max"):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got, posinf=1e30, neginf=-1e30),
                           torch.nan_to_num(want, posinf=1e30, neginf=-1e30))
        return
    exact, scale = _float64_reduce(values, offsets, num_rows, combiner)
    nan = torch.isnan(exact)
    for out in (got.cpu().double(), want.cpu().double()):
        assert torch.equal(out.isnan(), nan)
        assert bool(((out - exact).abs()[~nan] <= 1e-5 * scale[~nan] + 1e-6).all())


def test_ragged_segment_reduce_takes_empty_inputs():
    _require_cuda()
    kernels.reset_launches()
    empty = torch.empty(0, dtype=torch.float32, device="cuda")
    out = kragged.ragged_segment_reduce(empty, torch.zeros(4, dtype=torch.int64, device="cuda"), 3, "min")
    assert torch.equal(out.cpu(), torch.full((3,), float("inf")))
    out = kragged.ragged_segment_reduce(torch.ones(5, device="cuda"), torch.zeros(1, dtype=torch.int64,
                                                                                   device="cuda"), 0, "sum")
    assert out.shape == (0,)


def _session_parts(n_parts=3, rows=20_000):
    parts = []
    for seed in range(n_parts):
        r = np.random.default_rng(50 + seed)
        ts = r.exponential(86400.0, rows).astype(np.float32)
        ts[r.random(rows) < 0.01] = np.nan
        parts.append({
            "userId": r.zipf(1.2, rows).clip(1, 5000).astype(np.int64),
            "movieId": r.zipf(1.1, rows).clip(1, 9000).astype(np.int64),
            "rating": (r.integers(1, 11, rows) / 2.0).astype(np.float32),
            "ts_delta": ts,
        })
    return parts


def _session_graph():
    aggs = {"movieId": ["list", "count"], "rating": ["list", "sum", "mean", "min", "max"],
            "ts_delta": ["first", "last"]}
    g = (["userId", "movieId", "rating", "ts_delta"] >> ops.Dropna()
         >> ops.Filter(lambda b: np.asarray(b["rating"]) >= 3.0)
         >> ops.Groupby("userId", sort_cols=["ts_delta"], aggs=aggs))
    names = ["userId", "movieId_list", "movieId_count", "rating_list", "rating_sum", "rating_mean", "rating_min",
             "rating_max", "ts_delta_first", "ts_delta_last"]
    vc = g[names] >> ops.ValueCount()
    return vc[[c for c in names if c != "movieId_list"]] + (vc["movieId_list"] >> ops.ListSlice(-20, pad=True))


def test_session_path_on_cuda_matches_cpu():
    """shuffle_by_keys (K7 on the card) → Dropna → Filter → Groupby →
    ValueCount → ListSlice(-20, pad=True) (K11b): every partition equal to
    the CPU run, floats included (both are the same host numpy)."""
    _require_cuda()
    parts = _session_parts()
    kernels.reset_launches()
    shuffled = nvt.Dataset(parts).shuffle_by_keys(["userId"])
    assert kernels.LAUNCHES["hashed_cross"] == len(parts)
    cpu_shuffled = nvt.Dataset(parts).shuffle_by_keys(["userId"], device="cpu")
    wf = nvt.Workflow(_session_graph())
    outs = list(wf.fit_transform(shuffled).to_batches())
    cpu_wf = nvt.Workflow(_session_graph(), device="cpu")
    cpu_outs = list(cpu_wf.fit_transform(cpu_shuffled).to_batches())
    assert len(outs) == len(cpu_outs) == len(parts)
    for got, want in zip(outs, cpu_outs):
        assert got.column_names == want.column_names
        for name in want.column_names:
            g, w = got[name], want[name]
            assert torch.equal(g.values.isnan() if g.values.is_floating_point() else g.values,
                               w.values.isnan() if w.values.is_floating_point() else w.values), name
            assert torch.equal(torch.nan_to_num(g.values.float()), torch.nan_to_num(w.values.float())), name
            assert (g.offsets is None) == (w.offsets is None)
            assert g.offsets is None or torch.equal(g.offsets, w.offsets), name
    for got in outs:
        lists = got["rating_list"]
        for combiner in ("sum", "mean", "min", "max"):
            red = kragged.ragged_segment_reduce(lists.values.cuda(), lists.offsets.cuda(), len(lists), combiner)
            ref = got[f"rating_{combiner}"].values
            if combiner in ("min", "max"):
                assert torch.equal(red.cpu(), ref), combiner
            else:
                torch.testing.assert_close(red.cpu(), ref, rtol=1e-6, atol=1e-5)


def test_new_chains_on_cuda_count_one_launch_a_batch():
    """FillMedian → Clip → LogOp → NormalizeMinMax(float16) is one
    cont_chain_16 launch a batch; FillMissing(add_binary_cols=True) one
    cont_chain_mask launch a batch; the outputs match the CPU run (float16
    within rtol=2^-10, one to two ULPs; masks exact)."""
    _require_cuda()
    rng = np.random.default_rng(33)
    parts = []
    for _ in range(3):
        x = rng.normal(1.0, 3.0, (3, 30_000)).astype(np.float32)
        x[rng.random(x.shape) < 0.05] = np.nan
        parts.append({f"I{i}": x[i] for i in range(3)})
    conts = ["I0", "I1", "I2"]
    for graph, mode in [
        (lambda: conts >> ops.FillMedian() >> ops.Clip(min_value=0.0) >> ops.LogOp()
         >> ops.NormalizeMinMax(out_dtype="float16"), "cont_chain_16"),
        (lambda: conts >> ops.FillMissing(add_binary_cols=True), "cont_chain_mask"),
    ]:
        wf = nvt.Workflow(graph())
        wf.fit(nvt.Dataset(parts))
        kernels.reset_launches()
        outs = [wf.transform(nvt.TableBatch.from_pydict(p)) for p in parts]
        torch.cuda.synchronize()
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {mode: len(parts)}
        cpu_wf = nvt.Workflow(graph(), device="cpu")
        nvt.load_fitted_state(cpu_wf, nvt.fitted_state(wf))
        want = cpu_wf.transform(nvt.TableBatch.from_pydict(parts[0]))
        assert outs[0].column_names == want.column_names
        for name in want.column_names:
            g, w = outs[0][name].values.cpu(), want[name].values
            assert g.dtype == w.dtype
            if g.dtype == torch.bool:
                assert torch.equal(g, w)
            else:
                torch.testing.assert_close(g.float(), w.float(), rtol=2.0**-10, atol=1e-7, equal_nan=True)
