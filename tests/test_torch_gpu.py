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
from nvtabular_tpu_torch.kernels import lookup as klk
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


@pytest.mark.parametrize(
    "F,D,B,lead",
    [(27, 16, 1001, 16), (5, 8, 1001, 8), (2, 3, 1001, 3), (27, 16, 65_537, 3), (28, 12, 4099, 5), (26, 20, 999, 1),
     (4, 64, 70_001, 64), (33, 24, 2053, 7)],
    ids=["27-16", "5-8", "2-3", "dlrm_many_groups_odd_offset", "f28_d12", "f26_d20", "f4_d64", "f33_d24"],
)
def test_interaction_kernels_match_plain(F, D, B, lead):
    """rtol 1e-5, atol 1e-5: float32 sums of D (forward) or F - 1 (backward)
    products in another order than cuBLAS's and autograd's. B is no multiple
    of the backward's samples a group or of its persistent grid's groups;
    the gradient rows follow a lead of `lead` floats (4-byte aligned where
    it is odd, as in DLRM's [B, D + P] buffer); D takes 4 columns a thread
    or the scalar path, F one to five row blocks of 8, and G (bwd_plan) 21,
    12 and 8 samples, no multiple of a warp's."""
    _require_cuda()
    g = torch.Generator().manual_seed(2)
    P = F * (F - 1) // 2
    x = torch.randn((B, F, D), generator=g)
    grad = torch.randn((B, P), generator=g)
    want = kint.interaction_fwd(x)
    want_dx = kint.interaction_bwd(x, grad)
    xc = x.cuda()
    buf = torch.zeros((B, D + P), device="cuda")
    kernels.reset_launches()
    kint.interaction_fwd(xc, out=buf[:, D:])
    gbuf = torch.zeros((B, lead + P), device="cuda")
    gbuf[:, lead:] = grad.cuda()
    got_dx = kint.interaction_bwd(xc, gbuf[:, lead:])
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
    ref_loss = models.bce_with_logits(ref_logits, batch["label"], plain=True)
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
    ref = models.bce_with_logits(models.tabular_reference_forward(model, batch).reshape(-1), batch["label"],
                                 plain=True)
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


def _direct_edge_case(rng, C, n):
    """A bin of direct maps (1 key; 300,000 keys ending at INT32_MAX; every
    third key from INT32_MIN; 62,000 keys with holes) and C value rows over
    them, several rows on one table row: hits, misses across int32 (v - min
    past int32 where a table lies at the other end), the extremes."""
    keysets = [
        np.array([5], np.int64),
        np.arange(I32_MAX - 299_999, I32_MAX + 1, dtype=np.int64),
        np.arange(I32_MIN, I32_MIN + 15_000, 3, dtype=np.int64),
        np.sort(rng.choice(np.arange(1_000, 80_000), 62_000, replace=False)).astype(np.int64),
    ]
    direct = plookup.BatchedDirect([plookup.build_direct(k, rng.permutation(len(k)) + 3) for k in keysets])
    assert [int(x) for x in direct.lens] == [1, 300_000, 14_998, int(keysets[3][-1] - keysets[3][0] + 1)]
    sel = [(3 * c + 1) % len(keysets) for c in range(C)]
    return direct, _queries(rng, [keysets[s] for s in sel], n), torch.tensor(sel, dtype=torch.int32)


def _offset_view(t: torch.Tensor, by: int = 1) -> torch.Tensor:
    """A contiguous copy of t that starts ``by`` elements into a buffer: no
    longer 16-byte aligned."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    view = buf[by:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("codes", ["categorify", "group_index", "hashed"])
@pytest.mark.parametrize("with_validity", [False, True])
@pytest.mark.parametrize("C", [1, 70])
def test_direct_lookup_kernel_matches_plain_at_its_edges(C, with_validity, codes, aligned):
    """K2's codes torch.equal to direct_lookup_plain's: tables of 1 and
    300,000 keys, a table row shared by several value rows, keys at
    INT32_MIN and INT32_MAX, misses; Categorify's codes, a group index's
    (num_groups for miss and null, no offsets) and hashed misses
    (nbuckets 1000, 1, 2**31 - 1, 7); C = 1 (the solo branch's shape) and
    70 columns; N = 100,003 (no multiple of 4, so the persistent grid's
    segments start unaligned), and values, validity at offset views."""
    _require_cuda()
    rng = np.random.default_rng(C + 2 * with_validity)
    n = 100_003
    direct, values, sel = _direct_edge_case(rng, C, n)
    validity = torch.from_numpy(rng.random(values.shape) > 0.1) if with_validity else None
    miss, null = (123_457, 123_457) if codes == "group_index" else (2, 1)
    offs = torch.tensor([0 if codes == "group_index" else 11 * c for c in range(C)], dtype=torch.int32)
    nbs = torch.tensor(([1000, 1, 2**31 - 1, 7] * C)[:C], dtype=torch.int32) if codes == "hashed" else None
    dev = direct.to("cuda")
    dv = values.cuda() if aligned else _offset_view(values.cuda())
    dvalid = None if validity is None else (validity.cuda() if aligned else _offset_view(validity.cuda(), 3))
    args = (dv, dvalid, dev.table, dev.mins, dev.maxs, dev.lens, dev.offsets, sel.cuda(), offs.cuda(), miss, null,
            None if nbs is None else nbs.cuda())
    counter = "direct_lookup_solo" if C == 1 else None
    kernels.reset_launches()
    got = klk.direct_lookup(*args, counter=counter)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[counter or "direct_lookup"] == 1
    want = klk.direct_lookup_plain(values, validity, direct.table, direct.mins, direct.maxs, direct.lens,
                                   direct.offsets, sel, offs, miss, null, nbs)
    assert torch.equal(got.cpu(), want)
    if codes == "hashed":
        assert len(torch.unique(want[0][(want[0] >= 2) & (want[0] < 1002)])) > 900


def _float_probe(rng, keys, n):
    miss = rng.normal(0.0, 50.0, n).astype(np.float32)
    v = np.where(rng.random(n) < 0.3, miss, rng.choice(keys, n) if len(keys) else miss).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-40, -1e-40, np.float32(-1e30), np.float32(1e30)]
    v[: len(special)] = special
    if len(keys):
        v[len(special):len(special) + 2] = [np.min(keys), np.max(keys)]
        v[len(special) + 2:len(special) + 4] = [np.nextafter(np.min(keys), -np.inf), np.nextafter(np.max(keys), np.inf)]
    return v


def _fence_probes(table, b):
    """Row b's fences (each window's first key) and the float32 values just
    below and just above each."""
    n = int(table.lens[b])
    if n == 0:
        return np.zeros(0, np.float32)
    start, shift = int(table.starts[b]), int(table.fence_shifts[b])
    base = start - start % 4
    count = (start - base + n + (1 << shift) - 1) >> shift
    f = table.keys.numpy()[np.maximum(base + (np.arange(count) << shift), start)]
    return np.concatenate([f, np.nextafter(f, -np.inf), np.nextafter(f, np.inf)]).astype(np.float32)


@pytest.mark.parametrize("nb", [1, 1000])
@pytest.mark.parametrize("with_validity", [False, True])
def test_sorted_lookup_kernel_matches_plain(with_validity, nb):
    """K8 against its plain version: NaN, ±inf, signed zeros, subnormals,
    values below the smallest key and above the largest, vocabularies of
    length 0, 1 and many (one with ±inf and both zeros among its keys);
    a vocabulary of over 2M keys (past FENCE_MAX windows of 4: wider
    windows), runs of equal float32 keys across window edges, -0.0 and 0.0
    side by side at every offset from a window's edge, rows whose length is
    no multiple of their window, and every fence with its float32
    neighbours below and above as values."""
    _require_cuda()
    rng = np.random.default_rng(17)
    vocabs = [
        np.unique(rng.normal(0.0, 30.0, 20_000).round(2)),
        np.zeros(0),
        np.array([0.5]),
        np.array([np.inf, -np.inf, 0.0, -0.0, 1.0, 1.0 + 2.0**-40, 1e-40, 3.5]),
        np.unique(rng.normal(0.0, 1e3, 2_100_000)),  # float64 keys: some share a float32
        np.repeat(np.arange(3000.0), 6) + np.tile(np.arange(6) * 2.0**-40, 3000),  # runs of 6 equal float32
    ] + [np.concatenate([-np.arange(1.0, 100.0 + r), [-0.0, 0.0], np.arange(1.0, 50.0)]) for r in range(8)]
    luts = [plookup.SortedLookup(rng.permutation(v), np.arange(len(v)) + 2 + nb) for v in vocabs]
    table = plookup.BatchedSorted(luts)
    starts, lens, shifts = table.starts.numpy(), table.lens.numpy(), table.fence_shifts.numpy()
    assert lens[4] > 2_000_000 and shifts[4] > klk.FENCE_MIN_SHIFT
    assert any(n % (1 << k) for n, k in zip(lens, shifts) if n)
    # the second zero's slot from its window's edge (windows start at base = start - start % 4)
    zero_edges = [(starts[b] % 4 + 100 + r) % (1 << shifts[b]) for b, r in zip(range(6, 14), range(8))]
    assert set(zero_edges) == {0, 1, 2, 3}  # the pair straddles a window edge in some rows
    sel = [0, 1, 2, 3, 0] + list(range(4, 14))
    n = 100_003
    rows = []
    for s in sel:
        v = _float_probe(rng, vocabs[s].astype(np.float32), n)
        fp = _fence_probes(table, s)[: n - 20]
        v[20 : 20 + len(fp)] = fp
        rows.append(v)
    values = torch.from_numpy(np.stack(rows))
    validity = torch.from_numpy(rng.random(values.shape) > 0.1) if with_validity else None
    sel_t = torch.tensor(sel, dtype=torch.int32)
    offs = torch.tensor([5 * i for i in range(len(sel))], dtype=torch.int32)
    nbs = torch.full((len(sel),), nb, dtype=torch.int32)
    want = table.encode(values, validity, sel_t, offs, nbuckets=nbs)
    kernels.reset_launches()
    got = table.to("cuda").encode(values.cuda(), None if validity is None else validity.cuda(), sel_t.cuda(),
                                  offs.cuda(), nbuckets=nbs.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sorted_lookup"] == 1
    assert torch.equal(got.cpu(), want)
    assert (want[1] < 2 + nb + 5).all()  # the empty vocabulary: OOV or null only
    assert (want[:, 0] == torch.tensor([1 + 5 * i for i in range(len(sel))], dtype=torch.int32)).all()  # NaN
    hits = want - offs[:, None] >= 2 + nb
    assert hits[5].sum() > 10_000 and hits[6].sum() > 10_000  # the long and the run vocabularies are hit


def _stash_tables(rng):
    """Stash tables over 200,000, 7 and 30,000 keys and one of 60,000 keys
    whose primary is over-full (load 2): the first and the last spill."""
    sizes_loads = [(200_000, 0.5), (7, 0.5), (30_000, 0.05), (60_000, 2.0)]
    keysets = [rng.permutation(np.unique(rng.integers(I32_MIN, I32_MAX, n))).astype(np.int32)
               for n, _ in sizes_loads]
    luts = [plookup.build_stash(k, np.arange(len(k)) + 3, load) for k, (_, load) in zip(keysets, sizes_loads)]
    assert [l.nbs > 0 for l in luts] == [True, False, False, True]
    return keysets, luts


@pytest.mark.parametrize("nb", [1, 1000])
@pytest.mark.parametrize("with_validity", [False, True])
def test_stash_lookup_kernel_matches_plain(with_validity, nb):
    """K6 on stashed and stashless tables (sel repeats a row), every key of
    each table among 200,003 values a column with misses and the int32
    extremes, nulls, hashed OOV buckets and column offsets: bit-equal to the
    plain version; one launch; a table alone (one row) as a solo vocabulary
    encodes it."""
    _require_cuda()
    rng = np.random.default_rng(15)
    keysets, luts = _stash_tables(rng)
    sel = [3, 0, 1, 2, 0]
    values = _queries(rng, [keysets[s] for s in sel], 200_003)
    values[1, : len(keysets[0])] = torch.from_numpy(keysets[0])
    validity = torch.from_numpy(rng.random(values.shape) > 0.1) if with_validity else None
    args = (torch.tensor(sel, dtype=torch.int32), torch.tensor([0, 9, 200_000, 230_000, 5], dtype=torch.int32))
    nbuckets = torch.tensor([nb, 1, nb, nb, 1], dtype=torch.int32)
    blut = plookup.BatchedStash(luts)
    want = blut.encode(values, validity, *args, nbuckets=nbuckets)
    cuda = blut.to("cuda")
    kernels.reset_launches()
    got = cuda.encode(values.cuda(), None if validity is None else validity.cuda(), *(a.cuda() for a in args),
                      nbuckets=nbuckets.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stash_lookup"] == 1 and sum(kernels.LAUNCHES.values()) == 1
    assert torch.equal(got.cpu(), want)
    solo = plookup.BatchedStash(luts[:1])
    one = (torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    got = solo.to("cuda").encode(values[1:2].cuda(), None, *(a.cuda() for a in one))
    assert torch.equal(got.cpu(), solo.encode(values[1:2], None, *one))
    found = got.cpu()[0, : len(keysets[0])]
    assert torch.equal(found.sort().values, torch.arange(len(keysets[0]), dtype=torch.int32) + 3)


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
    want |= {"embedding_gather": 1, "embedding_scatter_grad": 1, **_step_launches(model)}
    assert kernels.LAUNCHES == {k: want.get(k, 0) for k in kernels.LAUNCHES}
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    ref_logits = reference(model, batch)
    ref_loss = models.bce_with_logits(ref_logits, batch["label"], plain=True)
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


def _sort_cases(n, case, rng):
    """int32 keys for the onesweep sort's edge cases."""
    if case == "power_law":
        return _exchange_keys(n, seed=n)
    if case == "equal":  # every pass trivial: the keys are copied
        return torch.full((n,), -7, dtype=torch.int32)
    if case == "extremes":
        keys = rng.choice(np.array([I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1, 0, -1], np.int32), n)
        return torch.from_numpy(keys.astype(np.int32))
    if case == "pads":  # phase 19's buffer: 60% pads after random ids
        keys = rng.integers(0, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        keys[rng.random(n) < 0.6] = kex.PAD
        return torch.from_numpy(keys)
    if case == "low_digit":  # only the lowest pass runs
        return torch.from_numpy(rng.integers(0, 200, n).astype(np.int32))
    if case == "outer_digits":  # the lowest and the highest byte vary: two passes run at 8 bits
        keys = rng.integers(0, 256, n) | (rng.integers(0, 256, n) << 24)
        return torch.from_numpy(keys.astype(np.uint32).view(np.int32))
    if case == "three_passes":  # byte 2 constant: three passes of 8 bits run, the first writes out
        keys = rng.integers(0, 1 << 16, n) | (0x5A << 16) | (rng.integers(0, 256, n) << 24)
        return torch.from_numpy(keys.astype(np.uint32).view(np.int32))
    raise ValueError(case)


@pytest.mark.parametrize("case", ["power_law", "equal", "extremes", "pads", "low_digit", "outer_digits",
                                  "three_passes"])
@pytest.mark.parametrize("n", [1, 2, kex.SORT_TILE - 1, kex.SORT_TILE, kex.SORT_TILE + 1, (1 << 20) + 3])
def test_onesweep_sort_matches_plain_and_torch_sort(n, case):
    """The onesweep sort at a tile's edges and past a million keys: bit-equal
    to the plain passes and to torch.sort, with passes skipped where one
    digit holds every key (all, none, some)."""
    _require_cuda()
    keys = _sort_cases(n, case, np.random.default_rng(n + len(case)))
    kernels.reset_launches()
    got = kex.radix_sort(keys.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["radix_sort"] == 1
    assert torch.equal(got.cpu(), kex.radix_sort_plain(keys))
    assert torch.equal(got.cpu(), torch.sort(keys).values)


def test_onesweep_sort_refuses_more_keys_than_a_status_word_counts():
    """A look-back status word holds a 30-bit count: 2**30 keys raise, on
    the card as on the CPU, before anything is allocated or launched."""
    _require_cuda()
    keys = torch.empty(kex.SORT_MAX_KEYS + 1, dtype=torch.int32, device="cuda")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="30-bit count"):
        kex.radix_sort(keys)
    assert kernels.LAUNCHES["radix_sort"] == 0
    del keys
    torch.cuda.empty_cache()


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
@pytest.mark.parametrize("D, B", [(16, 4099), (5, 4099), (16, 65536), (64, 65536)])
def test_range_column_kernels_match_plain(D, B, model_rank):
    """K15d on model shard 1 of 4 (and shard 0, which writes the NaN rows)
    of 26 padded tables, with float4 (D = 16, 64) and scalar (D = 5)
    accesses, the last column's every id on one row of the shard: the
    gather bit-equal to its plain version, NaN where it has NaN; the
    scatter-add within 1e-5 of the sum of its terms' magnitudes (atomics
    and the warps' sums of equal rows add in a varying order), from a
    strided view of the gradient."""
    _require_cuda()
    g = torch.Generator().manual_seed(D + model_rank)
    cards = [3, 40, 1001, 7, 60_000, 5, 200, 12_345] * 3 + [4, 90]
    local, ids, offsets, sizes, starts, padded = _shard_columns(g, B, cards, 4, model_rank, D)
    ids[-1][:] = starts[-1] + 3  # a row this rank holds, hit by every id of the column
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
def _bag_shard(g, B, L, vp, M, m, D, hot=False):
    """Shard m of M of a padded [vp, D] multihot table, ids over [-vp - 3,
    vp + 3) (negatives wrap, a few outside the table, some masked) and a
    mask with all-masked rows; `hot`: every id in range is one row of the
    shard, half of them as its negative alias."""
    rows = vp // M
    local = torch.randn((rows, D), generator=g)
    values = torch.randint(-vp - 3, vp + 3, (B, L), generator=g, dtype=torch.int32)
    if hot:
        row = m * rows + rows // 2
        values = torch.where(values.abs() < vp, torch.where(values < 0, row - vp, row), values).to(torch.int32)
    mask = (torch.rand((B, L), generator=g) < 0.8).float()
    mask[0] = 0.0
    mask[5:9] = 0.0
    values[1, 0], mask[1, 0] = vp, 0.0  # masked, no rank's: NaN on model rank 0
    return local, values, mask, m * rows


@pytest.mark.parametrize("combiner", ["mean", "sum"])
@pytest.mark.parametrize("model_rank", [0, 1])
@pytest.mark.parametrize(
    "vp,D,B,hot",
    [(24, 64, 65_536, False), (24, 5, 65_536, False), (40_000, 16, 65_536, False), (112, 64, 4099, False),
     (116, 64, 4099, False), (112, 16, 65_536, False), (24, 64, 65_536, True), (8, 16, 3, False)],
    ids=["genres_shared", "scalar", "global", "copies_at_limit", "global_past_limit", "copies_at_limit_d16",
         "one_hot_row", "three_bags"],
)
def test_range_bag_kernels_match_plain(vp, D, B, hot, model_rank, combiner):
    """K15d's bag on model shard model_rank of 4: the take-mode forward
    bit-equal to its plain version (NaN bags on model rank 0 alone),
    written into a slot of a wider buffer; the backward within 1e-5 of the
    sum of its terms' magnitudes (summed in another order), from a strided
    gradient, with the take rule and the zero rule. Shards of 28 rows (of
    64 or 16 floats) take the largest private copies a block holds
    (bag_grad_plan), 29 rows of 64 and 10,000 rows of 16 the global atomics;
    one row takes every id in `one_hot_row`; B is no multiple of the grid's
    stride over bags."""
    _require_cuda()
    g = torch.Generator().manual_seed(vp + D + model_rank)
    L = 4
    local, values, mask, start = _bag_shard(g, B, L, vp, 4, model_rank, D, hot)
    vec = 4 if D % 4 == 0 else 1
    assert bool(kbag.bag_grad_plan(B, D, local.shape[0], vec)[0]) == (local.shape[0] * D <= 28 * 64)
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


@pytest.mark.parametrize(
    "L,D",
    [(0, 64), (1, 16), (3, 5), (4, 64), (4, 1), (4, 16), (26, 16), (26, 64), (2048, 16), (4500, 5)],
    ids=["L0", "L1", "L3_scalar", "L4_genres", "L4_d1", "L4_d16", "L26_k15b", "L26_d64", "L2048_one_bag_a_tile",
         "L4500_past_a_tile"],
)
def test_range_bag_kernels_match_plain_at_their_edges(L, D):
    """The range bag in both modes, bit-equal to range_bag_plain and
    embedding_range_bag_plain with NaN in the same places: L of 0 to 26, of
    a whole tile's BAG_TILE_IDS ids and past it, D of 1, 5, 16 and 64; for
    each, model ranks 0 and 1 of 4, the shard just inside and just past
    BAG_STAGE_FLOATS (tiles with the shard staged in shared memory, or a
    thread a vector), ids and mask aligned and at offset views, B no
    multiple of a tile's bags; take mode writes into a strided slot of a
    [B, 3, D] buffer and leaves the other slots alone."""
    _require_cuda()
    B = 37 if L > 100 else 10_007
    inside = kbag.BAG_STAGE_FLOATS // D
    for m, rows, aligned in [(m, rows, a) for m in (0, 1) for rows in (inside, inside + 1) for a in (True, False)]:
        g = torch.Generator().manual_seed(L + D + m + rows)
        vp = 4 * rows
        local, values, mask, start = _bag_shard(g, B, L, vp, 4, m, D) if L else (
            torch.randn((rows, D), generator=g), torch.zeros((B, 0), dtype=torch.int32), torch.zeros((B, 0)), m * rows)
        bags = kbag.bag_fwd_plan(L, D, rows, 4 if D % 4 == 0 else 1)
        assert bool(bags) == (rows == inside and L <= kbag.BAG_TILE_IDS) and (bags <= 1 or B % bags)
        dl = local.cuda()
        dv, dm = (values.cuda(), mask.cuda()) if aligned else (_offset_view(values.cuda()), _offset_view(mask.cuda()))
        buf = torch.zeros((B, 3, D), device="cuda")
        kernels.reset_launches()
        kbag.range_bag(dl, dv, dm, start, vp, m, out=buf[:, 1])
        got_zero = kbag.embedding_range_bag(dl, dv, dm, start)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["range_bag"] == 1 and kernels.LAUNCHES["embedding_range_bag"] == 1
        what = f"rank {m}, {rows} rows, aligned {aligned}"
        want = kbag.range_bag_plain(local, values, mask, start, vp, m)
        got = buf[:, 1].cpu()
        assert torch.equal(got.isnan(), want.isnan()), what
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)), what
        assert bool(want.isnan().any()) == (m == 0 and L > 0), what
        assert not bool(buf[:, [0, 2]].any()), what
        want_zero = kbag.embedding_range_bag_plain(local, values, mask, start)
        assert torch.equal(got_zero.cpu(), want_zero), what


@pytest.mark.parametrize(
    "F,D,B,lead",
    [(27, 16, 1001, 16), (5, 8, 1001, 8), (1, 3, 1001, 3), (4, 5, 1001, 5), (27, 16, 65_537, 1), (1, 16, 4099, 3),
     (28, 12, 3001, 16)],
    ids=["27-16", "5-8", "1-3", "4-5", "many_groups_odd_offset", "one_feature_d16", "f28_d12"],
)
def test_interaction_self_mode_kernels_match_plain(F, D, B, lead):
    """K13b's self-interaction mode: P = F (F + 1) / 2 dots within one ULP of
    the plain version (the same fmaf steps in the same order, which the
    plain version rounds twice, through float64, about once in 2^29),
    written after a lead, and the backward (2 g_ii x_i on the diagonal) from
    a strided gradient (rtol 1e-5, atol 1e-5), its rows after a lead of
    `lead` floats; counted apart from the strict mode."""
    _require_cuda()
    g = torch.Generator().manual_seed(F + D)
    P = F * (F + 1) // 2
    x = torch.randn((B, F, D), generator=g)
    grad = torch.randn((B, P), generator=g)
    xc = x.cuda()
    buf = torch.zeros((B, D + P), device="cuda")
    gbuf = torch.zeros((B, lead + P), device="cuda")
    gbuf[:, lead:] = grad.cuda()
    kernels.reset_launches()
    kint.interaction_fwd(xc, out=buf[:, D:], self_interaction=True)
    got_dx = kint.interaction_bwd(xc, gbuf[:, lead:], self_interaction=True)
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


@pytest.mark.parametrize("Hn", [1, 9, 200, 257])
@pytest.mark.parametrize(
    "B,Hk,F,D,same,misaligned",
    [(131, 5, 1, 1, False, False), (77, 26, 26, 3, True, False), (45, 30, 17, 16, False, True)],
    ids=["F1_D1", "xk_is_x0", "w_misaligned"],
)
def test_cin_forward_matches_plain_at_every_row_count(B, Hk, F, D, same, misaligned, Hn):
    """The forward with every Hn row in one block: one row, a partial
    8-row group, 200 rows, and 257 (two passes over the rows); F = 1 and D =
    1; B * D never a multiple of the 64-column tile; x_k the same tensor as
    x_0; w 4 bytes off 16-byte alignment (4-byte copies). Within 1e-5 of
    the terms' magnitudes."""
    _require_cuda()
    g = torch.Generator().manual_seed(B + Hn)
    xk, x0, w, _ = _cin_inputs(g, B, Hk, F, D, Hn, same)
    assert (B * D) % 64
    x0c = x0.cuda()
    xkc = x0c if same else xk.cuda()
    if misaligned:
        wc = torch.empty(w.numel() + 1, device="cuda")[1:].view(w.shape)
        wc.copy_(w)
        assert wc.data_ptr() % 16
    else:
        wc = w.cuda()
    kernels.reset_launches()
    out = kcin.cin_fwd(xkc, x0c, wc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cin_fwd"] == 1 and out.shape == (B, Hn, D)
    assert _within_terms(out.cpu(), kcin.cin_fwd_plain(xk, x0, w), kcin.cin_fwd_plain(xk.abs(), x0.abs(), w.abs()))


def test_cin_forward_refuses_what_does_not_fit_in_shared_memory():
    """Hk + F = 926 rows of 64 columns pass the card's 227 KB a block: the
    forward stages x_k in chunks of rows beside x_0 (kernels/cin.py
    fwd_plan) and no longer refuses; it computes and matches the plain
    version within 1e-5 of the terms' magnitudes."""
    _require_cuda()
    g = torch.Generator().manual_seed(926)
    xk, x0, w, _ = _cin_inputs(g, 5, 900, 26, 4, 8, False)
    assert kcin.fwd_plan(900, 26, 8)[1] < 900
    kernels.reset_launches()
    out = kcin.cin_fwd(xk.cuda(), x0.cuda(), w.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cin_fwd"] == 1
    assert _within_terms(out.cpu(), kcin.cin_fwd_plain(xk, x0, w), kcin.cin_fwd_plain(xk.abs(), x0.abs(), w.abs()))


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


# K13d in 16 bits: x_k, x_0 and g in T, w in T or float32
CIN16_TYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32), (torch.float16, torch.float16),
               (torch.float16, torch.float32)]
CIN16_IDS = ["bf16", "bf16_w32", "f16", "f16_w32"]
ULP_REL = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}  # one ULP of T relative to a value, at most


def _cin16_inputs(g, B, Hk, F, D, Hn, same, dtype, wdtype):
    xk, x0, w, grad = _cin_inputs(g, B, Hk, F, D, Hn, same)
    x0 = x0.to(dtype)
    return (x0 if same else xk.to(dtype)), x0, w.to(wdtype), grad.to(dtype)


def _cin16_magnitudes(xk, x0, w, grad):
    """float32 sums of the terms' magnitudes of out, dx_k, dx_0 and dw."""
    a = [t.float().abs() for t in (xk, x0, w, grad)]
    return (kcin.cin_fwd_plain(*a[:3]), *kcin.cin_bwd_plain(*a))


def _cin16_close(got, want, mag, dtype, what):
    """16-bit K13d against its plain version: both sum in float32 (in
    other orders, and dw by atomics) and round to T at the same points, so
    a rounded value may land on T's neighbour of the plain version's, and
    each term of dx's sums (a product with dz, itself rounded) by one ULP
    of itself: within 1e-5 of the float32 terms' magnitudes plus 1e-6, one
    ULP of T at the value (16-bit outputs) and, for dx_k and dx_0, one ULP
    of T of the terms' magnitudes. NaN where the plain version has NaN."""
    got, want, mag = got.float(), want.float(), mag.float()
    assert torch.equal(got.isnan(), want.isnan()), what
    tol = 1e-5 * mag + 1e-6
    if dtype in ULP_REL:
        tol = tol + ULP_REL[dtype] * torch.maximum(got.abs(), want.abs())
        if what in ("dx_k", "dx_0"):
            tol = tol + ULP_REL[dtype] * mag
    ok = ((got - want).abs() <= tol) | (got == want) | want.isnan()
    assert bool(ok.all()), (what, float((got - want).abs().nan_to_num().max()))


@pytest.mark.parametrize("dtype,wdtype", CIN16_TYPES, ids=CIN16_IDS)
@pytest.mark.parametrize(
    "B,Hk,F,D,Hn,same",
    [(2053, 26, 26, 16, 200, True), (517, 200, 26, 16, 200, False), (301, 7, 5, 5, 9, False),
     (64, 3, 2, 4, 1, False), (131, 5, 1, 1, 257, False), (45, 30, 17, 12, 36, False), (5, 900, 26, 4, 8, False),
     (3, 1800, 26, 8, 16, False)],
    ids=["layer1", "layer2", "odd", "tiny", "F1_D1_Hn257", "d12_hn36", "hk_f_926", "hk_f_1826"],
)
def test_cin16_kernels_match_plain(B, Hk, F, D, Hn, same, dtype, wdtype):
    """K13d's 16-bit kernels against their plain versions on the card: out,
    dx_k and dx_0 in T and dw in w's dtype at the tolerances of
    ``_cin16_close``; xDeepFM's layers 1 and 2, odd shapes (D 1, 5 and 12:
    no 16-byte copies; Hn 1, 9, 36 and 257), x_k the same tensor as x_0,
    and Hk + F = 926 and 1,826 rows, past what the forward stages whole
    (in float32 at 926, in 16 bits at 1,826: x_k in chunks)."""
    _require_cuda()
    g = torch.Generator().manual_seed(B + Hk)
    xk, x0, w, grad = (t.cuda() for t in _cin16_inputs(g, B, Hk, F, D, Hn, same, dtype, wdtype))
    suffix = kcin.COUNT_SUFFIX[dtype]
    kernels.reset_launches()
    out = kcin.cin_fwd(xk, x0, w)
    grads = kcin.cin_bwd(xk, x0, w, grad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cin_fwd" + suffix] == 1 and kernels.LAUNCHES["cin_bwd" + suffix] == 1
    assert kernels.LAUNCHES["cin_fwd"] == 0 and kernels.LAUNCHES["cin_bwd"] == 0
    assert out.dtype == dtype and [t.dtype for t in grads] == [dtype, dtype, wdtype]
    if Hk + F > 1000:
        assert kcin.fwd_plan(Hk, F, Hn, 2, w.element_size())[1] < Hk
    mags = _cin16_magnitudes(xk, x0, w, grad)
    _cin16_close(out, kcin.cin_fwd_plain(xk, x0, w), mags[0], dtype, "out")
    for name, got, want, mag in zip(("dx_k", "dx_0", "dw"), grads, kcin.cin_bwd_plain(xk, x0, w, grad), mags[1:]):
        _cin16_close(got, want, mag, wdtype if name == "dw" else dtype, name)


@pytest.mark.parametrize("dtype,wdtype", CIN16_TYPES, ids=CIN16_IDS)
def test_cin16_kernels_follow_plain_at_nonfinite_inputs(dtype, wdtype):
    """NaN and infinities in x_k, x_0, w and g: the kernels' NaN where the
    plain versions have NaN (each sum takes the same terms), the same
    infinities, and the finite entries as in the test above."""
    _require_cuda()
    g = torch.Generator().manual_seed(17)
    xk, x0, w, grad = _cin16_inputs(g, 97, 6, 5, 8, 24, False, dtype, wdtype)
    xk[3, 2, 1] = float("nan")
    x0[5, 4, 7] = float("inf")
    x0[6, 0, 0] = -float("inf")
    w[7, 3] = float("nan")
    grad[9, 11, 2] = float("inf")
    xk, x0, w, grad = (t.cuda() for t in (xk, x0, w, grad))
    out = kcin.cin_fwd(xk, x0, w)
    grads = kcin.cin_bwd(xk, x0, w, grad)
    wants = (kcin.cin_fwd_plain(xk, x0, w), *kcin.cin_bwd_plain(xk, x0, w, grad))
    mags = _cin16_magnitudes(xk, x0, w, grad)
    for name, got, want, mag in zip(("out", "dx_k", "dx_0", "dw"), (out, *grads), wants, mags):
        assert bool(want.isnan().any()), name
        finite = want.isfinite() & mag.isfinite()
        assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf()), name
        assert torch.equal(got[got.isinf()], want[want.isinf()]), name
        _cin16_close(got[finite], want[finite], mag[finite], wdtype if name == "dw" else dtype, name)


@pytest.mark.parametrize("dtype,wdtype", CIN16_TYPES, ids=CIN16_IDS)
def test_cin16_backward_run_to_run(dtype, wdtype):
    """dx_k and dx_0 sum in a fixed order: the same bits every run. dw's
    float32 atomics add in an order that varies from run to run, so two
    runs' dw differ as the kernel and its plain version may
    (``_cin16_close``): a float32 sum moved within 1e-5 of its terms'
    magnitudes (several ULPs of a 16-bit dw where the sum cancels), then
    its round to w's dtype."""
    _require_cuda()
    g = torch.Generator().manual_seed(29)
    xk, x0, w, grad = (t.cuda() for t in _cin16_inputs(g, 4099, 26, 26, 16, 200, True, dtype, wdtype))
    first = kcin.cin_bwd(xk, x0, w, grad)
    second = kcin.cin_bwd(xk, x0, w, grad)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    _cin16_close(first[2], second[2], _cin16_magnitudes(xk, x0, w, grad)[3], wdtype, "dw")


# K13d's tensor-core kernels at their tiles' edges, (B, Hk, F, D, Hn, same): Hn 1 to 257 (16-row tiles, two
# passes at 257), K = Hk * F not a multiple of 16 with 32-pair steps across i, B * D short of the 128-column
# tiles, D 1 to 24 (no 16-byte copies at D 1), x_k the same tensor as x_0
CIN16_EDGES = [(37, 3, 7, 1, 1, False), (29, 5, 26, 8, 9, False), (23, 26, 26, 16, 16, True),
               (11, 4, 13, 24, 17, False), (9, 7, 26, 16, 200, False), (13, 3, 5, 8, 257, False)]
CIN16_EDGE_IDS = ["hn1_d1", "hn9_d8", "hn16_same", "hn17_d24", "hn200", "hn257"]
# x near these scales makes z = x_k x_0 subnormal in T (bfloat16 below 2^-126, float16 below 2^-14)
SUBNORMAL_X = {torch.bfloat16: 2.0**-66, torch.float16: 2.0**-11}
SUBNORMAL_STEP = {torch.bfloat16: 2.0**-133, torch.float16: 2.0**-24}  # T's spacing below its normal range


def _cin16_edge_close(got, want, mag, dtype, n, dx, what):
    """The tensor-core kernels against the plain versions with no absolute
    floor above the subnormals: both sum exact products in float32 (n
    terms, in other orders: n * 2^-24 of the terms' magnitudes, and n *
    2^-149 where the sums are float32 subnormals) and round at the same
    points, so a result may land on T's neighbour (one ULP of T at the
    value, or T's subnormal spacing), and each product of dx's sums by one
    ULP of dz and one of itself (2 ULPs of the terms' magnitudes). A flush
    of subnormal operands or sums to zero fails it."""
    got, want, mag = got.float(), want.float(), mag.float()
    assert torch.equal(got.isnan(), want.isnan()), what
    tol = n * 2.0**-24 * mag + n * 2.0**-149
    if dtype in ULP_REL:
        tol = tol + ULP_REL[dtype] * torch.maximum(got.abs(), want.abs()) + SUBNORMAL_STEP[dtype]
        if dx:
            tol = tol + 2 * ULP_REL[dtype] * mag
    ok = ((got - want).abs() <= tol) | (got == want)
    assert bool(ok.all()), (what, float((got - want).abs().max()), float(want.abs().max()))


def _bwd_w_splits(N, K):
    """(splits, columns a split) of K13d's 16-bit dw launch (csrc/cin.cu
    launch_bwd_w_tc): enough splits of the N columns for about 1,056 blocks
    of 128 k each, each split at least 256 columns, a multiple of 32."""
    k_tiles = -(-K // 128)
    splits = min(max(1, 1056 // k_tiles), -(-N // 256))
    cols = -(-(-(-N // splits)) // 32) * 32
    return -(-N // cols), cols


def _cin16_dw_flushed(xk, x0, grad, wdtype):
    """dw as K13d's 16-bit backward leaves it where its sums are float32
    subnormals: each column split's float32 partial (_bwd_w_splits) is
    added into dw by a float32 atomic, and the card's atomic add
    (red.add.f32) flushes a subnormal addend or sum to zero; the plain
    version's float32 sum keeps them. With at most two splits the order of
    the adds does not matter."""
    B, Hk, D = xk.shape
    F, Hn = x0.shape[1], grad.shape[1]
    splits, cols = _bwd_w_splits(B * D, Hk * F)
    assert splits <= 2
    z = kcin.outer_product_plain(xk.double(), x0.double()).to(xk.dtype).double()  # [B, K, D]
    z = z.permute(1, 0, 2).reshape(Hk * F, B * D)
    g = grad.double().permute(1, 0, 2).reshape(Hn, B * D)
    tiny = torch.finfo(torch.float32).tiny

    def flush(t):
        return torch.where(t.abs() < tiny, torch.zeros_like(t), t)

    dw = torch.zeros((Hk * F, Hn), dtype=torch.float32, device=xk.device)
    for s in range(splits):
        part = (z[:, s * cols:(s + 1) * cols] @ g[:, s * cols:(s + 1) * cols].t()).float()
        dw = flush(dw + flush(part))
    return dw.to(wdtype)


@pytest.mark.parametrize("dtype,wdtype", CIN16_TYPES, ids=CIN16_IDS)
@pytest.mark.parametrize("subnormal", [False, True], ids=["normal", "subnormal"])
@pytest.mark.parametrize("B,Hk,F,D,Hn,same", CIN16_EDGES, ids=CIN16_EDGE_IDS)
def test_cin16_tensor_core_edges(B, Hk, F, D, Hn, same, subnormal, dtype, wdtype):
    """K13d's 16-bit kernels at the edges of the tensor-core tiles (the
    forward and dz with w in T, dw for every 16-bit x): padded rows,
    depths and columns add nothing, at normal inputs and where every z is
    a subnormal of T (x_k and x_0 near SUBNORMAL_X), held to the plain
    versions by ``_cin16_edge_close``; x_k's NaN gives NaN where the plain
    version has it. The tensor cores keep subnormal operands and sums; dw's
    float32 atomics do not (``_cin16_dw_flushed``, a recorded difference:
    in bfloat16 dw's sums are float32 subnormals here; in float16 they are
    normal)."""
    _require_cuda()
    g = torch.Generator().manual_seed(B * 1000 + Hn)
    xk, x0, w, grad = _cin_inputs(g, B, Hk, F, D, Hn, same)
    if subnormal:
        x0 = x0 * SUBNORMAL_X[dtype]
        xk = x0 if same else xk * SUBNORMAL_X[dtype]
    x0 = x0.to(dtype)
    xk = x0 if same else xk.to(dtype)
    w, grad = w.to(wdtype), grad.to(dtype)
    if subnormal:
        z = kcin.outer_product_plain(xk.float(), x0.float()).to(dtype).float()
        assert bool(((z != 0) & (z.abs() < torch.finfo(dtype).tiny)).float().mean() > 0.5)
    xk, x0, w, grad = (t.cuda() for t in (xk, x0, w, grad))
    suffix = kcin.COUNT_SUFFIX[dtype]
    kernels.reset_launches()
    out = kcin.cin_fwd(xk, x0, w)
    grads = kcin.cin_bwd(xk, x0, w, grad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cin_fwd" + suffix] == 1 and kernels.LAUNCHES["cin_bwd" + suffix] == 1
    mags = _cin16_magnitudes(xk, x0, w, grad)
    _cin16_edge_close(out, kcin.cin_fwd_plain(xk, x0, w), mags[0], dtype, Hk * F, False, "out")
    wants = list(kcin.cin_bwd_plain(xk, x0, w, grad))
    if subnormal and dtype == torch.bfloat16:  # dw's float32 sums subnormal: the atomics' flush shows
        flushed = _cin16_dw_flushed(xk, x0, grad, wdtype)
        assert not torch.equal(flushed == 0, wants[2] == 0)
        wants[2] = flushed
    for name, got, want, mag in zip(("dx_k", "dx_0", "dw"), grads, wants, mags[1:]):
        n = B * D if name == "dw" else max(Hn, Hk, F)
        _cin16_edge_close(got, want, mag, wdtype if name == "dw" else dtype, n, name != "dw", name)
    if not same:  # one NaN in x_k: its column's outputs NaN in both
        xk[B // 2, Hk - 1, D - 1] = float("nan")
        out = kcin.cin_fwd(xk, x0, w)
        want = kcin.cin_fwd_plain(xk, x0, w)
        assert bool(want.isnan().any()) and torch.equal(out.isnan(), want.isnan())


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
            "interaction_fwd": 1, "interaction_bwd": 1, **_step_launches(model)}
    assert kernels.LAUNCHES == {k: want.get(k, 0) for k in kernels.LAUNCHES}
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    ref_logits = models.reference_forward(model, batch)
    ref_loss = models.bce_with_logits(ref_logits, batch["label"], plain=True)
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
    table a step, one K18 update a step, no K13a or K13c) from the
    parameters of an unsharded DLRM that takes the same steps through K13a
    and K13c: losses within rtol
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
                        "range_bag": 6, "range_bag_grad": 6, "interaction_fwd": 3, "interaction_bwd": 3,
                        "adagrad_update": 3, **{k: 3 * n for k, n in _step_launches(model).items()}}
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
    row (the kernel's float32 sums in its own order: a tree of 8-value
    runs, block scans and one atomic a block; the plain version's float64
    index_add_, rounded once)."""
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



def _merge_path_case(case, rng):
    """(values, offsets, num_rows) of a K11c edge case: rows of length 0, 1
    and many; one row over hundreds of merge-path tiles (3,840 items each);
    values before offsets[0] and past offsets[R]; rows dropped (num_rows <
    R) and added (num_rows > R); T not a multiple of 4."""
    if case == "lengths_0_1_many":
        lengths = rng.choice([0, 1, 2, 7, 300], 20_001, p=[0.3, 0.3, 0.2, 0.15, 0.05])
    elif case == "head_row_over_hundreds_of_tiles":
        lengths = rng.integers(0, 40, 5_000)
        lengths[1_234] = 900_001
    else:
        lengths = rng.integers(0, 60, 3_001)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    pre, post = (13, 1_001) if case in ("before_and_past", "more_rows_than_offsets", "fewer_rows_kept") else (0, 0)
    offsets += pre
    T = int(offsets[-1]) + post
    T += 3 - T % 4 if T % 4 == 0 else 0  # not a multiple of 4
    values = (rng.integers(-4, 11, T) / 2.0).astype(np.float32)
    values[rng.random(T) < 2e-3] = np.nan
    R = len(lengths)
    num_rows = {"fewer_rows_kept": R - 777, "more_rows_than_offsets": R + 5}.get(case, R)
    return values, offsets, num_rows


MERGE_PATH_CASES = ["lengths_0_1_many", "head_row_over_hundreds_of_tiles", "before_and_past", "fewer_rows_kept",
                    "more_rows_than_offsets"]


@pytest.mark.parametrize("odd", [False, True], ids=["aligned", "odd_offset"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "min", "max"])
@pytest.mark.parametrize("case", MERGE_PATH_CASES)
def test_ragged_segment_reduce_merge_path_edges(case, combiner, odd):
    """K11c's merge path against the plain version at its edges, the values
    also as a view one float past a 16-byte boundary (its staging's
    unaligned head): min and max bit for bit, sum and mean within 1e-5 of
    the float64 sum of |v| of the row; a mean takes num_rows == R."""
    _require_cuda()
    rng = np.random.default_rng(MERGE_PATH_CASES.index(case) + 60)
    values, offsets, num_rows = _merge_path_case(case, rng)
    if combiner == "mean":
        num_rows = len(offsets) - 1
    v = torch.from_numpy(np.concatenate([[7.0], values]).astype(np.float32)).cuda()[1:] if odd else \
        torch.from_numpy(values).cuda()
    assert (v.data_ptr() % 16 != 0) == odd
    off = torch.from_numpy(offsets).cuda()
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
    out = got.cpu().double()
    assert torch.equal(out.isnan(), nan)
    assert bool(((out - exact).abs()[~nan] <= 1e-5 * scale[~nan] + 1e-6).all())


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_ragged_segment_reduce_sums_are_the_same_from_run_to_run(combiner):
    """Every sum is taken in an order fixed by the shapes (no atomics): two
    calls give equal bits, the head row over hundreds of tiles included."""
    _require_cuda()
    values, offsets, num_rows = _merge_path_case("head_row_over_hundreds_of_tiles", np.random.default_rng(66))
    v, off = torch.from_numpy(values).cuda(), torch.from_numpy(offsets).cuda()
    first = kragged.ragged_segment_reduce(v, off, num_rows, combiner)
    second = kragged.ragged_segment_reduce(v, off, num_rows, combiner)
    torch.cuda.synchronize()
    assert torch.equal(first.isnan(), second.isnan())
    assert torch.equal(first.nan_to_num(), second.nan_to_num())


def _cuckoo_tables(rng, sizes):
    """Cuckoo tables from build_cuckoo of ``sizes`` random int32 keys each
    (codes 3, 4, ...), batched, with each column's keys."""
    keysets = [rng.permutation(np.unique(rng.integers(I32_MIN, I32_MAX, int(n * 1.02))))[:n].astype(np.int32)
               for n in sizes]
    luts = [plookup.build_cuckoo(k, np.arange(len(k)) + 3) for k in keysets]
    return plookup.BatchedCuckoo(luts), luts, keysets


def _in_second_bucket(lut, keys):
    """How many of ``keys`` sit in their second bucket (b1 != b0)."""
    u = torch.from_numpy(keys)
    b0, b1 = (klk.bucket_index_plain(u, lut.nb, seed).numpy() for seed in klk.SEEDS)
    packed = lut.packed
    in_b0 = ((packed[b0, :4] == keys[:, None]) & (packed[b0, 4:] >= 0)).any(1)
    return int((~in_b0 & (b1 != b0)).sum())


@pytest.mark.parametrize("layout", ["aligned", "odd_n", "unaligned_view"])
@pytest.mark.parametrize("nbuckets", [False, True], ids=["one_oov", "hashed_oov"])
@pytest.mark.parametrize("with_validity", [False, True])
def test_cuckoo_lookup_probes_b1_only_on_a_b0_miss(with_validity, nbuckets, layout):
    """K3 against its plain version (which probes both buckets, a later hit
    overriding) on build_cuckoo tables of three sizes (1,000, 60,000 and
    700,000 keys; some keys evicted into their second bucket): codes equal,
    with misses (20%), invalid rows, several OOV buckets a column, N not a
    multiple of 4, and the values as a view one int past a 16-byte boundary
    (the kernel's scalar path)."""
    _require_cuda()
    rng = np.random.default_rng(70)
    blut, luts, keysets = _cuckoo_tables(rng, [1_000, 60_000, 700_000])
    assert all(_in_second_bucket(lut, k) > 0 for lut, k in zip(luts[1:], keysets[1:]))
    sel = [0, 1, 2, 2, 1]
    n = 100_003 if layout == "odd_n" else 100_000
    values = _queries(rng, [keysets[s] for s in sel], n)
    validity = torch.from_numpy(rng.random(values.shape) > 0.1) if with_validity else None
    sel_t = torch.tensor(sel, dtype=torch.int32)
    offs = torch.tensor([5 * i for i in range(len(sel))], dtype=torch.int32)
    nb = torch.tensor([1, 1000, 3, 2**31 - 1, 7], dtype=torch.int32) if nbuckets else None
    want = blut.encode(values, validity, sel_t, offs, nbuckets=nb)
    dev = blut.to("cuda")
    if layout == "unaligned_view":
        vals = torch.cat([torch.zeros(1, dtype=torch.int32), values.flatten()]).cuda()[1:].view(values.shape)
        assert vals.data_ptr() % 16 != 0
    else:
        vals = values.cuda()
    kernels.reset_launches()
    got = dev.encode(vals, None if validity is None else validity.cuda(), sel_t.cuda(), offs.cuda(),
                     nbuckets=None if nb is None else nb.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cuckoo_lookup"] == 1
    assert torch.equal(got.cpu(), want)


def test_cuckoo_lookup_solo_branch():
    """One table row (K8's solo branch, counted as cuckoo_lookup_solo) at
    N = 262,147 over 200,000 keys, against the plain version."""
    _require_cuda()
    rng = np.random.default_rng(71)
    blut, luts, keysets = _cuckoo_tables(rng, [200_000])
    values = _queries(rng, keysets, 262_147)
    zero = torch.zeros(1, dtype=torch.int32)
    want = klk.cuckoo_lookup_plain(values, None, blut.table, blut.nbs, blut.row_offsets, zero, zero)
    dev = blut.to("cuda")
    kernels.reset_launches()
    got = klk.cuckoo_lookup(values.cuda(), None, dev.table, dev.nbs, dev.row_offsets, zero.cuda(), zero.cuda(),
                            counter="cuckoo_lookup_solo")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cuckoo_lookup_solo"] == 1 and kernels.LAUNCHES["cuckoo_lookup"] == 0
    assert torch.equal(got.cpu(), want)


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


# --- parquet I/O and K8's solo-table branch ----------------------------------------------------------
def test_parquet_write_read_round_trip_on_the_card_machine(tmp_path):
    """The host library builds on the card's machine (g++, zstd where
    zstd.h is found, no pyarrow): CUDA batches written PER_WORKER and read
    back hold every row, bit for bit as a multiset."""
    _require_cuda()
    from nvtabular_tpu_torch.io import Shuffle, native_parquet

    rng = np.random.default_rng(40)
    parts = [{"a": rng.integers(-(2**31), 2**31 - 1, 30_000).astype(np.int32), "b": rng.integers(0, 2**40, 30_000),
              "x": rng.normal(size=30_000).astype(np.float32)} for _ in range(3)]
    parts[0]["x"][:3] = [np.nan, -0.0, np.inf]
    codec = "auto" if native_parquet.has_zstd() else "none"
    data = nvt.Dataset([nvt.TableBatch.from_pydict(p).to("cuda") for p in parts])
    data.to_parquet(str(tmp_path / "o"), shuffle=Shuffle.PER_WORKER, output_files=3, compression=codec)
    back = nvt.Dataset(str(tmp_path / "o")).to_table()
    for name in ("a", "b", "x"):
        want = np.concatenate([p[name] for p in parts])
        view = np.int32 if want.itemsize == 4 else np.int64
        got = back[name].values.numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.sort(got.view(view)), np.sort(want.view(view)))


@pytest.mark.parametrize("num_buckets", [1, 5])
@pytest.mark.parametrize("kind", ["tiny", "direct", "cuckoo"])
def test_solo_lookups_match_plain_on_card(tmp_path, kind, num_buckets):
    """K8's solo-table branch: one column through its vocabulary's own table,
    launched with one table row on K1, K2 or K3, against the same call on
    the CPU (the plain version); one ``*_lookup_solo`` launch each."""
    _require_cuda()
    rng = np.random.default_rng(41)
    vocab = {"tiny": rng.choice(np.arange(-2**31, 2**31 - 1, 7919, dtype=np.int64), 3000, replace=False),
             "direct": rng.choice(np.arange(100_000, 160_000), 9000, replace=False),
             "cuckoo": rng.choice(np.arange(-2**31, 2**31 - 1, 104729, dtype=np.int64), 20000,
                                  replace=False)}[kind]
    n = 100_000
    values = np.where(rng.random(n) < 0.3, rng.integers(-2**31, 2**31 - 1, n), rng.choice(vocab, n)).astype(np.int32)
    values[: len(EXTREMES)] = EXTREMES
    validity = rng.random(n) > 0.1
    op = ops.Categorify(vocabs={"k": vocab}, num_buckets=num_buckets, out_path=str(tmp_path), cat_cache="disk")
    want = op.encode_solo("k", nvt.Column(values, None, validity))
    kernels.reset_launches()
    got = op.encode_solo("k", nvt.Column(values, None, validity).to("cuda"))
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {f"{kind}_lookup_solo": 1}
    assert torch.equal(got.cpu(), want)


def test_disk_tier_and_budget_workflows_on_cuda_match_cpu(tmp_path):
    """A workflow with disk-tier columns and one under a memory budget, on
    cuda: the codes equal the CPU run's, the disk tier releases after each
    batch, and the solo columns take only solo launches."""
    _require_cuda()
    rng = np.random.default_rng(42)
    parts = [{f"c{i}": rng.integers(0, 2000 * (i + 1) ** 3, 20_000).astype(np.int32) for i in range(4)}
             for _ in range(3)]
    cols = [f"c{i}" for i in range(4)]
    for kwargs, solo in [({"cat_cache": {"c0": "disk", "c3": "disk"}}, {"c0", "c3"}),
                         ({"cardinality_memory_limit": 100_000}, set(cols))]:
        gpu = nvt.Workflow(cols >> ops.Categorify(out_path=str(tmp_path / "g"), **kwargs))
        cpu = nvt.Workflow(cols >> ops.Categorify(out_path=str(tmp_path / "c"), **kwargs), device="cpu")
        gpu.fit(nvt.Dataset(parts))
        cpu.fit(nvt.Dataset(parts))
        kernels.reset_launches()
        outs = [gpu.transform(nvt.TableBatch.from_pydict(p)) for p in parts]
        torch.cuda.synchronize()
        solo_launches = sum(v for k, v in kernels.LAUNCHES.items() if k.endswith("_solo"))
        assert solo_launches == len(parts) * len(solo)
        for out, p in zip(outs, parts):
            want = cpu.transform(nvt.TableBatch.from_pydict(p))
            for c in cols:
                assert torch.equal(out[c].values.cpu(), want[c].values), c
        op = next(n.op for n in gpu.graph.nodes if isinstance(n.op, ops.Categorify))
        if "cat_cache" in kwargs:
            assert not op.vocabs["c0"].resident and op.vocabs["c1"].resident


# --- the shapes past the kernels' old limits ----------------------------------------------------------
WIDE_INTERACTIONS = [(27, 66), (27, 300), (65, 128), (27, 455)]


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the card 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, device="cuda")
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
@pytest.mark.parametrize("F,D", WIDE_INTERACTIONS, ids=[f"{f}-{d}" for f, d in WIDE_INTERACTIONS])
def test_interaction_kernels_match_plain_past_the_old_limits(F, D, self_interaction, aligned):
    """K13b at shapes the old plans refused: the forward (one item a
    thread past 48 KB before) within one ULP of the plain version's fmaf
    steps (which round twice, through float64, about once in 2^29), written
    after a lead of 3 floats (4-byte aligned rows); the backward, its
    sample's items more than a block's threads (one sample a group, several
    items a thread), within rtol 1e-5, atol 1e-5 of the plain version's
    steps, from a strided gradient; x 16-byte aligned or not (one column a
    step)."""
    _require_cuda()
    g = torch.Generator().manual_seed(F * D)
    B = 301
    P = kint.num_pairs(F, self_interaction)
    x = torch.randn((B, F, D), generator=g)
    grad = torch.randn((B, P), generator=g)
    xc = x.cuda() if aligned else _unaligned(x)
    buf = torch.zeros((B, 3 + P), device="cuda")
    gbuf = torch.zeros((B, 5 + P), device="cuda")
    gbuf[:, 5:] = grad.cuda()
    kernels.reset_launches()
    kint.interaction_fwd(xc, out=buf[:, 3:], self_interaction=self_interaction)
    got_dx = kint.interaction_bwd(xc, gbuf[:, 5:], self_interaction=self_interaction)
    torch.cuda.synchronize()
    mode = "interaction_self" if self_interaction else "interaction"
    assert kernels.LAUNCHES[mode + "_fwd"] == 1 and kernels.LAUNCHES[mode + "_bwd"] == 1
    torch.testing.assert_close(buf[:, 3:].cpu(), kint.interaction_fwd_plain(x, self_interaction), rtol=2**-23, atol=0)
    assert not bool(buf[:, :3].any())
    torch.testing.assert_close(got_dx.cpu(), kint.interaction_bwd_plain(x, grad, self_interaction), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("Hk", [412, 900], ids=["hk_f_438", "hk_f_926"])
def test_cin_kernels_match_plain_past_the_old_limits(Hk):
    """K13d at Hk + F = 438 (past the old backward's 437) and 926 (past the
    old forward's 742), F = 26: out, dx_k, dx_0 and dw within 1e-5 of the
    sums of their terms' magnitudes plus 1e-6."""
    _require_cuda()
    g = torch.Generator().manual_seed(Hk)
    xk, x0, w, grad = (t.cuda() for t in _cin_inputs(g, 67, Hk, 26, 4, 24, False))
    kernels.reset_launches()
    out = kcin.cin_fwd(xk, x0, w)
    grads = kcin.cin_bwd(xk, x0, w, grad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cin_fwd"] == 1 and kernels.LAUNCHES["cin_bwd"] == 1
    assert _within_terms(out, kcin.cin_fwd_plain(xk, x0, w), kcin.cin_fwd_plain(xk.abs(), x0.abs(), w.abs()))
    wants = kcin.cin_bwd_plain(xk, x0, w, grad)
    mags = kcin.cin_bwd_plain(xk.abs(), x0.abs(), w.abs(), grad.abs())
    for name, got, want, mag in zip(("dx_k", "dx_0", "dw"), grads, wants, mags):
        assert _within_terms(got, want, mag), (name, float((got - want).abs().max()))


def test_range_scatter_grad_matches_plain_at_d_2048():
    """K15d's backward past one launch's 1,536 floats a row: two launches
    of column chunks (1,536 and 512), a row hit by every id of a column,
    within 1e-5 of the terms' magnitudes."""
    _require_cuda()
    g = torch.Generator().manual_seed(2048)
    cards = [3, 40, 1001, 7]
    local, ids, offsets, sizes, starts, padded = _shard_columns(g, 3001, cards, 4, 1, 2048)
    ids[-1][:] = starts[-1] + 1
    cols = (offsets, sizes, starts, padded)
    grad = torch.randn((3001, len(cards), 2048), generator=g)
    kernels.reset_launches()
    got = kemb.range_scatter_grad(grad.cuda(), [i.cuda() for i in ids], *cols, local.shape[0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["range_scatter_grad"] == 2  # the launches, one a chunk of the row
    want = kemb.range_scatter_grad_plain(grad, ids, *cols, local.shape[0])
    magnitude = kemb.range_scatter_grad_plain(grad.abs(), ids, *cols, local.shape[0])
    assert bool(((got.cpu() - want).abs() <= 1e-5 * magnitude + 1e-6).all())


def test_embedding_and_fm_kernels_match_plain_at_70_columns():
    """K13a and K16 past one launch's 64 columns: the gather bit-equal (NaN
    rows included), its scatter-add within 1e-5 of the terms' magnitudes;
    the FM output within 1e-5 of its terms' magnitudes, NaN where an id is
    out of range, the row gradient's dv within 1e-5 of |g| sum_f |v|, the
    linear scatter within 1e-5 of its terms' magnitudes."""
    _require_cuda()
    gen = torch.Generator().manual_seed(70)
    B, C, D, nd = 2053, 70, 8, 13
    sizes, offsets, ids, linear, dense_w = _fm_case(gen, B, C, D, nd, True)
    table = torch.randn((sum(sizes), D), generator=gen)
    cids = [i.cuda() for i in ids]
    kernels.reset_launches()
    got = kemb.embedding_gather(table.cuda(), cids, offsets, sizes)
    grad = torch.randn((B, C, D), generator=gen)
    got_grad = kemb.embedding_scatter_grad(grad.cuda(), cids, offsets, sizes, table.shape[0])
    v, dense, g = torch.randn((B, C, D), generator=gen), torch.randn((B, nd), generator=gen), torch.randn(B, generator=gen)
    out = kfm.fm_fwd(v.cuda(), dense.cuda(), cids, offsets, sizes, linear.cuda(), dense_w.cuda())
    dv, _, dlinear, _ = kfm.fm_bwd(v.cuda(), dense.cuda(), cids, offsets, sizes, dense_w.cuda(), g.cuda(),
                                   linear.shape[0])
    torch.cuda.synchronize()
    # K13a launches once for each 64 columns; K16 reads the column table on the card in one launch
    for name, launches in (("embedding_gather", 2), ("embedding_scatter_grad", 2), ("fm_fwd", 1), ("fm_bwd", 1)):
        assert kernels.LAUNCHES[name] == launches, name
    want = kemb.embedding_gather_plain(table, ids, offsets, sizes)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    magnitude = kemb.embedding_scatter_grad_plain(grad.abs(), ids, offsets, sizes, table.shape[0])
    want_grad = kemb.embedding_scatter_grad_plain(grad, ids, offsets, sizes, table.shape[0])
    assert bool(((got_grad.cpu() - want_grad).abs() <= 1e-5 * magnitude + 1e-6).all())
    want_out = kfm.fm_fwd_plain(v, dense, ids, offsets, sizes, linear, dense_w)
    s, q = v.sum(1), (v * v).sum(1)
    rows, valid = kemb.table_rows(ids, offsets, sizes)
    scale = (s * s + q).sum(1) + torch.where(valid, linear[rows].abs(), 0.0).sum(1) + (dense * dense_w).abs().sum(1)
    out = out.cpu()
    assert torch.equal(torch.isnan(out), torch.isnan(want_out)) and bool(torch.isnan(want_out).any())
    ok = ~torch.isnan(want_out)
    assert bool(((out - want_out).abs()[ok] <= 1e-5 * scale[ok] + 1e-6).all())
    want_b = kfm.fm_bwd_plain(v, dense, ids, offsets, sizes, dense_w, g, linear.shape[0])
    ga = g.abs()
    assert bool(((dv.cpu() - want_b[0]).abs() <= 1e-5 * ga[:, None, None] * v.abs().sum(1, keepdim=True) + 1e-6).all())
    mag = kfm.fm_bwd_plain(v, dense.abs(), ids, offsets, sizes, dense_w, ga, linear.shape[0])
    assert bool(((dlinear.cpu() - want_b[2]).abs() <= 1e-5 * mag[2] + 1e-6).all())


def test_hash_kernels_match_plain_at_20_columns():
    """HashedCross and the hash pair past one launch's 16 columns: the
    second launch carries the chain's running hash (and the verify's codes
    past 16 masks), bit for bit."""
    _require_cuda()
    g = torch.Generator().manual_seed(20)
    n = 50_003
    kinds = [torch.int32, torch.int64, torch.float32, torch.int64] * 5
    cols = []
    for k in kinds:
        c = torch.randint(-(2**62), 2**62, (n,), generator=g, dtype=torch.int64)
        cols.append(c.to(torch.int32) if k == torch.int32 else (c.float() if k == torch.float32 else c))
    kernels.reset_launches()
    got = [khash.hashed_cross([c.cuda() for c in cols], nb, seed=5) for nb in (10_000, None)]
    h1, h2 = khp.hash_pair([c.cuda() for c in cols])
    G = 500
    idx = torch.randint(0, G + 1, (n,), generator=g, dtype=torch.int32)
    h2_by_group = torch.randint(-(2**31), 2**31 - 1, (G + 1,), generator=g, dtype=torch.int32)
    hv = torch.where(torch.rand(n, generator=g) < 0.5, h2_by_group[idx.long()], idx)
    masks = [torch.rand(n, generator=g) > 0.02 for _ in range(20)]
    codes = khp.hash_pair_verify(idx.cuda(), hv.cuda(), h2_by_group.cuda(), [m.cuda() for m in masks], G, 7, 3, 1)
    torch.cuda.synchronize()
    # a launch for each 16 columns or masks: two calls of HashedCross, one of each hash-pair kernel
    assert kernels.LAUNCHES["hashed_cross"] == 4 and kernels.LAUNCHES["hash_pair"] == 2
    assert kernels.LAUNCHES["hash_pair_verify"] == 2
    for nb, got_h in zip((10_000, None), got):
        assert torch.equal(got_h.cpu(), khash.hashed_cross(cols, nb, seed=5)), nb
    want = khp.hash_pair(cols)
    assert torch.equal(h1.cpu(), want[0]) and torch.equal(h2.cpu(), want[1])
    want_codes = khp.hash_pair_verify(idx, hv, h2_by_group, masks, G, 7, 3, 1)
    assert torch.equal(codes.cpu(), want_codes) and bool((want_codes == 1).any())


# --- the shape and dtype limits repaired last: narrow and many arrays, streamed samples, bound chunks ----------
def test_permute_rows_kernel_copies_narrow_dtypes_in_their_own_width():
    """K14 with 1- and 2-byte arrays (int8 and int16 codes after
    ReduceDtypeSize, float16, bool), a 6-byte row and an array 2 bytes
    past a 4-byte boundary, bit for bit, in one launch."""
    _require_cuda()
    g = torch.Generator().manual_seed(8)
    n = 70_001
    arrays = {
        "i8": torch.randint(-128, 127, (n,), dtype=torch.int8, generator=g),
        "i16": torch.randint(-(2**15), 2**15 - 1, (n,), dtype=torch.int16, generator=g),
        "f16": torch.randn((n, 3), generator=g).half(),
        "flag": torch.rand(n, generator=g) < 0.3,
        "u8x5": torch.randint(0, 255, (n, 5), dtype=torch.uint8, generator=g),
        "dense": torch.randn((n, 13), generator=g),
    }
    perm = torch.randperm(n, generator=g)
    on_card = {k: v.cuda() for k, v in arrays.items()}
    buf = torch.zeros(2 * n + 1, dtype=torch.int16, device="cuda")
    on_card["i16_off"] = buf[1 : n + 1]  # 2 bytes past a 4-byte boundary: copied in 2-byte elements
    on_card["i16_off"].copy_(arrays["i16"].cuda())
    assert [kperm.element_bytes(v[0].numel() * v.element_size(), v.data_ptr()) for v in on_card.values()] == \
        [1, 2, 2, 1, 1, 4, 2]
    kernels.reset_launches()
    got = kperm.permute_rows(on_card, perm.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["permute_rows"] == 1
    for k, v in on_card.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k].cpu(), v.cpu()[perm]), k


def test_permute_rows_kernel_takes_70_arrays():
    """Past one launch's 64 arrays: two launches, every array bit for bit."""
    _require_cuda()
    g = torch.Generator().manual_seed(70)
    n = 10_007
    arrays = {f"c{i}": torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, generator=g) for i in range(68)}
    arrays["dense"] = torch.randn((n, 13), generator=g)
    arrays["small"] = arrays["c0"].to(torch.int8)
    perm = torch.randperm(n, generator=g).to(torch.int32)
    kernels.reset_launches()
    got = kperm.permute_rows({k: v.cuda() for k, v in arrays.items()}, perm.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["permute_rows"] == 2
    for k, v in arrays.items():
        assert torch.equal(got[k].cpu(), v[perm]), k


def test_permute_rows_kernel_past_2_31_elements():
    """A uint8 array of 2^31 + 1,811,352 elements (1,051,000 rows of 2,045
    bytes): two launches of row chunks, the permutation and the output moved
    to the chunk's first row."""
    _require_cuda()
    n, w = 1_051_000, 2_045
    assert n * w > 2**31
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randint(0, 256, (n, w), dtype=torch.uint8, device="cuda", generator=gen)
    perm = torch.randperm(n, device="cuda", generator=gen)
    kernels.reset_launches()
    got = kperm.permute_rows({"x": x}, perm)["x"]
    torch.cuda.synchronize()
    assert kperm.launch_rows(n, [w]) == 1_050_114
    assert kernels.LAUNCHES["permute_rows"] == 2
    assert torch.equal(got, x[perm])


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
def test_interaction_kernels_match_plain_past_227_kb_a_sample(self_interaction):
    """K13b at [120, 1024] (480 KB of X a sample): the streamed kernels, the
    forward after a lead of 3 floats (4-byte aligned rows), the backward
    from a strided gradient, each within one ULP of the plain versions'
    fmaf steps (which round twice, through float64, about once in 2^29) and
    rtol 1e-5, atol 1e-5 for the backward; counted apart."""
    _require_cuda()
    g = torch.Generator().manual_seed(120)
    B, F, D = 6, 120, 1024
    P = kint.num_pairs(F, self_interaction)
    assert kint.fwd_plan(F, D, self_interaction)[2] == kint.bwd_plan(F, D, 4, self_interaction)[1] == kint.STREAMED
    x = torch.randn((B, F, D), generator=g)
    grad = torch.randn((B, P), generator=g)
    buf = torch.zeros((B, 3 + P), device="cuda")
    gbuf = torch.zeros((B, 5 + P), device="cuda")
    gbuf[:, 5:] = grad.cuda()
    kernels.reset_launches()
    kint.interaction_fwd(x.cuda(), out=buf[:, 3:], self_interaction=self_interaction)
    got_dx = kint.interaction_bwd(x.cuda(), gbuf[:, 5:], self_interaction=self_interaction)
    torch.cuda.synchronize()
    mode = "interaction_self" if self_interaction else "interaction"
    assert kernels.LAUNCHES[mode + "_fwd_streamed"] == 1 and kernels.LAUNCHES[mode + "_bwd_streamed"] == 1
    assert kernels.LAUNCHES[mode + "_fwd"] == 0 and kernels.LAUNCHES[mode + "_bwd"] == 0
    torch.testing.assert_close(buf[:, 3:].cpu(), kint.interaction_fwd_plain(x, self_interaction), rtol=2**-23, atol=0)
    assert not bool(buf[:, :3].any())
    torch.testing.assert_close(got_dx.cpu(), kint.interaction_bwd_plain(x, grad, self_interaction), rtol=1e-5,
                               atol=1e-5)


# K13b's streamed kernels at the edges of their tiles, one sample just past 227 KB: F = 57 (a diagonal
# item's triangle short of its 15 rows), 121 (a second row block: a diagonal item of one row, two strips),
# 1000 (nine row blocks, D = 60 in one column block), F = 2 and 1 (one tile) with D past one column block,
# F = 241 (the backward's weights past the row block's staged-once tile: staged for each tile of dX)
STREAM_EDGES = [(3, 57, 1021, False), (3, 57, 1021, True), (2, 121, 481, False), (2, 121, 481, True),
                (2, 1000, 60, False), (2, 1000, 60, True), (2, 2, 29_100, False), (2, 2, 29_100, True),
                (2, 1, 58_200, True), (2, 241, 257, False), (2, 241, 257, True)]


@pytest.mark.parametrize("aligned", [False, True], ids=["lead1", "aligned"])
@pytest.mark.parametrize("B,F,D,self_interaction", STREAM_EDGES,
                         ids=[f"{f}-{d}-{'self' if m else 'strict'}" for _, f, d, m in STREAM_EDGES])
def test_interaction_streamed_kernels_at_the_tiles_edges(B, F, D, self_interaction, aligned):
    """The streamed kernels past 227 KB a sample, x after a 1-float lead
    (4-byte aligned rows: 4-byte copies) or aligned (16-byte copies where D
    % 4 == 0), the pairs into a strided [B, 3 + P] buffer, g from a strided
    buffer: the forward within one ULP of the plain version's fmaf steps
    (which round twice, through float64, about once in 2^29), the backward
    within rtol 1e-5, atol 1e-5; counted apart."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(F * 31 + D)
    P = kint.num_pairs(F, self_interaction)
    assert kint.fwd_plan(F, D, self_interaction)[2] == kint.bwd_plan(F, D, 4, self_interaction)[1] == kint.STREAMED
    lead = 0 if aligned else 1
    x = torch.randn(B * F * D + lead, device="cuda", generator=g)[lead:].view(B, F, D)
    buf = torch.zeros((B, 3 + P), device="cuda")
    gbuf = torch.randn((B, 5 + P), device="cuda", generator=g)
    kernels.reset_launches()
    kint.interaction_fwd(x, out=buf[:, 3:], self_interaction=self_interaction)
    got_dx = kint.interaction_bwd(x, gbuf[:, 5:], self_interaction=self_interaction)
    torch.cuda.synchronize()
    mode = "interaction_self" if self_interaction else "interaction"
    assert kernels.LAUNCHES[mode + "_fwd_streamed"] == 1 and kernels.LAUNCHES[mode + "_bwd_streamed"] == 1
    torch.testing.assert_close(buf[:, 3:], kint.interaction_fwd_plain(x, self_interaction), rtol=2**-23, atol=0)
    assert not bool(buf[:, :3].any())
    torch.testing.assert_close(got_dx, kint.interaction_bwd_plain(x, gbuf[:, 5:], self_interaction), rtol=1e-5,
                               atol=1e-5)


def _nonfinite_x(B, F, D, lead, seed):
    """float32 [B, F, D] on the card (its data ``lead`` floats past a 16-byte
    boundary) with inf, -inf and NaN: a lone one in a column, and two in one
    column (a row's own and another's)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B * F * D + lead, device="cuda", generator=g)[lead:].view(B, F, D)
    x[0, 1, 3], x[0, F - 2, 7], x[1, F // 3, D - 1] = float("inf"), -float("inf"), float("nan")
    x[1, 0, 0], x[1, F - 1, 0] = float("inf"), float("inf")
    return x, g


def _hold_nonfinite(x, g, self_interaction):
    """Both kernels on x against the plain versions: the forward within one
    ULP, the backward within 1e-5 (the plain version's fmaf rounds twice
    about once in 2^29), NaN and inf exactly where the plain version (which
    follows the reference, tests/test_torch_layers.py) has them."""
    B, F, D = x.shape
    P = kint.num_pairs(F, self_interaction)
    buf = torch.zeros((B, 3 + P), device="cuda")
    grad = torch.randn((B, 5 + P), device="cuda", generator=g)[:, 5:]
    kint.interaction_fwd(x, out=buf[:, 3:], self_interaction=self_interaction)
    dx = kint.interaction_bwd(x, grad, self_interaction)
    torch.cuda.synchronize()
    torch.testing.assert_close(buf[:, 3:], kint.interaction_fwd_plain(x, self_interaction), rtol=2**-23, atol=0,
                               equal_nan=True)
    want = kint.interaction_bwd_plain(x, grad, self_interaction)
    assert torch.equal(dx.isnan(), want.isnan()) and torch.equal(dx.isinf(), want.isinf())
    assert int(want.isnan().sum()) >= 3 * (F - 1)
    torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("aligned", [False, True], ids=["lead1", "aligned"])
@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
def test_interaction_streamed_kernels_skip_the_strict_diagonal(self_interaction, aligned):
    """NaN and infinities in x at [2, 57, 1024] (233 KB a sample): both
    streamed kernels equal the plain versions, NaN positions included. The
    strict backward takes the absent pair (i, i)'s zero weight as the
    reference does, so a non-finite x_i makes its own gradient NaN, and
    every other row of its column is NaN (_hold_nonfinite)."""
    _require_cuda()
    x, g = _nonfinite_x(2, 57, 1024, 0 if aligned else 1, 57)
    kernels.reset_launches()
    _hold_nonfinite(x, g, self_interaction)
    mode = "interaction_self" if self_interaction else "interaction"
    assert kernels.LAUNCHES[mode + "_bwd_streamed"] == 1


@pytest.mark.parametrize("aligned", [False, True], ids=["lead1", "aligned"])
@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
def test_interaction_staged_kernels_follow_the_reference_at_nonfinite_x(self_interaction, aligned):
    """The twin of the streamed test at DLRM's staged shape [2, 27, 16]
    (float4 columns where aligned, one float where not), and at [2, 27, 66]
    (more items a sample than the block has threads: the direct path)."""
    _require_cuda()
    for D in (16, 66):
        x, g = _nonfinite_x(2, 27, D, 0 if aligned else 1, D)
        kernels.reset_launches()
        _hold_nonfinite(x, g, self_interaction)
        mode = "interaction_self" if self_interaction else "interaction"
        assert kernels.LAUNCHES[mode + "_bwd"] == 1


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
def test_interaction_streamed_kernels_past_int32_pair_offsets(self_interaction):
    """B = 1, F = 60,000, D = 1: P = 1.8 billion pairs (7.2 GB of output, g
    another 7.2 GB), so a row's pair offset i (i - 1) / 2 (i (i + 1) / 2 in
    the self mode) passes int32 from row 46,342 (46,341). The forward's rows
    around it and its last row equal x[i] * x[:i] (x[:i + 1]) bit for bit
    (at D = 1 a pair is one fmaf from 0: the rounded product); the
    backward's rows there, its first and its last within 1e-5 of a float64
    sum over j (rtol against the sum of the terms' magnitudes)."""
    _require_cuda()
    F = 60_000
    P = kint.num_pairs(F, self_interaction)
    gen = torch.Generator(device="cuda").manual_seed(60)
    x = torch.randn((1, F, 1), device="cuda", generator=gen)
    xv = x[0, :, 0]

    def base(i):
        return i * (i + 1) // 2 if self_interaction else i * (i - 1) // 2

    rows = [0, 1, 46_339, 46_340, 46_341, 46_342, 46_343, 46_344, 46_345, F - 1]
    kernels.reset_launches()
    out = kint.interaction_fwd(x, self_interaction=self_interaction)
    torch.cuda.synchronize()
    for i in rows[1:]:
        n = i + 1 if self_interaction else i
        assert torch.equal(out[0, base(i): base(i) + n], xv[i] * xv[:n]), i
    del out
    grad = torch.randn((1, P), device="cuda", generator=gen)
    dx = kint.interaction_bwd(x, grad, self_interaction)
    torch.cuda.synchronize()
    mode = "interaction_self" if self_interaction else "interaction"
    assert kernels.LAUNCHES[mode + "_fwd_streamed"] == 1 and kernels.LAUNCHES[mode + "_bwd_streamed"] == 1
    j = torch.arange(F, device="cuda")
    for i in rows:
        w = grad[0, torch.where(j < i, base(i) + j, base(j) + i).clamp(max=P - 1)].double()  # j == i set below
        w[i] = 2 * grad[0, base(i) + i].double() if self_interaction else 0.0
        terms = w * xv.double()
        err = abs(float(dx[0, i, 0]) - float(terms.sum()))
        assert err <= 1e-5 * float(terms.abs().sum()) + 1e-5, (i, err)


def test_bucketize_kernel_takes_5000_bounds():
    """Past one block's 4,096 staged bounds: the count summed over two
    chunks in one launch, NaN and infinities included, bit for bit."""
    _require_cuda()
    g = torch.Generator().manual_seed(5000)
    bounds = torch.sort(torch.randn(5000, generator=g, dtype=torch.float64) * 100).values.float()
    x = torch.randn(20_003, generator=g) * 120
    x[:4] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0])
    x[4:10] = bounds[[0, 4095, 4096, 4097, 4999, 2000]]
    assert kbkt.bound_chunk(5000) == 4096
    kernels.reset_launches()
    got = kbkt.bucketize(x.cuda(), bounds.cuda())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bucketize"] == 1
    want = kbkt.bucketize_plain(x, bounds)
    assert torch.equal(got.cpu(), want) and int(want[0]) == 5000 and int(want[1]) == 5000 and int(want[2]) == 0


def test_cross_kernels_past_16776960_rows():
    """K17 at 16,777,217 rows of 2 columns, past gridDim.y's 65,535 blocks
    of 256 rows: the last rows' blocks loop, bit for bit; db within 1e-5 of
    the sum of its terms' magnitudes."""
    _require_cuda()
    B, N = 65_535 * 256 + 257, 2
    gen = torch.Generator(device="cuda").manual_seed(17)
    xw, x0, x, g = (torch.randn((B, N), device="cuda", generator=gen) for _ in range(4))
    b = torch.randn(N, device="cuda", generator=gen)
    assert kcross.row_blocks(B) == 65_535
    kernels.reset_launches()
    got = kcross.cross_fwd(xw, b, x0, x)
    dxw, dx0, db = kcross.cross_bwd(g, xw, b, x0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cross_fwd"] == 1 and kernels.LAUNCHES["cross_bwd"] == 1
    assert torch.equal(got, kcross.cross_fwd_plain(xw, b, x0, x))
    want = kcross.cross_bwd_plain(g, xw, b, x0)
    assert torch.equal(dxw, want[0]) and torch.equal(dx0, want[1])
    assert bool(((db - want[2]).abs() <= 1e-5 * (g * x0).abs().sum(0) + 1e-5).all())


def test_fm_backward_with_a_hot_row_out_of_range_ids_and_13000_dense_features():
    """K16's backward where a column's ids all fall on one row (its sum
    carried across a warp's tiles), other columns with out-of-range ids and
    13,000 dense features (past the old 12,288 of shared memory): dv within
    1e-5 of |g| sum_f |v|, ddense exact, dlinear and ddense_w within 1e-5
    of their terms' magnitudes."""
    _require_cuda()
    gen = torch.Generator().manual_seed(13_000)
    B, F, D, nd = 4099, 26, 16, 13_000
    sizes, offsets, ids, linear, dense_w = _fm_case(gen, B, F, D, nd, True)
    hot = sizes[1] // 2
    ids[1][:] = hot  # every id of column 1 on one row
    ids[3][:] = torch.randint(0, 3, (B,), generator=gen, dtype=torch.int32) % sizes[3]  # at most three hot rows
    v, dense, g = torch.randn((B, F, D), generator=gen), torch.randn((B, nd), generator=gen), torch.randn(B, generator=gen)
    vc, dc = _wide(v, 3, "cuda"), _wide(dense, 1, "cuda")
    kernels.reset_launches()
    dv, ddense, dlinear, ddense_w = kfm.fm_bwd(vc, dc, [i.cuda() for i in ids], offsets, sizes, dense_w.cuda(),
                                               g.cuda(), linear.shape[0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fm_bwd"] == 1
    want = kfm.fm_bwd_plain(v, dense, ids, offsets, sizes, dense_w, g, linear.shape[0])
    ga = g.abs()
    assert bool(((dv.cpu() - want[0]).abs() <= 1e-5 * ga[:, None, None] * v.abs().sum(1, keepdim=True) + 1e-6).all())
    assert torch.equal(ddense.cpu(), want[1])
    mag = kfm.fm_bwd_plain(v, dense.abs(), ids, offsets, sizes, dense_w, ga, linear.shape[0])
    assert bool(((dlinear.cpu() - want[2]).abs() <= 1e-5 * mag[2] + 1e-6).all())
    assert bool(((ddense_w.cpu() - want[3]).abs() <= 1e-5 * mag[3] + 1e-6).all())
    assert abs(float(dlinear[offsets[1] + hot]) - float(g.sum())) <= 1e-5 * float(ga.sum()) + 1e-6


@pytest.mark.parametrize("model_rank", [0, 1])
def test_range_gather_columns_matches_plain_at_70_columns_strided(model_rank):
    """K15d's forward past one launch's 64 columns (two launches), into the
    first 70 slots of a [B, 72, 16] buffer, bit for bit: held rows,
    another rank's zeros, and NaN for ids no rank holds on model rank 0."""
    _require_cuda()
    g = torch.Generator().manual_seed(71)
    B, C, D = 4133, 70, 16
    cards = [int(v) for v in torch.randint(1, 3000, (C,), generator=g)]
    local, ids, offsets, sizes, starts, padded = _shard_columns(g, B, cards, 4, 1, D)
    cols = (offsets, sizes, starts, padded)
    buf = torch.full((B, C + 2, D), 7.0, device="cuda")
    kernels.reset_launches()
    got = kemb.range_gather_columns(local.cuda(), [i.cuda() for i in ids], *cols, model_rank, out=buf[:, :C])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["range_gather_columns"] == 2
    want = kemb.range_gather_columns_plain(local, ids, *cols, model_rank)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)) or (
        torch.equal(got.cpu().isnan(), want.isnan()) and torch.equal(got.cpu().nan_to_num(), want.nan_to_num()))
    assert bool(want.isnan().any()) == (model_rank == 0)
    assert bool((buf[:, C:] == 7.0).all())


def test_embedding_gather_and_bag_past_2_31_elements():
    """K13a's gather of [264,209, 64, 127] (2^31 + 7,104 floats, one a
    thread) and K13c's forward of 2,100,000 bags of 1,023 floats (one a
    thread): two launches of row chunks each, bit for bit against the plain
    versions."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(31)
    B, C, D = 264_209, 64, 127
    sizes = [1000] * C
    offsets = [1000 * c for c in range(C)]
    table = torch.randn((sum(sizes), D), device="cuda", generator=gen)
    ids = [torch.randint(-5, 1005, (B,), device="cuda", generator=gen, dtype=torch.int32) for _ in range(C)]
    assert B * C * D > 2**31 and kemb.launch_rows(B, C, D, 1) == 264_208
    kernels.reset_launches()
    got = kemb.embedding_gather(table, ids, offsets, sizes)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_gather"] == 2
    assert torch.equal(got.view(torch.int32), kemb.embedding_gather_plain(table, ids, offsets, sizes).view(torch.int32))
    del got, ids, table
    torch.cuda.empty_cache()
    Bb, Db = 2_100_000, 1023
    tb = torch.randn((7, Db), device="cuda", generator=gen)
    values = torch.randint(0, 7, (Bb, 1), device="cuda", generator=gen, dtype=torch.int32)
    mask = torch.ones((Bb, 1), device="cuda")
    assert kbag.fwd_rows(Bb, Db, 1) == 2_099_202
    kernels.reset_launches()
    got = kbag.embedding_bag_fwd(tb, values, mask, "sum")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["embedding_bag_fwd"] == 2
    assert torch.equal(got, kbag.embedding_bag_fwd_plain(tb, values, mask, "sum"))


# --- K1's persistent search and K14's tiles of rows, at their edges ---------------------------------------------
def _tiny_rows(rng):
    """Tiny tables of 1, 2, 2,209 and 4,096 keys (INT32_MIN and INT32_MAX
    among them) and an empty one, codes 3, 4, ..."""
    big = [rng.permutation(np.unique(rng.integers(I32_MIN, I32_MAX, int(v * 1.05))))[:v].astype(np.int32)
           for v in (2209, 4096)]
    for k in big:
        k[:2] = [I32_MIN, I32_MAX]
    keysets = [np.array([5], np.int32), np.array([I32_MAX, I32_MIN], np.int32), *big, np.zeros(0, np.int32)]
    return plookup.BatchedTiny([plookup.TinyLookup(k, np.arange(len(k)) + 3) for k in keysets]), keysets


def _on_card(t, offset):
    """``t`` on the card, as a view ``offset`` elements past an aligned start."""
    if not offset:
        return t.cuda()
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device="cuda")
    view = buf[offset:].view(t.shape)
    view.copy_(t.cuda())
    return view


@pytest.mark.parametrize("layout", ["aligned", "unaligned_view"])
@pytest.mark.parametrize("nbuckets", [False, True], ids=["one_oov", "hashed_oov"])
@pytest.mark.parametrize("with_validity", [False, True])
@pytest.mark.parametrize("C,N", [(1, 262_147), (70, 30_001)], ids=["solo", "70_columns"])
def test_tiny_lookup_kernel_matches_plain_at_its_edges(C, N, with_validity, nbuckets, layout):
    """K1 against tiny_lookup_plain on the card: tables of 0, 1, 2, 2,209
    and 4,096 keys, the one-key row shared by several columns, keys and
    values at INT32_MIN and INT32_MAX, 20% misses, invalid rows, several OOV
    buckets a column; one column (the solo branch's counter) or 70, N not a
    multiple of 4 (every column but the first starts unaligned), and the
    values and validity as views one element past an aligned start (the
    kernel's scalar loads)."""
    _require_cuda()
    rng = np.random.default_rng(20 + C)
    blut, keysets = _tiny_rows(rng)
    sel = [3] if C == 1 else [0, 0, 1, 2, 0, 3, 4, 0][:C] * (C // 8) + [0, 2, 3, 1, 0, 4][: C % 8]
    values = _queries(rng, [keysets[s] if len(keysets[s]) else np.array([7], np.int32) for s in sel], N)
    validity = torch.from_numpy(rng.random(values.shape) > 0.1) if with_validity else None
    offset = 1 if layout == "unaligned_view" else 0
    v = _on_card(values, offset)
    val = None if validity is None else _on_card(validity, offset)
    if offset:
        assert v.data_ptr() % 16 != 0 and (val is None or val.data_ptr() % 4 != 0)
    sel_t = torch.tensor(sel, dtype=torch.int32, device="cuda")
    offs = torch.arange(C, dtype=torch.int32, device="cuda") * 11
    nb = torch.tensor(rng.choice([1, 1000, 7, 2**31 - 1], C), dtype=torch.int32, device="cuda") if nbuckets else None
    dev = blut.to("cuda")
    counter = "tiny_lookup_solo" if C == 1 else None
    kernels.reset_launches()
    got = klk.tiny_lookup(v, val, dev.keys, dev.codes, dev.lens, sel_t, offs, nbuckets=nb, counter=counter)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[counter or "tiny_lookup"] == 1
    want = klk.tiny_lookup_plain(v, val, dev.keys, dev.codes, dev.lens, sel_t, offs, nbuckets=nb)
    assert torch.equal(got, want)


def _out_of_range(perm, n):
    """``perm`` with entries outside [0, n) at a few rows, and the rows."""
    bad = torch.tensor([0, 7, 1000, n - 1], device=perm.device)
    hi = 2**40 if perm.dtype == torch.int64 else 2**31 - 1
    perm = perm.clone()
    perm[bad] = torch.tensor([-1, n, hi, -(2**31)], dtype=perm.dtype, device=perm.device)
    return perm, bad


@pytest.mark.parametrize("layout", ["aligned", "unaligned_views"])
@pytest.mark.parametrize("perm_dtype", [torch.int64, torch.int32])
def test_permute_rows_kernel_matches_plain_at_its_widths(perm_dtype, layout):
    """K14 against permute_rows_plain: int8, int16, int32, float32 and int64
    columns beside [n, 4] int32 (the multihot lists), [n, 2] int32, [n, 8]
    float32, [n, 13] float32 and [n, 3] int16 blocks;
    int32 and int64 permutations with entries outside [0, n) giving zero
    rows; n not a multiple of the 4 rows a thread takes; every source and
    the permutation as views one element past an aligned start (the
    kernel's narrower elements, scalar permutation loads and stores)."""
    _require_cuda()
    g = torch.Generator().manual_seed(14)
    n = 100_003
    arrays = {
        "i8": torch.randint(-128, 127, (n,), dtype=torch.int8, generator=g),
        "i16": torch.randint(-(2**15), 2**15 - 1, (n,), dtype=torch.int16, generator=g),
        "i32": torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, generator=g),
        "f32": torch.randn(n, generator=g),
        "i64": torch.randint(-(2**62), 2**62, (n,), generator=g),
        "lists": torch.randint(-(2**31), 2**31 - 1, (n, 4), dtype=torch.int32, generator=g),
        "pairs": torch.randint(-(2**31), 2**31 - 1, (n, 2), dtype=torch.int32, generator=g),
        "wide8": torch.randn((n, 8), generator=g),
        "dense": torch.randn((n, 13), generator=g),
        "i16x3": torch.randint(-(2**15), 2**15 - 1, (n, 3), dtype=torch.int16, generator=g),
    }
    offset = 1 if layout == "unaligned_views" else 0
    on_card = {k: _on_card(v, offset) for k, v in arrays.items()}
    perm, bad = _out_of_range(torch.randperm(n, generator=g).to(perm_dtype).cuda(), n)
    perm = _on_card(perm, offset)
    elems = [kperm.element_bytes(v[0].numel() * v.element_size(), v.data_ptr()) for v in on_card.values()]
    assert elems == [1, 2, 4, 4, 4, 4, 4, 4, 4, 2]
    kernels.reset_launches()
    got = kperm.permute_rows(on_card, perm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["permute_rows"] == 1
    inside = perm.clone()
    inside[bad] = 0
    want = kperm.permute_rows_plain(on_card, inside)
    for k, w in want.items():
        w[bad] = 0
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_permute_rows_kernel_tiles_every_row_count():
    """Row counts around a thread's 4 rows and a block's tile of 1,024: 1,
    3, 4, 5, 1,023, 1,024, 1,025, 4,099; every array bit for bit."""
    _require_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    for n in (1, 3, 4, 5, 1023, 1024, 1025, 4099):
        arrays = {"i16": torch.randint(-(2**15), 2**15 - 1, (n,), dtype=torch.int16, device="cuda", generator=g),
                  "i32": torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32, device="cuda", generator=g),
                  "dense": torch.randn((n, 13), device="cuda", generator=g)}
        perm = torch.randperm(n, device="cuda", generator=g)
        got = kperm.permute_rows(arrays, perm)
        torch.cuda.synchronize()
        for k, v in kperm.permute_rows_plain(arrays, perm).items():
            assert torch.equal(got[k], v), (n, k)


# --- K18: the training step's Adagrad update ---------------------------------------------------------------------
def _adagrad_inputs(case, gen):
    """(params, accumulators, gradients) on the card for a case of
    test_adagrad_kernel_matches_plain."""
    def rand(n):
        return torch.randn(n, device="cuda", generator=gen)

    if case == "one":
        lengths = [999_983]  # a prime near 10^6: a tail unit of 3 floats
    elif case == "lengths_1_to_7":
        lengths = list(range(1, 8))
    elif case == "70_tensors":  # two launches: 64 tensors, then 6
        lengths = [int(n) for n in torch.randint(1, 300, (70,), generator=torch.Generator().manual_seed(0))]
    else:
        lengths = [4099, 16, 5, 1]
    if case == "offset_views":  # contiguous views 1-3 floats into their buffers: no 16-byte alignment, the scalar path
        ps = [rand(n + 3)[1:][:n] for n in lengths]
        accs = [(rand(n + 3).abs() + 0.1)[2:][:n] for n in lengths]
        gs = [rand(n + 3)[3:][:n] for n in lengths]
    else:
        ps = [rand(n) for n in lengths]
        accs = [rand(n).abs() + 0.1 for n in lengths]
        gs = [rand(n) for n in lengths]
    for g in gs:  # rows of 16 floats with an all-zero gradient, as an embedding table's untouched rows
        rows = g[: g.numel() // 16 * 16].view(-1, 16)
        rows[torch.rand(rows.shape[0], device="cuda", generator=gen) < 0.7] = 0.0
        g[torch.rand(g.shape, device="cuda", generator=gen) < 0.2] = 0.0
    if case == "nonfinite":
        ps[0][:8] = -0.0
        gs[0][:8] = torch.tensor([-0.0, 0.0, -0.0, 0.0, 1.0, -0.0, 0.0, 0.0], device="cuda")
        gs[0][100:104] = torch.tensor([float("nan"), float("inf"), -float("inf"), 1.0], device="cuda")
        accs[0][200:204] = float("nan")
        gs[0][200:204] = torch.tensor([0.5, 0.0, 0.0, 0.0], device="cuda")
        accs[1][3] = float("nan")  # in a unit whose gradient is nonzero
        gs[1][3] = 2.0
        gs[2][:4] = float("nan")
    return ps, accs, gs


def _bits_equal_nan(got, want):
    """Equal bits, NaN where NaN (the plain step's adds give the card's canonical NaN)."""
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)) and bool(
        torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


@pytest.mark.parametrize("case", ["one", "lengths_1_to_7", "70_tensors", "offset_views", "nonfinite"])
def test_adagrad_kernel_matches_plain(case):
    """K18 against adagrad_update_plain on the card from the same state,
    three steps: parameters and accumulators bit-equal, NaN where the plain
    step has NaN (NaN or inf gradients, NaN accumulators), -0.0 and +0.0
    as the plain step leaves them; one launch a step for each 64 tensors."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import adagrad as kada

    gen = torch.Generator(device="cuda").manual_seed(7)
    ps, accs, gs = _adagrad_inputs(case, gen)
    want_p, want_a = [p.clone() for p in ps], [a.clone() for a in accs]
    kernels.reset_launches()
    for _ in range(3):
        kada.adagrad_update(ps, accs, gs, 1e-2)
        kada.adagrad_update_plain(want_p, want_a, gs, 1e-2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["adagrad_update"] == 3 * -(-len(ps) // kada.MAX_SEGMENTS)
    for i, (p, a, wp, wa) in enumerate(zip(ps, accs, want_p, want_a)):
        assert _bits_equal_nan(p, wp), (i, float((p - wp).abs().nan_to_num().max()))
        assert _bits_equal_nan(a, wa), (i, float((a - wa).abs().nan_to_num().max()))
    if case == "nonfinite":
        assert torch.equal(torch.signbit(ps[0][:8]), torch.signbit(want_p[0][:8]))
        assert bool(torch.isnan(ps[0][100:102]).all()) and bool(torch.isnan(ps[2][:4]).all())


def test_adagrad_kernel_leaves_zero_gradient_bytes():
    """An all-zero gradient: K18 reads it in full and leaves every byte of
    the parameters and accumulators as it was, -0.0 and NaN payloads
    included."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import adagrad as kada

    gen = torch.Generator(device="cuda").manual_seed(8)
    ps = [torch.randn(n, device="cuda", generator=gen) for n in (1_000_003, 16, 3)]
    accs = [torch.rand(n, device="cuda", generator=gen) + 0.1 for n in (1_000_003, 16, 3)]
    ps[0][:3] = torch.tensor([-0.0, float("nan"), float("inf")], device="cuda")
    ps[0].view(torch.int32)[5] = 0x7FC00123  # a NaN with a payload
    accs[0][:2] = torch.tensor([-0.0, float("nan")], device="cuda")
    before_p, before_a = [p.clone() for p in ps], [a.clone() for a in accs]
    kada.adagrad_update(ps, accs, [torch.zeros_like(p) for p in ps], 1e-2)
    torch.cuda.synchronize()
    for p, a, bp, ba in zip(ps, accs, before_p, before_a):
        assert torch.equal(p.view(torch.int32), bp.view(torch.int32))
        assert torch.equal(a.view(torch.int32), ba.view(torch.int32))


def test_adagrad_update_on_the_card_rejects_mixed_devices():
    _require_cuda()
    from nvtabular_tpu_torch.kernels import adagrad as kada

    p, a = torch.zeros(8, device="cuda"), torch.full((8,), 0.1, device="cuda")
    for g in (torch.ones(8), torch.ones(16, device="cuda")[::2], torch.ones(8, device="cuda", dtype=torch.float64)):
        with pytest.raises((TypeError, ValueError)):
            kada.adagrad_update([p], [a], [g], 1e-2)
    kernels.reset_launches()
    kada.adagrad_update([torch.zeros(0, device="cuda")], [torch.zeros(0, device="cuda")],
                        [torch.zeros(0, device="cuda")], 1e-2)
    assert kernels.LAUNCHES["adagrad_update"] == 0  # nothing to launch


def test_dlrm_adagrad_steps_through_the_kernel_match_plain():
    """Three Adagrad steps of a small DLRM through Adagrad.step (K18, one
    launch a step for its 13 tensors) against the same steps through
    adagrad_update_plain on a copy of the model given the same gradients:
    every parameter and accumulator bit-equal."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import adagrad as kada

    config = models.DLRMConfig({"a": 3, "b": 500, "c": 40_000}, num_dense=13, embedding_dim=16)
    model, copy = models.DLRM(config, seed=1), models.DLRM(config, seed=1)
    opt = models.Adagrad(model.parameters())
    accs = [torch.full_like(p, 0.1) for p in copy.parameters()]
    batches = [{k: torch.from_numpy(v).cuda() for k, v in models.make_synthetic_batch(config, 4096, seed=s).items()}
               for s in range(3)]
    kernels.reset_launches()
    for batch in batches:
        opt.zero_grad()
        models.dlrm_loss(model, batch).backward()
        grads = [p.grad.clone() for p in model.parameters()]
        opt.step()
        with torch.no_grad():
            kada.adagrad_update_plain(list(copy.parameters()), accs, grads, opt.lr)
    torch.cuda.synchronize()
    assert len(opt.params) == 13 and kernels.LAUNCHES["adagrad_update"] == 3
    for (name, p), q, a, b in zip(model.named_parameters(), copy.parameters(), opt.sum_of_squares, accs):
        assert torch.equal(p.detach(), q.detach()), name
        assert torch.equal(a, b), name


# --- K19: the MLP layer epilogue and the rounds; K20: the loss ----------------------------------------------------
EPILOGUE_MODES = {  # (relu, round_dtype): a hidden layer, a last layer with and without ReLU, float32, float16
    "relu_round": (True, torch.bfloat16), "relu": (True, None), "bias": (False, None),
    "relu_round_f16": (True, torch.float16), "round": (False, torch.bfloat16),
}
SUBNORMAL = 2.0**-140  # a positive float32 that rounds to bfloat16 zero


def _epilogue_inputs(B, N, gen, row_pad=0):
    """y [B, N] and b [N] on the card with the edges among them: -0.0 + -0.0,
    NaN, +-inf, a value halfway between two bfloat16 values (round to
    even), a positive subnormal pre-activation; and g [B, N], a view of a
    [B, N + row_pad] buffer when row_pad, with NaN and +-inf."""
    y = torch.randn((B, N), device="cuda", generator=gen) * 3
    b = torch.randn(N, device="cuda", generator=gen)
    edges = torch.tensor([-0.0, float("nan"), float("inf"), -float("inf"), 1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8,
                          SUBNORMAL, -2.0], device="cuda")
    flat = y.view(-1)
    k = min(flat.numel(), edges.numel())
    flat[:k] = edges[:k]
    b[0] = -0.0 if N > 1 else 0.0
    if B > 1:
        y[2::5, N - 1] = -b[N - 1]  # exact cancellation: z = +0.0
    gbuf = torch.randn((B, N + row_pad), device="cuda", generator=gen)
    g = gbuf[:, :N]
    gflat = g.reshape(-1) if row_pad == 0 else None
    if gflat is not None and gflat.numel() > 12:
        gflat[6:12] = torch.tensor([float("nan"), float("inf"), -float("inf"), 1.0 + 2.0**-8, SUBNORMAL, -0.0],
                                   device="cuda")
    return y, b, g


@pytest.mark.parametrize("mode", list(EPILOGUE_MODES))
@pytest.mark.parametrize("N", [1, 3, 13, 367, 512])
@pytest.mark.parametrize("B", [1, 7, 65536])
def test_mlp_epilogue_kernels_match_plain(B, N, mode):
    """K19's backward against its plain version on the card from the same
    inputs and the mask of the plain forward epilogue (the forward runs in
    K21's store, held against that plain forward by
    test_k21_fused_forward_matches_matmul_and_k19): dz bit-equal (NaN where
    NaN), db within 1e-5 of the sums of |dz| and the same bits over two
    runs, a launch each; the mask at the edges as the backward reads it."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_epilogue as kep

    relu, rnd = EPILOGUE_MODES[mode]
    gen = torch.Generator(device="cuda").manual_seed(B * 1000 + N)
    y, b, g = _epilogue_inputs(B, N, gen)
    kernels.reset_launches()
    mask = kep.mlp_epilogue_fwd_plain(y, b, relu, rnd)
    dz, db = kep.mlp_epilogue_bwd(g, mask, relu, rnd)
    want_dz, want_db = kep.mlp_epilogue_bwd_plain(g, mask, relu, rnd)
    dz2, db2 = kep.mlp_epilogue_bwd(g, mask, relu, rnd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mlp_epilogue_bwd"] == 2
    assert (mask is None) == (not relu)
    assert _bits_equal_nan(dz, want_dz)
    magnitude = want_dz.abs().nan_to_num(posinf=0.0).sum(0)
    finite = torch.isfinite(want_db)
    assert torch.equal(torch.isnan(db), torch.isnan(want_db)) and torch.equal(db[~finite].nan_to_num(),
                                                                             want_db[~finite].nan_to_num())
    assert bool(((db - want_db)[finite].abs() <= 1e-5 * magnitude[finite] + 1e-5).all())
    assert torch.equal(db.view(torch.int32), db2.view(torch.int32)) and torch.equal(dz2.view(torch.int32),
                                                                                   dz.view(torch.int32))
    if relu and B * N > 8:
        z = y.view(-1)[:8]
        assert not torch.signbit(z[0])  # -0.0 + -0.0 -> +0.0, mask 0
        if rnd is torch.bfloat16 and b.view(-1)[6 % N] == 0:  # the subnormal pre-activation: rounded to 0, mask 1
            assert float(z[6]) == 0.0 and bool(mask.view(-1)[6])


@pytest.mark.parametrize("mode", ["relu_round", "bias"])
def test_mlp_epilogue_backward_takes_strided_rows(mode):
    """g as a [B, N] view of a [B, N + 3] buffer (DCN's last deep layer
    takes its gradient from a concatenation's)."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_epilogue as kep

    relu, rnd = EPILOGUE_MODES[mode]
    gen = torch.Generator(device="cuda").manual_seed(3)
    y, b, g = _epilogue_inputs(4099, 128, gen, row_pad=3)
    mask = kep.mlp_epilogue_fwd_plain(y, b, relu, rnd)
    dz, db = kep.mlp_epilogue_bwd(g, mask, relu, rnd)
    want_dz, want_db = kep.mlp_epilogue_bwd_plain(g, mask, relu, rnd)
    assert _bits_equal_nan(dz, want_dz)
    torch.testing.assert_close(db, want_db, rtol=1e-5, atol=1e-5)


def _round_inputs(gen):
    """Lengths 0, 1, 3, 5 and 999,983, a [4099, 367] tensor (DLRM's top
    input: rows not 16-byte aligned), the tabular MLP's [4099, 1041] view of
    a [4099, 1044] buffer, an offset view, each with the edges among its
    values."""
    ts = [torch.randn(n, device="cuda", generator=gen) * 3 for n in (0, 1, 3, 5, 999_983)]
    ts.append(torch.randn((4099, 367), device="cuda", generator=gen))
    ts.append(torch.randn((4099, 1044), device="cuda", generator=gen)[:, :1041])
    ts.append(torch.randn(1003, device="cuda", generator=gen)[3:])
    edges = [-0.0, float("nan"), float("inf"), -float("inf"), 1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, SUBNORMAL,
             3.4e38, 65520.0, 2.0**-25]
    for t in ts[4:]:
        flat = t.view(-1) if t.is_contiguous() else t[0]
        flat[: len(edges)] = torch.tensor(edges, device="cuda")
    return ts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_round_group_kernel_matches_plain(dtype):
    """One round_group launch over 8 tensors (lengths 0 to 999,983, rows of
    367 floats, a row-strided [4099, 1041] view): bit-equal to the plain
    casts, NaN where NaN, inputs untouched; 70 tensors take two launches."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_epilogue as kep

    gen = torch.Generator(device="cuda").manual_seed(5)
    ts = _round_inputs(gen)
    before = [t.clone() for t in ts]
    kernels.reset_launches()
    got = kep.round_group(ts, dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["round_group"] == 1
    for t, b0, a, w in zip(ts, before, got, kep.round_group_plain(ts, dtype)):
        assert a.shape == t.shape and a.is_contiguous() and _bits_equal_nan(a, w)
        assert _bits_equal_nan(t, b0)
    many = [torch.randn(int(n), device="cuda", generator=gen) for n in torch.randint(1, 300, (70,))]
    kernels.reset_launches()
    got = kep.round_group(many, dtype)
    assert kernels.LAUNCHES["round_group"] == 2
    assert all(_bits_equal_nan(a, w) for a, w in zip(got, kep.round_group_plain(many, dtype)))


BCE_LOGITS = [0.0, -0.0, 1e-30, -1e-30, 100.0, -100.0, float("inf"), -float("inf"), float("nan"), 2.0, -3.0]


@pytest.mark.parametrize("B", [1, 5, 7, 65536, 65537])
@pytest.mark.parametrize("edges", [False, True])
def test_bce_kernels_match_plain(B, edges):
    """K20's loss within rtol 1e-6 of the plain version's (NaN where NaN)
    and its gradient bit-equal for grad_output 2.5, labels 0, 1 and 0.3,
    the edge logits among the rest; one launch each."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import bce as kbce

    gen = torch.Generator(device="cuda").manual_seed(B)
    logits = torch.randn(B, device="cuda", generator=gen) * 4
    labels = (torch.rand(B, device="cuda", generator=gen) < 0.3).float()
    labels[::7] = 0.3
    if edges:
        k = min(B, len(BCE_LOGITS))
        logits[:k] = torch.tensor(BCE_LOGITS[:k], device="cuda")
    gout = torch.tensor(2.5, device="cuda")
    kernels.reset_launches()
    loss, dl = kbce.bce_fwd(logits, labels), kbce.bce_bwd(logits, labels, gout)
    loss2 = kbce.bce_fwd(logits, labels)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bce_fwd"] == 2 and kernels.LAUNCHES["bce_bwd"] == 1
    want, want_dl = kbce.bce_fwd_plain(logits, labels), kbce.bce_bwd_plain(logits, labels, gout)
    assert loss.shape == () and torch.equal(loss.view(torch.int32), loss2.view(torch.int32))
    if torch.isnan(want):
        assert torch.isnan(loss)
    else:
        torch.testing.assert_close(loss, want, rtol=1e-6, atol=0.0)
    assert _bits_equal_nan(dl, want_dl)


def test_bce_through_autograd_reads_grad_output_on_the_card():
    """bce_with_logits on a strided [B] view: one K20 launch each way, the
    gradient for a grad_output of 2.5 equal to the plain version's, labels
    that require a gradient refused."""
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    buf = torch.randn((4097, 3), device="cuda", generator=gen)
    labels = (torch.rand(4097, device="cuda", generator=gen) < 0.5).float()
    grads = []
    for plain in (False, True):
        src = buf.clone().requires_grad_(True)
        kernels.reset_launches()
        loss = models.bce_with_logits(src[:, 1], labels, plain=plain)  # a [B] view of stride 3
        (loss * 2.5).backward()
        grads.append(src.grad[:, 1])
        assert kernels.LAUNCHES["bce_fwd"] == kernels.LAUNCHES["bce_bwd"] == int(not plain)
    assert _bits_equal_nan(grads[0], grads[1])
    with pytest.raises(ValueError):
        models.bce_with_logits(buf[:, 0], labels.clone().requires_grad_(True))


def _step_launches(model):
    """K19's, K20's and K21's launches in one training step of ``model``,
    from its layers: a K21 forward (the layer's epilogue in its store), an epilogue
    backward and a weight gradient a layer, an input gradient a layer but
    the first of DLRM's bottom MLP (its input is data); a K21 forward, input
    and weight gradient a cross layer; a round forward and backward an MLP
    and a cross layer, where the compute dtype rounds; one loss each way."""
    from nvtabular_tpu_torch.models.deepfm import CrossNetwork
    from nvtabular_tpu_torch.models.layers import MLP

    n = {"mlp_epilogue_bwd": 0, "round_group": 0, "bce_fwd": 1, "bce_bwd": 1, "mlp_mm_fwd": 0, "mlp_mm_dgrad": 0,
         "mlp_mm_wgrad": 0, "mlp_mm_fwd_epilogue": 0}
    dense_input = getattr(model, "bottom", None)
    for m in model.modules():
        rounds = m.compute_dtype != torch.float32 if isinstance(m, (MLP, CrossNetwork)) else False
        if isinstance(m, (MLP, CrossNetwork)):
            n["mlp_mm_fwd"] += len(m.weights)
            n["mlp_mm_wgrad"] += len(m.weights)
            n["mlp_mm_dgrad"] += len(m.weights) - (m is dense_input)
        if isinstance(m, MLP):
            n["mlp_mm_fwd_epilogue"] += len(m.weights)
            n["mlp_epilogue_bwd"] += len(m.weights)
            n["round_group"] += 2 * rounds
        elif isinstance(m, CrossNetwork):
            n["round_group"] += 2 * len(m.weights) * rounds
    return n


def _plain_steps(make, reference, batches, products):
    """A model from ``make`` trained one Adagrad step a batch through the
    reference forward and the plain loss, the plain path's products as
    ``products`` makes them (mlp_mm.plain_products) → (losses, parameters)."""
    from nvtabular_tpu_torch.kernels.mlp_mm import plain_products

    ref = make()
    opt = models.Adagrad(ref.parameters())
    with plain_products(products):
        losses = [float(models.train_step(ref, opt, b, lambda m, bt: models.bce_with_logits(
            reference(m, bt).reshape(-1), bt["label"], plain=True))) for b in batches]
    return losses, [p.detach() for p in ref.parameters()]


def _steps_apart(a, b):
    """(the largest loss difference over the loss, the largest parameter
    difference over the parameter's largest entry) of two runs."""
    loss = max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0]))
    return loss, max(float((p - q).abs().max()) / max(float(q.abs().max()), 1e-30) for p, q in zip(a[1], b[1]))


@pytest.mark.parametrize("family", ["dlrm", "dcn", "tabular"])
def test_training_steps_through_k19_k20_match_plain(family):
    """Three Adagrad steps in bfloat16 compute through the kernels (K21 and
    K19 a layer, its rounds, K20) against three from the same parameters
    through the reference forward and the plain loss. With K21's products
    on the plain path too: the losses within rtol 1e-5, every parameter
    within 1e-3 of its largest entry (a hidden value at a bfloat16 rounding
    boundary may round the other way, chip_smoke.py STEP_TOL). With
    cuBLAS's products, a reference without K21: both within 4x the largest
    that a change of the products' order alone moves (cuBLAS's, float64's
    and cuBLAS's over the reversed depth, pairwise; chip_smoke.py
    K21_STEP_FACTOR) plus those limits. The launches those the layers give."""
    _require_cuda()
    cards = {"a": 3, "b": 500, "c": 40_000}
    if family == "dlrm":
        make = lambda: models.DLRM(models.DLRMConfig(cards, num_dense=13, embedding_dim=16), seed=1)
        reference, loss_fn = models.reference_forward, models.dlrm_loss
    elif family == "dcn":
        make = lambda: models.DCN(models.DCNConfig(cards, num_dense=13), seed=1)
        reference, loss_fn = models.dcn_reference_forward, models.dcn_loss
    else:
        config = models.TabularMLPConfig({"a": (3, 8), "b": (500, 16), "c": (40_000, 16)}, num_continuous=13,
                                         layer_sizes=(128, 64))
        make = lambda: models.TabularMLP(config, seed=1)
        reference, loss_fn = models.tabular_reference_forward, models.tabular_mlp_loss
    batches = [{k: torch.from_numpy(v).cuda() for k, v in models.make_synthetic_batch(
        models.DLRMConfig(cards, num_dense=13), 4096, seed=s).items()} for s in range(3)]
    for batch in batches:
        batch["continuous"] = batch["dense"]
    model = make()
    opt = models.Adagrad(model.parameters())
    kernels.reset_launches()
    got = [float(models.train_step(model, opt, b, loss_fn)) for b in batches]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    got = (got, [p.detach() for p in model.parameters()])
    want = _plain_steps(make, reference, batches, "k21")
    assert {k: launches[k] for k in _step_launches(model)} == {k: 3 * v for k, v in _step_launches(model).items()}
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for (name, _), p, q in zip(model.named_parameters(), got[1], want[1]):
        assert float((p - q).abs().max()) <= 1e-3 * float(q.abs().max()) + 1e-6, name
    cublas, f64, rev = (_plain_steps(make, reference, batches, kind) for kind in ("matmul", "float64", "reversed"))
    noise = [max(x) for x in zip(_steps_apart(cublas, f64), _steps_apart(rev, f64), _steps_apart(rev, cublas))]
    loss, params = _steps_apart(got, cublas)
    assert loss <= 4 * noise[0] + 1e-5 and params <= 4 * noise[1] + 1e-3, (loss, params, noise)


# --- K21: the MLP and cross-layer products on the tensor cores -------------------------------------------------
# (M, K, N) of a layer: the forward h [M, K] w [K, N], the input gradient dz [M, N] w^T, the weight gradient
# h^T dz. The main paths' layers: DLRM's (phase 7) and its multihot bottom, DeepFM's and DCN's deep towers, DCN's
# output layer and cross layer, the tabular MLP's.
K21_MAIN_SHAPES = [(65536, 13, 512), (65536, 512, 256), (65536, 256, 16), (65536, 367, 512), (65536, 256, 1),
                   (65536, 1, 512), (65536, 256, 64), (65536, 429, 256), (65536, 256, 128), (65536, 128, 1),
                   (65536, 557, 1), (65536, 429, 429), (65536, 1041, 512)]
# tiles' edges: M not a multiple of 64 or 128, K not a multiple of 16 or 32, N past each tile width, K = 0; and the
# paths' edges (kmm.NARROW_MAX = 16): K = 1, 13, 16, 17, N = 1, 16, 17, 257, M = 13, each product of a layer on
# either side of it (the forward [M, K] x [K, N], the input gradient [M, N] x [N, K], the weight gradient [K, M]
# x [M, N])
K21_EDGE_SHAPES = [(1, 1, 1), (100, 13, 1), (77, 5, 3), (64, 16, 8), (130, 40, 70), (129, 33, 129),
                   (200, 17, 65), (3, 0, 5), (1000, 1000, 9), (4097, 600, 17), (300, 16, 300), (300, 17, 300),
                   (13, 300, 257), (17, 300, 257), (700, 300, 16), (700, 300, 17), (1000, 257, 1), (333, 1, 257)]


def _k21_terms(M, N, K, a_pieces, b_pieces):
    """The products a sum of ``C[M, N] = A[M, K] B[K, N]`` adds on the path
    the plan takes (the narrow path sums the float32 values as they are)."""
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    return kmm.mm_plan(M, N, K, a_pieces, b_pieces).terms(K, a_pieces, b_pieces)


def _k21_bound(A, B, terms, split=False):
    """2 gamma_terms (|A| |B|) in float64, and terms * 2^-149 where the sums
    are float32 subnormals; with a split operand A, also 2^-134 (|B| summed)
    for the pieces of A's values below 2^-110 (csrc/mlp_mm.cu split3x2)."""
    u = 2.0**-24
    mag = A.double().abs() @ B.double().abs()
    bnd = 2 * terms * u / (1 - terms * u) * mag + terms * 2.0**-149
    if split:
        bnd = bnd + 2.0**-134 * B.double().abs().sum(0, keepdim=True)
    return bnd


def _k21_close(got, want, bnd, what):
    """Within the bound where the plain product is finite; the same NaN and
    inf where it is not."""
    assert got.shape == want.shape, what
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf]), what
    fin = torch.isfinite(want)
    diff = (got.double() - want.double()).abs()
    assert bool((diff[fin] <= bnd[fin]).all()), (what, float(diff[fin].max()) if fin.any() else 0.0)


def _k21_layer(M, K, N, gen, exact_dz=True, edges=False):
    """A layer's bfloat16-valued h [M, K] and w [K, N], a bias [N], and an
    output gradient [M, N]: bfloat16 values (a hidden layer's rounded dz) or
    float32 ones (the last layer's, a cross layer's x0 * g). ``edges``: NaN,
    +-inf and -0.0 among the operands."""
    h = torch.randn((M, K), device="cuda", generator=gen).bfloat16().float()
    w = (torch.randn((K, N), device="cuda", generator=gen) * max(K, 1) ** -0.5).bfloat16().float()
    b = torch.randn(N, device="cuda", generator=gen)
    g = torch.randn((M, N), device="cuda", generator=gen) * 1e-3
    if exact_dz:
        g = g.bfloat16().float()
    if edges and M * K > 8 and K * N > 4 and M * N > 6:
        h.view(-1)[:5] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0], device="cuda")
        h[M - 1] = -0.0
        w.view(-1)[K * N - 2 :] = torch.tensor([float("inf"), -0.0], device="cuda")
        g.view(-1)[-3:] = torch.tensor([float("nan"), -float("inf"), -0.0], device="cuda")
    return h, w, b, g


@pytest.mark.parametrize("exact_dz", [True, False], ids=["dz_bf16", "dz_f32"])
@pytest.mark.parametrize("M,K,N", K21_MAIN_SHAPES + K21_EDGE_SHAPES)
def test_k21_modes_match_plain(M, K, N, exact_dz):
    """K21's forward (the product alone), input gradient and weight gradient
    against torch.matmul in float32 on the card from the same operands:
    within 2 gamma_K (|A| |B|) elementwise (3K terms with the float32 dz
    split into three bfloat16 pieces), the weight gradient the same bits on
    two runs; one launch each."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    gen = torch.Generator(device="cuda").manual_seed(M * 31 + K * 7 + N)
    h, w, _, g = _k21_layer(M, K, N, gen, exact_dz)
    p = kmm.operand_pieces(exact_dz)
    kernels.reset_launches()
    y, mask = kmm.mlp_mm_fwd(h, w, None, False)
    dh = kmm.mlp_mm_dgrad(g, w, exact_dz)
    dw = kmm.mlp_mm_wgrad(h, g, True, exact_dz)
    dw2 = kmm.mlp_mm_wgrad(h, g, True, exact_dz)
    torch.cuda.synchronize()
    assert mask is None
    assert (kernels.LAUNCHES["mlp_mm_fwd"], kernels.LAUNCHES["mlp_mm_dgrad"],
            kernels.LAUNCHES["mlp_mm_wgrad"]) == (int(M * N > 0), int(M * K > 0), 2 * int(K * N > 0))
    _k21_close(y, h @ w, _k21_bound(h, w, K), "forward")
    split = not exact_dz and kmm.mm_plan(M, K, N, p, 1).path == "wide"
    _k21_close(dh, g @ w.t(), _k21_bound(g, w.t(), _k21_terms(M, K, N, p, 1), split), "dgrad")
    _k21_close(dw, h.t() @ g, _k21_bound(h.t(), g, _k21_terms(K, N, M, 1, p)), "wgrad")
    assert torch.equal(dw.view(torch.int32), dw2.view(torch.int32))


K21_LAMBDA = 4.0  # chip_smoke.py: the probabilistic bound's lambda


@pytest.mark.parametrize("exact_dz", [True, False], ids=["dz_bf16", "dz_f32"])
@pytest.mark.parametrize("M,K,N", [(65536, 13, 512), (65536, 512, 256), (65536, 256, 1), (65536, 429, 429)])
def test_k21_wgrad_at_the_batch_within_the_probable_bound(M, K, N, exact_dz):
    """The weight gradient, whose depth is the batch, against float64 sums
    of the same operands within K21_LAMBDA sqrt(T) u (|A| |B|), T the terms
    a sum adds (2 gamma_T grows with T and would pass a gradient with a
    split left out): and the same product with its last split's rows left
    out leaves that bound."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    gen = torch.Generator(device="cuda").manual_seed(K * 3 + N)
    h, _, _, g = _k21_layer(M, K, N, gen, exact_dz)
    p = kmm.operand_pieces(exact_dz)
    plan = kmm.mm_plan(K, N, M, 1, p)
    assert plan.splits > 1
    exact = h.double().t() @ g.double()
    bnd = K21_LAMBDA * plan.terms(M, 1, p) ** 0.5 * 2.0**-24 * (h.double().abs().t() @ g.double().abs())
    dw = kmm.mlp_mm_wgrad(h, g, True, exact_dz)
    assert bool(((dw.double() - exact).abs() <= bnd).all()), float(((dw.double() - exact).abs() / bnd).max())
    kept = (plan.splits - 1) * plan.k_split
    faulty = kmm.mlp_mm_wgrad(h[:kept], g[:kept], True, exact_dz)
    assert not bool(((faulty.double() - exact).abs() <= bnd).all())


@pytest.mark.parametrize("mode", list(EPILOGUE_MODES))
@pytest.mark.parametrize("M,K,N", [(65536, 512, 256), (65536, 256, 16), (65536, 256, 1), (130, 40, 70), (77, 5, 3),
                                   (1000, 1, 13)])
def test_k21_fused_forward_matches_matmul_and_k19(M, K, N, mode):
    """The forward with the layer's epilogue in its store against
    torch.matmul + K19's plain forward: the output within the product's
    bound and one ULP of the round (bfloat16 or float16) or of the bias add
    beyond it, NaN where NaN; the mask equal wherever |z| exceeds the
    product's bound. At K = 1 the product is exact and the pre-activations
    hold the epilogue's edges (-0.0 + -0.0, NaN, +-inf, a bfloat16 halfway
    value either side of even, an exact cancellation to +0.0, a positive
    subnormal that rounds to bfloat16 zero with mask 1): the output equal
    in value and the mask equal everywhere."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_epilogue as kep
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    relu, rnd = EPILOGUE_MODES[mode]
    gen = torch.Generator(device="cuda").manual_seed(M + N)
    h, w, b, _ = _k21_layer(M, K, N, gen)
    b[: min(N, 2)] = torch.tensor([-0.0, float("nan")], device="cuda")[: min(N, 2)]
    if K == 1:  # z = h w + b, the product exact: h's rows the edges (1.0 below them), w ones but 2^-10 in column 0
        h.fill_(1.0)
        h[:7, 0] = torch.tensor([-0.0, float("nan"), float("inf"), -float("inf"), 1.0, 2.0**-130, -2.0],
                                device="cuda")
        w.fill_(1.0)
        w[0, 0] = 2.0**-10  # row 5, column 0: z = 2^-140 + -0.0
        b[2:4] = torch.tensor([2.0**-8, 3 * 2.0**-8], device="cuda")  # 1 + 2^-8 and 1 + 3 2^-8: halfway
        b[N - 1] = -1.0  # z = 1 - 1 = +0.0
    kernels.reset_launches()
    out, mask = kmm.mlp_mm_fwd(h, w, b, relu, rnd)
    y = h @ w
    want = y.clone()
    want_mask = kep.mlp_epilogue_fwd_plain(want, b, relu, rnd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mlp_mm_fwd"] == 1 and kernels.LAUNCHES["mlp_mm_fwd_epilogue"] == 1
    if K == 1:
        assert bool(((out == want) | (torch.isnan(out) & torch.isnan(want))).all())
        assert (mask is None) == (not relu) and (mask is None or torch.equal(mask, want_mask))
        if relu:
            assert bool(mask[5, 0]) and (rnd is not torch.bfloat16 or float(out[5, 0]) == 0.0)
            assert not bool(mask[8:, N - 1].any()) and not bool(torch.signbit(out[8:, N - 1]).any())
    bnd = _k21_bound(h, w, K)
    big = torch.maximum(out.abs(), want.abs()).double()
    ulp = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10, None: 2.0**-23}[rnd] * big + 2.0**-133
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    fin = torch.isfinite(want)
    assert bool(((out.double() - want.double()).abs()[fin] <= (bnd + ulp)[fin]).all())
    assert (mask is None) == (not relu)
    if relu:
        z = (y + b).double()
        sure = z.abs() > bnd
        assert torch.equal(mask[sure], want_mask[sure])
        assert not bool(torch.signbit(out[~mask & ~torch.isnan(out)]).any())  # relu gives +0.0


@pytest.mark.parametrize("exact_dz", [True, False], ids=["dz_bf16", "dz_f32"])
@pytest.mark.parametrize("M,K,N", [(130, 40, 70), (4097, 600, 17), (65536, 256, 1), (1000, 429, 429), (300, 16, 300),
                                   (13, 300, 257), (1000, 1, 13)])
def test_k21_non_finite_and_signed_zeros(M, K, N, exact_dz):
    """NaN, +-inf and -0.0 in h, w and dz reach every mode's output as the
    float32 product gives them, on both paths: no NaN from a padded lane or
    from a zero piece of a split value times inf."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    gen = torch.Generator(device="cuda").manual_seed(M + 5)
    h, w, _, g = _k21_layer(M, K, N, gen, exact_dz, edges=True)
    p = kmm.operand_pieces(exact_dz)
    split = not exact_dz and kmm.mm_plan(M, K, N, p, 1).path == "wide"
    _k21_close(kmm.mlp_mm_fwd(h, w, None, False)[0], h @ w, _k21_bound(h, w, K), "forward")
    _k21_close(kmm.mlp_mm_dgrad(g, w, exact_dz), g @ w.t(), _k21_bound(g, w.t(), _k21_terms(M, K, N, p, 1), split),
               "dgrad")
    _k21_close(kmm.mlp_mm_wgrad(h, g, True, exact_dz), h.t() @ g, _k21_bound(h.t(), g, _k21_terms(K, N, M, 1, p)),
               "wgrad")


@pytest.mark.parametrize("M,K,N", [(100, 3, 200), (100, 16, 5), (13, 200, 40)])
def test_k21_narrow_sums_are_ieee_sums(M, K, N):
    """The narrow path's sums are float32 fmaf's over the operands as they
    are: a sum of -0.0 products is -0.0 and one with a +0.0 product +0.0 (the
    padded depth's -0.0 products leave both), an inf times a finite value
    inf, inf - inf NaN, and float32 values that are not bfloat16 values
    multiply exactly (against float64 sums rounded once, within one rounding
    a term)."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    assert kmm.mm_plan(M, N, K).path == "narrow"
    gen = torch.Generator(device="cuda").manual_seed(M + K + N)
    h = torch.randn((M, K), device="cuda", generator=gen)  # float32 values, not bfloat16
    w = torch.rand((K, N), device="cuda", generator=gen) + 0.5  # positive
    h[0] = -0.0  # every product -0.0: the sum -0.0
    h[1] = -0.0
    h[1, K - 1] = 0.0  # one +0.0 product: +0.0
    h[2, 0] = float("inf")  # inf: inf, or NaN with an opposite inf
    h[3, 0], h[3, K - 1] = float("inf"), -float("inf")
    y = kmm.mlp_mm_fwd(h, w, None, False, None, False)[0]
    torch.cuda.synchronize()
    assert bool(torch.signbit(y[0]).all()) and bool((y[0] == 0).all())
    assert not bool(torch.signbit(y[1]).any()) and bool((y[1] == 0).all())
    assert bool(torch.isposinf(y[2]).all()) and bool(torch.isnan(y[3]).all())
    exact = h[4:].double() @ w.double()
    assert bool(((y[4:].double() - exact).abs() <= _k21_bound(h[4:], w, K) / 2).all())


@pytest.mark.parametrize("K", [40, 13], ids=["wide", "narrow"])
@pytest.mark.parametrize("scale", [2.0**-130, 2.0**-140, 2.0**-70], ids=["bf16_subnormal", "deep", "tiny_f32"])
def test_k21_subnormal_operands(scale, K):
    """Subnormal bfloat16 operands (the tensor cores keep them: K13d's 16-bit
    kernels' tests show it) and float32 operands in bfloat16's and float32's
    subnormal range through the split: within the bound with its
    subnormal terms (terms * 2^-149, and 2^-134 a split value below
    2^-110); no output flushed to zero where the plain product is not."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    gen = torch.Generator(device="cuda").manual_seed(17)
    M, N = 300, 24
    h = (torch.randn((M, K), device="cuda", generator=gen) * scale).bfloat16().float()
    w = torch.randn((K, N), device="cuda", generator=gen).bfloat16().float()
    _k21_close(kmm.mlp_mm_fwd(h, w, None, False)[0], h @ w, _k21_bound(h, w, K), "forward")
    g = torch.randn((M, N), device="cuda", generator=gen) * scale  # float32 values, split
    _k21_close(kmm.mlp_mm_dgrad(g, w, False), g @ w.t(), _k21_bound(g, w.t(), 3 * N, True), "dgrad")
    _k21_close(kmm.mlp_mm_wgrad(w.t().contiguous(), g.t().contiguous(), True, False), w @ g.t(),
               _k21_bound(w, g.t(), 3 * N) + 2.0**-134 * w.double().abs().sum(1, keepdim=True), "wgrad")
    if scale >= 2.0**-130:
        assert not bool(((kmm.mlp_mm_fwd(h, w, None, False)[0] == 0) & ((h @ w) != 0)).any())


def test_k21_split_rebuilds_float32_values():
    """Finite float32 values times the identity through the split path:
    each output is hi + mid + lo of its value (csrc/mlp_mm.cu split3x2), the
    exact sum of kmm.split_pieces' pieces, and the value itself for every
    |x| >= 2^-110 (float32's largest among them)."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    rng = np.random.default_rng(3)  # random bit patterns over the whole exponent range, the non-finite redrawn
    bits = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32).copy()
    bad = ~np.isfinite(x)
    x[bad] = rng.standard_normal(int(bad.sum())).astype(np.float32)
    f = np.finfo(np.float32)
    x[:8] = [f.max, -f.max, 3.3961e38, f.tiny, f.smallest_subnormal, 2.0**-110, 2.0**-111, -0.0]
    x = torch.from_numpy(x).cuda().view(64, 64)
    eye = torch.eye(64, device="cuda")
    got = kmm.mlp_mm_dgrad(x, eye, False, True)  # x @ I^T, x in three pieces
    hi, mid, lo = kmm.split_pieces(x)
    want = hi.double() + mid.double() + lo.double()  # exact (in float32, hi + mid may overflow before lo)
    assert torch.equal(got.double(), want)
    big = x.abs() >= 2.0**-110
    assert torch.equal(got[big], x[big])


@pytest.mark.parametrize("width", [70, 13], ids=["wide", "narrow"])
def test_k21_strided_operands_and_autograd(width):
    """MLPProduct on the card with a [B, 1041] view of a [B, 1044] input and
    a gradient that arrives as a view: the kernels read both through their
    strides, on the wide path (70 outputs) and the narrow one (13: the
    forward, input and weight gradient all narrow); the layer's gradients
    against the plain function's (within the products' bounds), K19's
    backward and K21's three launches once each."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    gen = torch.Generator(device="cuda").manual_seed(23)
    buf = torch.randn((1000, 1044), device="cuda", generator=gen).bfloat16().float()
    w = (torch.randn((1041, width), device="cuda", generator=gen) * 0.03).bfloat16().float()
    b = torch.randn(width, device="cuda", generator=gen)
    gbuf = torch.randn((1000, width + 3), device="cuda", generator=gen)
    assert {kmm.mm_plan(1000, width, 1041).path, kmm.mm_plan(1000, 1041, width).path,
            kmm.mm_plan(1041, width, 1000).path} == {"wide" if width > kmm.NARROW_MAX else "narrow"}
    grads = []
    for plain in (False, True):
        x = buf.clone().requires_grad_(True)
        wp, bp = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        kernels.reset_launches()
        out = kmm.mlp_product(x[:, :1041], wp, bp, relu=False, round_dtype=None, exact=True, plain=plain)
        out.backward(gbuf[:, 1:width + 1])
        torch.cuda.synchronize()
        want = {"mlp_mm_fwd": 1, "mlp_mm_dgrad": 1, "mlp_mm_wgrad": 1, "mlp_epilogue_bwd": 1} if not plain else {}
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {**want, **({"mlp_mm_fwd_epilogue": 1}
                                                                                if not plain else {})}
        grads.append((x.grad, wp.grad, bp.grad))
    g = gbuf[:, 1:width + 1]
    _k21_close(grads[0][0][:, :1041], grads[1][0][:, :1041], _k21_bound(g, w.t(), 3 * width, True), "dx")
    assert not bool(grads[0][0][:, 1041:].any())
    _k21_close(grads[0][1], grads[1][1], _k21_bound(buf[:, :1041].t(), g, 3 * 1000), "dw")
    torch.testing.assert_close(grads[0][2], grads[1][2], rtol=1e-5, atol=1e-5)


def test_k21_refuses_what_it_cannot_read():
    """A CUDA operand launches K21 or raises: an operand with no contiguous
    dimension, a dtype or device other than the other's."""
    _require_cuda()
    from nvtabular_tpu_torch.kernels import mlp_mm as kmm

    h = torch.randn((64, 48), device="cuda")[:, ::2]  # strides (48, 2)
    w = torch.randn((24, 8), device="cuda")
    with pytest.raises(ValueError):
        kmm.mlp_mm_fwd(h, w, None, False)
    with pytest.raises(TypeError):
        kmm.mlp_mm_fwd(torch.randn((4, 24), device="cuda").double(), w, None, False)
    with pytest.raises(ValueError):
        kmm.mlp_mm_fwd(torch.randn((4, 24), device="cuda"), w.cpu(), None, False)
