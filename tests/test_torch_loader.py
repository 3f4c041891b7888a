"""The training feed of nvtabular_tpu_torch against the JAX reference, and the
slice as a whole: ETL → DeviceLoader → DLRM → Adagrad steps.

The port runs on the CPU through the plain versions of its kernels (K1-K5 in
the transform, K14 in the loader, K13a/K13b in the model). The JAX side runs
its device path on CPU-JAX. Shuffled orders cannot match (``torch.randperm``
against ``jax.random.permutation``): loaders are compared unshuffled, the
permutation is compared by handing both sides the same numpy permutation,
and model parameters are carried across with ``convert.load_dlrm_params``.
"""

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
from nvtabular_tpu.loader.device_loader import _permute_tree
from nvtabular_tpu.models import dlrm as jdlrm
from nvtabular_tpu.models.training import make_step_fns
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.kernels.permute import permute_rows
from nvtabular_tpu_torch.loader import DeviceLoader

CATS = ["t0", "t1", "d0", "w0", "w1"]
CONTS = ["I0", "I1", "I2"]
ROWS_PER_PART, PARTS = 3000, 4
# the transform's floats: log1p differs by a few float32 ULPs between XLA's
# and PyTorch's CPU implementations (as in test_torch_workflow.py)
CONT_TOL = dict(rtol=1e-5, atol=1e-5)


def make_part(seed, n=ROWS_PER_PART):
    """Criteo-shaped: tiny, direct and cuckoo-sized int columns, 3 floats
    with ~5% NaN, an int32 label."""
    r = np.random.default_rng(seed)
    spread = lambda x, m: ((x.astype(np.int64) * m) % 2**31).astype(np.int32)  # noqa: E731
    d = {
        "t0": r.integers(0, 40, n).astype(np.int32),
        "t1": spread(r.integers(0, 3000, n), 7919),
        "d0": (100_000 + r.integers(0, 8000, n)).astype(np.int32),
        "w0": spread(r.zipf(1.3, n) % 12_000, 2654435761),
        "w1": (spread(r.integers(0, 9000, n), 40503).astype(np.int64) - 2**30).astype(np.int32),
    }
    for name in CONTS:
        x = r.normal(1.0, 3.0, n).astype(np.float32)
        x[r.random(n) < 0.05] = np.nan
        d[name] = x
    d["label"] = r.integers(0, 2, n).astype(np.int32)
    return d


def graph(ops):
    cats = CATS >> ops.Categorify()
    conts = CONTS >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.Normalize()
    return cats + conts + ["label"]


@pytest.fixture(scope="module")
def parts():
    return [make_part(s) for s in range(PARTS)]


@pytest.fixture(scope="module")
def workflows(parts):
    """The JAX workflow fitted on ``parts`` and the port's with its state."""
    jwf = jnvt.Workflow(graph(jops), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts]))
    state = {"categorify": {}, "normalize": {}}
    for node in jwf.graph.nodes:
        if isinstance(node.op, jops.Categorify):
            for key, v in node.op.vocabs.items():
                state["categorify"][key] = {
                    "values_by_code": np.asarray(v.values_by_code),
                    "num_buckets": v.num_buckets,
                    "offset": v.offset,
                }
        elif isinstance(node.op, jops.Normalize):
            for name in node.op.means:
                state["normalize"][name] = {"mean": node.op.means[name], "std": node.op.stds[name]}
    pwf = pnvt.Workflow(graph(pops), device="cpu")
    pnvt.load_fitted_state(pwf, state)
    return jwf, pwf


def loaders(workflows, parts, **kwargs):
    jwf, pwf = workflows
    common = dict(cat_names=CATS, cont_names=CONTS, label_names=["label"], shuffle=False, **kwargs)
    jl = JDeviceLoader(jwf.transform(jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts])), **common)
    pl = DeviceLoader(pwf.transform(pnvt.Dataset(parts)), device="cpu", **common)
    return jl, pl


def assert_same_batch(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        g, w = got[key].numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if key == "dense":
            np.testing.assert_allclose(g, w, **CONT_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("perm_dtype", [np.int64, np.int32])
def test_permute_rows_matches_jax_take(perm_dtype):
    """K14's plain version against the JAX loader's jitted take, with the
    same numpy permutation: exact."""
    rng = np.random.default_rng(0)
    n = 1000
    arrays = {
        "c": rng.integers(0, 99, n).astype(np.int32),
        "dense": rng.normal(size=(n, 13)).astype(np.float32),
        "label": rng.integers(0, 2, n).astype(np.float32),
        "wide": rng.integers(-(2**31), 2**31, n),  # int64 rows (JAX, x64 off, holds them as int32)
    }
    perm = rng.permutation(n).astype(perm_dtype)
    want = _permute_tree({k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(perm))
    got = permute_rows({k: torch.from_numpy(v) for k, v in arrays.items()}, torch.from_numpy(perm))
    assert list(got) == list(arrays)
    for k in arrays:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).astype(arrays[k].dtype), err_msg=k)


@pytest.mark.parametrize("batch_size,drop_last", [(1000, True), (1024, True), (1024, False)])
def test_unshuffled_batches_match_jax_loader(workflows, parts, batch_size, drop_last):
    """Carry across chunks (1024 does not divide a 3000-row chunk) and
    drop_last, batch for batch."""
    jl, pl = loaders(workflows, parts, batch_size=batch_size, drop_last=drop_last)
    want, got = list(jl), list(pl)
    assert len(got) == len(want) == (len(parts) * ROWS_PER_PART + (0 if drop_last else batch_size - 1)) // batch_size
    for g, w in zip(got, want):
        assert_same_batch(g, w)


def test_unshuffled_chunks_match_jax_loader(workflows, parts):
    jl, pl = loaders(workflows, parts, batch_size=1000)
    want, got = list(jl.chunks()), list(pl.chunks())
    assert len(got) == len(want) == PARTS
    for g, w in zip(got, want):
        assert_same_batch(g, w)


def _id_dataset(n_parts=3, rows=700):
    parts = []
    for p in range(n_parts):
        rid = np.arange(p * rows, (p + 1) * rows, dtype=np.int32)
        parts.append({"rid": rid, "x": rid.astype(np.float32) * 0.5, "y": (rid % 3).astype(np.float32)})
    return pnvt.Dataset(parts)


def _rows(batches):
    return {k: torch.cat([b[k] for b in batches]) for k in batches[0]}


def test_shuffled_epoch_covers_every_row_once():
    ds = _id_dataset()
    loader = DeviceLoader(ds, 256, cat_names=["rid"], cont_names=["x"], label_names=["y"],
                          shuffle=True, seed=3, drop_last=False, device="cpu")
    epoch1 = _rows(list(loader))
    rid = epoch1["rid"]
    assert torch.equal(torch.sort(rid).values, torch.arange(2100, dtype=torch.int32))
    assert not torch.equal(rid, torch.sort(rid).values)  # shuffled
    # every array moved with its row
    assert torch.equal(epoch1["dense"][:, 0], rid.float() * 0.5)
    assert torch.equal(epoch1["label"], (rid % 3).float())
    epoch2 = _rows(list(loader))
    assert not torch.equal(epoch2["rid"], rid)  # seed + epoch
    again = DeviceLoader(ds, 256, cat_names=["rid"], cont_names=["x"], label_names=["y"],
                         shuffle=True, seed=3, drop_last=False, device="cpu")
    assert torch.equal(_rows(list(again))["rid"], rid)


def test_shuffled_chunks_permute_each_chunk():
    loader = DeviceLoader(_id_dataset(), 256, cat_names=["rid"], cont_names=["x"], label_names=["y"],
                          shuffle=True, device="cpu")
    chunks = list(loader.chunks())
    assert len(chunks) == 3
    for p, chunk in enumerate(chunks):
        want = torch.arange(p * 700, (p + 1) * 700, dtype=torch.int32)
        assert torch.equal(torch.sort(chunk["rid"]).values, want)
        assert not torch.equal(chunk["rid"], want)
        assert torch.equal(chunk["dense"][:, 0], chunk["rid"].float() * 0.5)


def test_transformed_dataset_schema_and_codes_below_cardinality(workflows, parts):
    """The loader reads ``TransformedDataset.schema``; every code a column
    emits is below the cardinality its schema records for DLRM."""
    jwf, pwf = workflows
    out = pwf.transform(pnvt.Dataset(parts))
    assert out.schema is pwf.output_schema
    assert out.schema.column_names == jwf.output_schema.column_names
    loader = DeviceLoader(out, 1000, device="cpu")  # names from the schema's tags
    assert loader.cat_names == CATS and loader.cont_names == CONTS and loader.label_names == []
    config = pmodels.DLRMConfig.from_schema(out.schema, embedding_dim=8)
    for chunk in loader.chunks():
        for name in CATS:
            assert 0 <= int(chunk[name].min()) and int(chunk[name].max()) < config.cardinalities[name], name


def test_dlrm_config_from_schema_matches_jax(workflows, parts):
    jwf, pwf = workflows
    pwf.transform(pnvt.Dataset(parts))
    jwf.transform(jnvt.Dataset([jnvt.TableBatch.from_pydict(parts[0])]))
    want = jdlrm.DLRMConfig.from_schema(jwf.output_schema, embedding_dim=16)
    got = pmodels.DLRMConfig.from_schema(pwf.output_schema, embedding_dim=16)
    assert got.cardinalities == want.cardinalities
    assert got.num_dense == want.num_dense == len(CONTS)
    assert got.interaction_dim == want.interaction_dim == 15


def test_slice_whole_etl_loader_dlrm_adagrad(workflows, parts):
    """ETL → DeviceLoader(shuffle=False) → DLRM (JAX parameters carried
    across) → 3 Adagrad(1e-2) steps, against the JAX package's
    make_step_fns(dlrm_loss, optax.adagrad(1e-2)) on its own ETL output.
    Tolerances: the dense inputs differ by log1p ULPs (1e-5), float32 sums
    run in another order, and DLRM's MLPs round to bfloat16 on both sides,
    where a value that close to a rounding boundary may round the other way."""
    jl, pl = loaders(workflows, parts, batch_size=1024)
    jwf, pwf = workflows
    kwargs = dict(embedding_dim=8, bottom_mlp=(32, 16), top_mlp=(32, 16))
    jbatches, pbatches = list(jl)[:3], list(pl)[:3]
    jconfig = jdlrm.DLRMConfig.from_schema(jwf.output_schema, **kwargs)
    pconfig = pmodels.DLRMConfig.from_schema(pwf.output_schema, **kwargs)
    params = jax.tree.map(np.asarray, jdlrm.dlrm_init(jax.random.PRNGKey(0), jconfig))

    opt = optax.adagrad(1e-2)
    step, _ = make_step_fns(jdlrm.dlrm_loss, opt)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    want_losses = []
    for b in jbatches:
        jp, state, loss = step(jp, state, b)
        want_losses.append(float(loss))

    model = pmodels.DLRM(pconfig, device="cpu")
    pnvt.load_dlrm_params(model, params)
    popt = pmodels.Adagrad(model.parameters(), lr=1e-2)
    got_losses = [float(pmodels.train_step(model, popt, b)) for b in pbatches]

    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    got = pnvt.dlrm_params(model)
    for name in model.names:
        np.testing.assert_allclose(got["tables"][name], np.asarray(jp["tables"][name]), rtol=1e-5, atol=1e-6, err_msg=name)
    for side in ("bottom", "top"):
        for g, w in zip(got[side], jp[side]):
            np.testing.assert_allclose(g["w"], np.asarray(w["w"]), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(g["b"], np.asarray(w["b"]), rtol=1e-5, atol=1e-6)
    sos = state[0].sum_of_squares
    acc = popt.accumulator(model.table).numpy()
    want_acc = np.concatenate([np.asarray(sos["tables"][n]) for n in model.names])
    np.testing.assert_allclose(acc, want_acc, rtol=1e-5)


def test_list_columns_raise():
    ds = pnvt.Dataset({"a": [[1, 2], [3]], "x": np.array([0.5, 1.0], dtype=np.float32)})
    loader = DeviceLoader(ds, 1, cat_names=["a"], cont_names=["x"], label_names=[], device="cpu")
    with pytest.raises(NotImplementedError, match="K11"):
        list(loader)


def test_loader_default_device_is_cuda():
    if torch.cuda.is_available():
        assert DeviceLoader(_id_dataset(), 8).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceLoader(_id_dataset(), 8)
