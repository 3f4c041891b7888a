"""List (multihot) columns in nvtabular_tpu_torch against the JAX reference:
Categorify on lists, ListSlice, the ragged kernels' plain versions (K11)
and DeviceLoader's multihot batches.

Both packages see the same seeded numpy data: MovieLens-shaped partitions
(bench/movielens_bench.py:35-52) whose ``genres`` list column has rows of 0
to 5 ids. The port runs on the CPU (``device="cpu"``: the kernels' plain
versions); the reference runs ``JitExecutor(jit_min_rows=0)``, so
Categorify takes its device path and ListSlice its host path
(``jit_safe = False``), and its ``kernels/ragged.py`` functions are called
directly. Codes, offsets, slices and loader batches must be equal;
``ts_delta`` differs by log1p ULPs (rtol=1e-5, atol=1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nvtabular_tpu as jnvt
import nvtabular_tpu_torch as pnvt
from nvtabular_tpu import ops as jops
from nvtabular_tpu.dag.executor import JitExecutor
from nvtabular_tpu.kernels import ragged as jragged
from nvtabular_tpu.loader import DeviceLoader as JDeviceLoader
from nvtabular_tpu.ops.list_slice import _slice_list as j_slice_list
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.dag.executor import LocalExecutor
from nvtabular_tpu_torch.kernels import ragged as pragged
from nvtabular_tpu_torch.loader import DeviceLoader

ROWS, PARTS = 3000, 3
CONT_TOL = dict(rtol=1e-5, atol=1e-5)


def make_part(seed, n=ROWS):
    """userId, movieId, a genres list of 0-5 ids of 20 (empty rows
    included), a scalar favorite genre, rating and ts_delta."""
    r = np.random.default_rng(seed)
    lengths = r.integers(0, 6, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return {
        "userId": r.zipf(1.2, n).clip(1, 2000).astype(np.int64),
        "movieId": r.zipf(1.1, n).clip(1, 300).astype(np.int64),
        "genres": (r.integers(1, 21, int(offsets[-1])).astype(np.int64), offsets),
        "favorite": r.integers(1, 26, n).astype(np.int64),
        "rating": (r.integers(1, 11, n) / 2.0).astype(np.float32),
        "ts_delta": r.exponential(86400.0, n).astype(np.float32),
    }


def batch(mod, part):
    """A TableBatch of ``mod`` (either package); (values, offsets) pairs
    become list columns."""
    return mod.TableBatch(
        {k: mod.Column(*v) if isinstance(v, tuple) else mod.Column(v) for k, v in part.items()}
    )


@pytest.fixture(scope="module")
def parts():
    return [make_part(s) for s in range(PARTS)]


def jax_fit(graph, parts):
    wf = jnvt.Workflow(graph, executor=JitExecutor(jit_min_rows=0))
    wf.fit(jnvt.Dataset([batch(jnvt, p) for p in parts]))
    return wf


def jax_state(wf):
    state = {"categorify": {}, "normalize": {}}
    for node in wf.graph.nodes:
        if isinstance(node.op, jops.Categorify):
            for key, v in node.op.vocabs.items():
                state["categorify"][key] = {
                    "values_by_code": np.asarray(v.values_by_code), "num_buckets": v.num_buckets,
                    "offset": v.offset,
                }
        elif isinstance(node.op, jops.Normalize):
            for name in node.op.means:
                state["normalize"][name] = {"mean": node.op.means[name], "std": node.op.stds[name]}
    return state


def port_workflow(graph, parts, jwf, fitted_by):
    wf = pnvt.Workflow(graph, device="cpu")
    if fitted_by == "port":
        wf.fit(pnvt.Dataset([batch(pnvt, p) for p in parts]))
    else:
        pnvt.load_fitted_state(wf, jax_state(jwf))
    return wf


def assert_same_output(got, want, conts=()):
    """got: a port TableBatch; want: a JAX TableBatch on the host."""
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = got[name], want[name]
        gv, wv = g.values.numpy(), np.asarray(w.values)
        assert gv.dtype == wv.dtype, name
        if name in conts:
            np.testing.assert_allclose(gv, wv, **CONT_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=name)
        assert (g.offsets is None) == (w.offsets is None), name
        if w.offsets is not None:  # the reference's device offsets are int32, the port's int64
            assert g.offsets.dtype == torch.int64
            np.testing.assert_array_equal(g.offsets.numpy(), np.asarray(w.offsets), err_msg=name)


CATEGORIFY_CASES = {
    "plain": lambda ops, **kw: ["userId", "genres"] >> ops.Categorify(**kw),
    "joint_list_and_scalar": lambda ops, **kw: [["genres", "favorite"], "userId"] >> ops.Categorify(**kw),
    "freq_threshold": lambda ops, **kw: ["userId", "genres"] >> ops.Categorify(freq_threshold=40, **kw),
    "single_table": lambda ops, **kw: ["movieId", "genres", "userId"] >> ops.Categorify(single_table=True, **kw),
}


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
@pytest.mark.parametrize("case", list(CATEGORIFY_CASES))
def test_categorify_lists_match_jax(parts, tmp_path, case, fitted_by):
    """Vocabularies element for element, codes and offsets exact (empty rows
    included), and get_embedding_sizes, with the vocabulary fitted by the
    port or carried from the JAX fit."""
    make = CATEGORIFY_CASES[case]
    jwf = jax_fit(make(jops, out_path=str(tmp_path)), parts)
    pwf = port_workflow(make(pops), parts, jwf, fitted_by)
    want_state, got_state = jax_state(jwf)["categorify"], pnvt.fitted_state(pwf)["categorify"]
    assert sorted(got_state) == sorted(want_state)
    for key, ref in want_state.items():
        np.testing.assert_array_equal(got_state[key]["values_by_code"], ref["values_by_code"], err_msg=key)
        assert got_state[key]["offset"] == ref["offset"]
    probe = make_part(7)
    probe["genres"][0][:5] = [99, 0, -3, 20, 1]  # unseen ids code as out of vocabulary
    for p in (parts[0], probe):
        assert_same_output(pwf.transform(batch(pnvt, p)), jwf.transform(batch(jnvt, p)).to_host())
    sizes = pops.get_embedding_sizes(pwf)
    assert sizes == jops.categorify.get_embedding_sizes(jwf)
    # (single, multihot) with a list column's own vocabulary; a joint group's
    # members record no embedding size (categorify.py:1707-1722)
    assert isinstance(sizes, tuple) == (case != "joint_list_and_scalar")


def config1_graph(ops, **kw):
    """BASELINE config 1 (bench/movielens_bench.py:62-70) with its rating
    binarized, as the getting-started ETL does."""
    cats = ["userId", "movieId", "genres"] >> ops.Categorify(**kw)
    conts = ["ts_delta"] >> ops.LogOp() >> ops.Normalize()
    label = ["rating"] >> ops.LambdaOp(lambda col: (np.asarray(col) > 3).astype(np.float32))
    return cats + conts + label


@pytest.mark.parametrize("fitted_by", ["port", "jax_state"])
def test_config1_workflow_matches_jax(parts, tmp_path, fitted_by):
    jwf = jax_fit(config1_graph(jops, out_path=str(tmp_path)), parts)
    pwf = port_workflow(config1_graph(pops), parts, jwf, fitted_by)
    for p in parts:
        assert_same_output(pwf.transform(batch(pnvt, p)), jwf.transform(batch(jnvt, p)).to_host(), {"ts_delta"})
    single, multihot = pops.get_embedding_sizes(pwf)
    assert multihot == {"genres": (23, 16)} and sorted(single) == ["movieId", "userId"]
    assert (single, multihot) == jops.categorify.get_embedding_sizes(jwf)


SLICES = [(0, 3), (1, 4), (-2, 0), (-3, -1)]


def slice_graph(ops, start, end, pad, **kw):
    """The genres branch of examples/02_advanced_ops.py:42."""
    return ["genres"] >> ops.Categorify(**kw) >> ops.ListSlice(start, end, pad=pad)


@pytest.mark.parametrize("pad", [True, False], ids=["pad", "ragged"])
@pytest.mark.parametrize("start,end", SLICES)
def test_list_slice_matches_jax(parts, tmp_path, start, end, pad):
    """Values and offsets exact against the reference's host slice (what
    its JitExecutor runs), the output schema's value_count and shape equal."""
    jwf = jax_fit(slice_graph(jops, start, end, pad, out_path=str(tmp_path)), parts)
    pwf = port_workflow(slice_graph(pops, start, end, pad), parts, jwf, "jax_state")
    for p in parts:
        assert_same_output(pwf.transform(batch(pnvt, p)), jwf.transform(batch(jnvt, p)).to_host())
    got, want = pwf.output_schema["genres"], jwf.output_schema["genres"]
    width = pops.ListSlice(start, end)._max_elements
    assert got.value_count == want.value_count == {"min": width if pad else 0, "max": width}
    dims = lambda shape: [(d.min, d.max) for d in shape.dims]  # noqa: E731 (the packages' own Shape classes)
    assert dims(got.shape) == dims(want.shape) and got.is_ragged == want.is_ragged == (not pad)
    node = next(n for n in pwf.graph.nodes if isinstance(n.op, pops.ListSlice))
    assert node.op.runs_on_host == (not pad)


def test_list_slice_ragged_takes_the_counted_host_handoff(parts):
    """pad=False has no kernel: the executors hand the column to the host
    (counted), which gives what the op gives in place."""
    col = batch(pnvt, parts[0]).select(["genres"])
    assert (["genres"] >> pops.ListSlice(1, 4, pad=True)).op.runs_on_host is False
    node = ["genres"] >> pops.ListSlice(-3, -1)
    assert node.op.runs_on_host is True
    ex = LocalExecutor()
    handed = ex._apply_on_host(node, col)
    want = node.op.transform(node.selector, col)["genres"]
    assert torch.equal(handed["genres"].values, want.values) and torch.equal(handed["genres"].offsets, want.offsets)
    assert ex.host_handoffs == 1 and ex.host_handoff_seconds > 0


def _ragged(seed, rows=500, max_len=9):
    """Random rows of 0..max_len values, the first row empty and the last one
    ending the values."""
    r = np.random.default_rng(seed)
    lengths = r.integers(0, max_len + 1, rows)
    lengths[0], lengths[-1] = 0, max_len
    offsets = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return r.integers(-1000, 1000, int(offsets[-1])).astype(np.int32), offsets


@pytest.mark.parametrize("pad_len", [4, 1, 12])
def test_ragged_to_padded_plain_matches_jax(pad_len):
    """Rows longer than L cut off, empty rows all padding, the last row
    reaching the end of the values; the mask as the loader's float32."""
    values, offsets = _ragged(pad_len)
    want, want_mask = jragged.ragged_to_padded(jnp.asarray(values), jnp.asarray(offsets), pad_len, -7)
    got, got_mask = pragged.ragged_to_padded(torch.from_numpy(values), torch.from_numpy(offsets), pad_len, -7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_mask.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask).astype(np.float32))


@pytest.mark.parametrize("start,end,pad_len", [(0, 3, 3), (1, 4, 3), (-2, 0, 2), (-3, -1, 2), (2, 7, 5), (-3, 2, 5)])
def test_ragged_slice_padded_plain_matches_jax(start, end, pad_len):
    """Against the reference's device function; and against its host slice
    (``_slice_list``) except where the two disagree: a negative start with a
    positive end, where the host takes ``[start:len]`` and the device
    function (and the port) the python slice."""
    values, offsets = _ragged(start + 40)
    want, want_len = jragged.ragged_slice_padded(jnp.asarray(values), jnp.asarray(offsets), start, end, pad_len, 5)
    got, got_len = pragged.ragged_slice_padded(torch.from_numpy(values), torch.from_numpy(offsets), start, end,
                                               pad_len, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    host = j_slice_list(jnvt.Column(values, offsets), start, end, True, 5)
    same = np.array_equal(got.numpy().reshape(-1), np.asarray(host.values))
    assert same == (not (start < 0 < end))
    if start < 0 < end:  # e.g. a row of 5 values: python's [-3:2] is empty, the host's holds 3
        py = [list(values[offsets[i]:offsets[i + 1]][start:end]) for i in range(len(offsets) - 1)]
        assert [list(row[:n]) for row, n in zip(got.numpy(), got_len.numpy())] == py


def _loaders(parts, tmp_path, graph=config1_graph, **kwargs):
    jwf = jax_fit(graph(jops, out_path=str(tmp_path)), parts)
    pwf = port_workflow(graph(pops), parts, jwf, "jax_state")
    common = dict(shuffle=False, **kwargs)
    jl = JDeviceLoader(jwf.transform(jnvt.Dataset([batch(jnvt, p) for p in parts])), **common)
    pl = DeviceLoader(pwf.transform(pnvt.Dataset([batch(pnvt, p) for p in parts])), device="cpu", **common)
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


NAMES = dict(cat_names=["userId", "movieId", "genres"], cont_names=["ts_delta"], label_names=["rating"])


@pytest.mark.parametrize("batch_size,drop_last", [(1000, True), (1024, False)])
def test_multihot_batches_match_jax_loader(parts, tmp_path, batch_size, drop_last):
    """genres__values and genres__mask exact, batch for batch, across the
    carry (1024 does not divide a 3000-row chunk); rows longer than 4 cut."""
    jl, pl = _loaders(parts, tmp_path, batch_size=batch_size, drop_last=drop_last, sparse_max={"genres": 4}, **NAMES)
    want, got = list(jl), list(pl)
    assert len(got) == len(want) == (PARTS * ROWS + (0 if drop_last else batch_size - 1)) // batch_size
    for g, w in zip(got, want):
        assert_same_batch(g, w)
    assert got[0]["genres__values"].shape == (batch_size, 4) and got[0]["genres__mask"].dtype == torch.float32


def test_multihot_sparse_max_from_schema_matches_jax_loader(parts, tmp_path):
    """ListSlice(0, 3, pad=True) sets value_count max 3: both loaders take
    L = 3 from the schema."""

    def graph(ops, **kw):
        ids = ["userId", "movieId"] >> ops.Categorify(**kw)
        return slice_graph(ops, 0, 3, True, **kw) + ids + (["ts_delta"] >> ops.LogOp()) + ["rating"]

    jl, pl = _loaders(parts, tmp_path, graph=graph, batch_size=1000, **NAMES)
    assert pl.sparse_max == jl.sparse_max == {"genres": 3}
    for g, w in zip(list(pl.chunks()), list(jl.chunks())):
        assert_same_batch(g, w)


def test_shuffled_multihot_rows_stay_together():
    """Each row's padded values and mask move with its other arrays."""
    rows = 2100
    lengths = np.arange(rows) % 6
    offsets = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    rid = np.arange(rows, dtype=np.int32)
    values = np.repeat(rid, lengths) * 10 + (np.arange(offsets[-1]) - np.repeat(offsets[:-1], lengths))
    parts = [
        pnvt.TableBatch({"rid": pnvt.Column(rid[s : s + 700]), "tags": pnvt.Column(
            values[offsets[s] : offsets[s + 700]].astype(np.int32), offsets[s : s + 701] - offsets[s])})
        for s in range(0, rows, 700)
    ]
    loader = DeviceLoader(pnvt.Dataset(parts), 256, cat_names=["rid", "tags"], cont_names=[], label_names=[],
                          sparse_max={"tags": 4}, shuffle=True, seed=5, drop_last=False, device="cpu")
    batches = list(loader)
    got = {k: torch.cat([b[k] for b in batches]) for k in ("rid", "tags__values", "tags__mask")}
    r = got["rid"].long()
    assert torch.equal(torch.sort(r).values, torch.arange(rows))
    assert not torch.equal(r, torch.arange(rows))
    n = torch.clamp(r % 6, max=4)
    pos = torch.arange(4)
    assert torch.equal(got["tags__mask"], (pos[None] < n[:, None]).float())
    want = torch.where(pos[None] < n[:, None], r[:, None] * 10 + pos[None], 0)
    assert torch.equal(got["tags__values"].long(), want)
