"""Parquet I/O of nvtabular_tpu_torch against the JAX reference: the port's
writer (``io/writer.py`` over ``csrc/parquet.cc``) against JAX's native
writer byte for byte, its reader against pyarrow, the file-backed
``Dataset`` against JAX's, and the slice end to end: parquet in → fit →
transform → ``to_parquet(PER_WORKER)`` → ``Dataset`` → ``DeviceLoader`` →
3 DLRM Adagrad steps.

The JAX side writes with ``NVT_FUSED_WRITE=0`` (its two-phase form) and
``NVT_NATIVE_PARQUET_MIN_ROWS=0`` (so that its small windows take its native
encoder, as every window of the port's does). pyarrow is used by the tests
only; the port never imports it.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import nvtabular_tpu as jnvt
import nvtabular_tpu_torch as pnvt
from nvtabular_tpu import ops as jops
from nvtabular_tpu.dag.executor import JitExecutor
from nvtabular_tpu.io import Shuffle as JShuffle
from nvtabular_tpu.io import native_parquet as jnpq
from nvtabular_tpu.io.writer import write_dataset as jax_write_dataset
from nvtabular_tpu.loader import DeviceLoader as JDeviceLoader
from nvtabular_tpu.models import dlrm as jdlrm
from nvtabular_tpu.models.training import make_step_fns
from nvtabular_tpu_torch import models as pmodels
from nvtabular_tpu_torch import ops as pops
from nvtabular_tpu_torch.io import Shuffle as PShuffle
from nvtabular_tpu_torch.io import native_parquet as pnpq
from nvtabular_tpu_torch.io.writer import write_dataset as port_write_dataset
from nvtabular_tpu_torch.loader import DeviceLoader

ITEM_16 = "ROADMAP.md queue 1 item 16:"
ROWS = (20_000, 70_000, 33_000)
# the transform's floats: log1p differs by a few float32 ULPs between XLA's
# and PyTorch's CPU implementations (ROADMAP.md queue 3)
CONT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def jax_two_phase_native(monkeypatch):
    monkeypatch.setenv("NVT_FUSED_WRITE", "0")
    monkeypatch.setenv("NVT_NATIVE_PARQUET_MIN_ROWS", "0")


def make_part(seed, n):
    """An int32, an int64, a float32 and a float64 column; the first
    partition opens with each dtype's extremes (NaN, ±inf, -0.0 included)."""
    r = np.random.default_rng(seed)
    d = {
        "i32": r.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
        "i64": r.integers(-(2**62), 2**62, n).astype(np.int64),
        "f32": r.normal(size=n).astype(np.float32),
        "f64": r.normal(size=n),
    }
    if seed == 0:
        d["i32"][:5] = [np.iinfo(np.int32).min, -1, 0, 1, np.iinfo(np.int32).max]
        d["i64"][:5] = [np.iinfo(np.int64).min, -1, 0, 1, np.iinfo(np.int64).max]
        d["f32"][:5] = [-np.inf, -0.0, np.nan, 1.5e38, np.inf]
        d["f64"][:5] = [-np.inf, -0.0, np.nan, 1e308, np.inf]
    return d


@pytest.fixture(scope="module")
def parts():
    return [make_part(s, n) for s, n in enumerate(ROWS)]


def jax_dataset(parts):
    return jnvt.Dataset([jnvt.TableBatch.from_pydict(p) for p in parts])


def port_dataset(parts):
    return pnvt.Dataset([pnvt.TableBatch.from_pydict(p) for p in parts])


def assert_same_files(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    for name in names:
        assert filecmp.cmp(os.path.join(got_dir, name), os.path.join(want_dir, name), shallow=False), name


def bits(a: np.ndarray) -> np.ndarray:
    """An array's bytes, so that NaN equals NaN and -0.0 differs from 0.0."""
    return np.ascontiguousarray(a).view(np.uint8)


# --- the writer ---------------------------------------------------------------------------------
SHUFFLES = [None, "PER_PARTITION", "PER_WORKER", "FULL"]


@pytest.mark.parametrize("out_files", [1, 3])
@pytest.mark.parametrize("compression", ["auto", None, "zstd"], ids=["auto", "none", "zstd"])
@pytest.mark.parametrize("shuffle", SHUFFLES, ids=[s or "unshuffled" for s in SHUFFLES])
def test_write_dataset_bytes_match_jax(parts, tmp_path, shuffle, compression, out_files):
    """Every file and ``_metadata.json`` equal JAX's native writer's byte for
    byte: the same windows, seeds (``default_rng(seed * 1000 + i)`` per file,
    ``default_rng(seed)`` per window), encodings, zstd pages and footer.
    ``None`` is "none" here: ``write_dataset(compression=None)`` means the
    ``NVT_PARQUET_COMPRESSION`` default in both packages."""
    codec = "none" if compression is None else compression
    jax_write_dataset(jax_dataset(parts), str(tmp_path / "j"), shuffle=shuffle and JShuffle[shuffle],
                      out_files=out_files, compression=codec)
    port_write_dataset(port_dataset(parts), str(tmp_path / "p"), shuffle=shuffle and PShuffle[shuffle],
                       out_files=out_files, compression=codec)
    assert_same_files(str(tmp_path / "p"), str(tmp_path / "j"))
    meta = json.loads((tmp_path / "p" / "_metadata.json").read_text())
    assert meta["files"] == [f"part_{i}.parquet" for i in range(out_files)]


def test_unshuffled_write_keeps_several_row_groups_in_schema_order(parts, tmp_path):
    """One row group per appended batch, each batch's columns in the file's
    schema order even when the batch lists them otherwise (the reference
    writes them in batch order, writer.py:176: not copied)."""
    flipped = [dict(reversed(list(p.items()))) for p in parts[1:]]
    port_write_dataset(port_dataset(parts[:1] + flipped), str(tmp_path / "p"), out_files=1)
    f = pq.ParquetFile(str(tmp_path / "p" / "part_0.parquet"))
    assert f.metadata.num_row_groups == len(parts)
    assert f.schema_arrow.names == list(parts[0])
    table = f.read()
    for name in parts[0]:
        np.testing.assert_array_equal(bits(table[name].to_numpy()), bits(np.concatenate([p[name] for p in parts])))


@pytest.mark.parametrize("nfiles", [1, 2, 3, 7])
def test_hash_split_and_window_index_match_jax(nfiles):
    """The C++ window index and the numpy hash split equal JAX's, bit for
    bit (as tests/unit/test_native_parquet.py:247 holds JAX's two)."""
    r = np.random.default_rng(nfiles)
    rows = [int(n) for n in r.integers(1, 5000, 4)]
    seeds = [int(s) for s in r.integers(0, 2**63, 4)]
    for seed in seeds:
        np.testing.assert_array_equal(pnpq.hash_split(seed, 4096, nfiles), jnpq.hash_split(seed, 4096, nfiles))
    for k in range(nfiles):
        got = pnpq.build_window_index(rows, seeds, nfiles, k, 12345)
        np.testing.assert_array_equal(got, jnpq.build_window_index(rows, seeds, nfiles, k, 12345))
        # the split the index keeps is the numpy twin's
        piece, row = got >> 48, got & ((1 << 48) - 1)
        for p, (n, s) in enumerate(zip(rows, seeds)):
            want = np.flatnonzero(pnpq.hash_split(s, n, nfiles) == k)
            np.testing.assert_array_equal(np.sort(row[piece == p]), want)


@pytest.mark.parametrize(
    "batch, what",
    [
        ({"x": pnvt.TableBatch.from_pydict({"x": [np.array([1, 2]), np.array([3])]})["x"]}, "list columns"),
        ({"x": pnvt.Column(np.array([1.0, 2.0]), None, np.array([True, False]))}, "nulls"),
        ({"x": np.array([1, 2], np.int16)}, "int16 columns"),
        ({"x": np.array([1.0, 2.0], np.float16)}, "float16 columns"),
    ],
    ids=["list", "null", "int16", "float16"],
)
def test_write_outside_the_native_subset_raises_item_16(tmp_path, batch, what):
    with pytest.raises(NotImplementedError, match=f"{what}.*{ITEM_16}"):
        port_write_dataset(pnvt.Dataset([batch]), str(tmp_path / "o"))


def test_write_snappy_raises_item_16_and_all_true_validity_is_dropped(tmp_path):
    with pytest.raises(NotImplementedError, match=f"snappy.*{ITEM_16}"):
        port_write_dataset(pnvt.Dataset([{"x": np.arange(3)}]), str(tmp_path / "s"), compression="snappy")
    batch = {"x": pnvt.Column(np.arange(4, dtype=np.int64), None, np.ones(4, bool))}
    port_write_dataset(pnvt.Dataset([batch]), str(tmp_path / "v"))
    assert pq.read_table(str(tmp_path / "v" / "part_0.parquet"))["x"].to_pylist() == [0, 1, 2, 3]


# --- the reader -----------------------------------------------------------------------------------
@pytest.mark.parametrize("shuffle", ["PER_WORKER", None], ids=["per_worker", "unshuffled"])
def test_reader_reads_jax_and_port_files_as_pyarrow_does(parts, tmp_path, shuffle):
    jax_write_dataset(jax_dataset(parts), str(tmp_path / "j"), shuffle=shuffle and JShuffle[shuffle], out_files=3)
    port_write_dataset(port_dataset(parts), str(tmp_path / "p"), shuffle=shuffle and PShuffle[shuffle], out_files=3,
                       compression="zstd")
    for path in sorted((tmp_path / "j").glob("*.parquet")) + sorted((tmp_path / "p").glob("*.parquet")):
        want = pq.read_table(str(path))
        got = pnpq.read_row_groups(str(path))
        assert list(got) == want.column_names
        for name in want.column_names:
            w = want[name].to_numpy()
            assert got[name].dtype == w.dtype, name
            np.testing.assert_array_equal(bits(got[name]), bits(w), err_msg=f"{path}: {name}")


def _arrow_table(n=50_000, seed=3):
    r = np.random.default_rng(seed)
    return pa.table({
        "i8": r.integers(-100, 100, n).astype(np.int8),
        "i16": r.integers(-30_000, 30_000, n).astype(np.int16),
        "u8": r.integers(0, 255, n).astype(np.uint8),
        "i32": r.integers(-(2**31), 2**31 - 1, n).astype(np.int32),
        "i64": r.integers(-(2**62), 2**62, n),
        "f32": r.normal(size=n).astype(np.float32),
        "f64": r.normal(size=n),
    })


@pytest.mark.parametrize("required", [False, True], ids=["optional", "required"])
@pytest.mark.parametrize("encodings", [None, "delta_bss"], ids=["plain", "delta_bss"])
@pytest.mark.parametrize("compression", ["NONE", "ZSTD"])
def test_reader_reads_pyarrow_files(tmp_path, compression, encodings, required):
    """pyarrow files written with ``use_dictionary=False`` and
    ``data_page_version="1.0"``, OPTIONAL (definition levels, no null) or
    REQUIRED columns, several pages and row groups: the values equal
    pyarrow's reading."""
    table = _arrow_table()
    if required:
        table = table.cast(pa.schema([f.with_nullable(False) for f in table.schema]))
    column_encoding = None if encodings is None else {
        "i32": "DELTA_BINARY_PACKED", "i64": "DELTA_BINARY_PACKED", "f32": "BYTE_STREAM_SPLIT",
        "f64": "BYTE_STREAM_SPLIT"}
    path = str(tmp_path / "a.parquet")
    pq.write_table(table, path, use_dictionary=False, data_page_version="1.0", compression=compression,
                   column_encoding=column_encoding, row_group_size=20_000, data_page_size=16_384)
    footer = pnpq.read_footer(path)
    assert [rg["num_rows"] for rg in footer.row_groups] == [20_000, 20_000, 10_000]
    want = pq.read_table(path)
    got = pnpq.read_row_groups(path, footer=footer)
    for name in want.column_names:
        w = want[name].to_numpy()
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    some = pnpq.read_row_groups(path, [2, 0], columns=["f64", "i8"])
    assert list(some) == ["f64", "i8"]
    np.testing.assert_array_equal(some["i8"], np.concatenate([want["i8"].to_numpy()[40_000:],
                                                              want["i8"].to_numpy()[:20_000]]))


@pytest.mark.parametrize(
    "table, kwargs, what",
    [
        (_arrow_table(100), dict(use_dictionary=True, compression="NONE"), "dictionary pages"),
        (pa.table({"x": pa.array([1, None, 3], pa.int64())}), dict(use_dictionary=False, compression="NONE"),
         "nulls"),
        (pa.table({"x": pa.array([[1], [2, 3]])}), dict(use_dictionary=False, compression="NONE"), "list"),
        (_arrow_table(100), dict(use_dictionary=False, compression="snappy"), "snappy"),
        (_arrow_table(100), dict(use_dictionary=False, compression="gzip"), "gzip"),
        (_arrow_table(100), dict(use_dictionary=False, compression="NONE", data_page_version="2.0"),
         "DataPage V2"),
        (pa.table({"s": ["a", "b"]}), dict(use_dictionary=False, compression="NONE"), "strings"),
        (pa.table({"b": [True, False]}), dict(use_dictionary=False, compression="NONE"), "BOOLEAN"),
    ],
    ids=["dictionary", "null", "list", "snappy", "gzip", "page_v2", "string", "bool"],
)
def test_reader_outside_the_native_subset_raises_item_16(tmp_path, table, kwargs, what):
    path = str(tmp_path / "x.parquet")
    pq.write_table(table, path, **kwargs)
    with pytest.raises(NotImplementedError, match=f"{what}.*{ITEM_16}"):
        pnpq.read_row_groups(path)


def test_remote_paths_csv_and_merge_raise_item_16(tmp_path):
    (tmp_path / "a.csv").write_text("x\n1\n")
    for call in (lambda: pnvt.Dataset("s3://bucket/data.parquet"), lambda: pnvt.Dataset(str(tmp_path / "a.csv")),
                 lambda: pnvt.Dataset.merge(pnvt.Dataset({"x": [1]}), pnvt.Dataset({"x": [1]}), on="x")):
        with pytest.raises(NotImplementedError, match=ITEM_16):
            call()


# --- the file-backed Dataset ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def files(parts, tmp_path_factory):
    """The parts as 3 files of several row groups each, through JAX's writer."""
    out = str(tmp_path_factory.mktemp("files"))
    jax_write_dataset(jax_dataset(parts + parts[:2]), out, out_files=3, compression="auto")
    return out


def assert_same_batch(got, want):
    """Names, dtypes and values; a float NaN against the reference's null
    (its arrow reading may turn NaN into a null)."""
    assert got.column_names == want.column_names
    for name in want.column_names:
        gv, wv = got[name].values.numpy(), np.asarray(want[name].values)
        assert gv.dtype == wv.dtype, name
        gnull, wnull = got[name].is_null().numpy(), np.asarray(want[name].is_null())
        np.testing.assert_array_equal(gnull, wnull, err_msg=name)
        np.testing.assert_array_equal(bits(gv[~gnull]), bits(wv[~wnull]), err_msg=name)


@pytest.mark.parametrize("part_size", [None, "600KB", 2_000_000], ids=["default", "600KB", "2MB"])
@pytest.mark.parametrize("source", ["dir", "glob", "list"])
def test_dataset_plan_matches_jax(files, part_size, source):
    """The same partitions (file, row groups, rows) as the reference's plan
    over ``total_byte_size``, and the same batches."""
    src = {"dir": files, "glob": os.path.join(files, "*.parquet"),
           "list": [os.path.join(files, f"part_{i}.parquet") for i in (2, 0)]}[source]
    want, got = jnvt.Dataset(src, part_size=part_size), pnvt.Dataset(src, part_size=part_size)
    assert [(p.path, p.row_groups, p.num_rows) for p in got._partitions] == \
        [(p.path, p.row_groups, p.num_rows) for p in want._partitions]
    assert got.num_rows == want.num_rows and got.npartitions == want.npartitions
    for g, w in zip(got.to_batches(columns=["f64", "i32"]), want.to_batches(columns=["f64", "i32"])):
        assert g.row_offset == w.row_offset
        assert_same_batch(g, w)


def test_dataset_surface_matches_jax(files):
    """to_table, to_iter, head, sample_batch, infer_schema, repartition and
    a sharded stream."""
    want, got = jnvt.Dataset(files, part_size="600KB"), pnvt.Dataset(files, part_size="600KB")
    assert_same_batch(got.to_table(), want.to_table())
    for g, w in zip(got.to_iter(), want.to_iter()):
        assert_same_batch(g, w)
    head = want.head(7)
    got_head = got.head(7)
    assert got_head.column_names == list(head.columns)
    for name in head.columns:
        np.testing.assert_array_equal(got_head[name].values.numpy(), head[name].to_numpy())
    assert_same_batch(got.sample_batch(100), want.sample_batch(100))
    assert [(c.name, c.dtype.name) for c in got.infer_schema()] == [(c.name, c.dtype.name) for c in want.schema]
    for g, w in zip(got.repartition(5).to_batches(), want.repartition(5).to_batches()):
        assert_same_batch(g, w)
    for g, w in zip(got.to_batches(shard=(1, 3)), want.to_batches(shard=(1, 3))):
        assert g.row_offset == w.row_offset
        assert_same_batch(g, w)


def test_dataset_to_parquet_round_trips_bit_for_bit(parts, tmp_path):
    """Memory partitions → ``to_parquet`` (one file a partition) → the
    file-backed Dataset: every value's bits come back, NaN included."""
    port_dataset(parts).to_parquet(str(tmp_path / "o"))
    back = pnvt.Dataset(str(tmp_path / "o"))
    assert back.npartitions == len(parts)
    for batch, part in zip(back.to_batches(), parts):
        for name, values in part.items():
            np.testing.assert_array_equal(bits(batch[name].values.numpy()), bits(values), err_msg=name)


# --- end to end: Criteo-shaped parquet → fit → transform → shuffled write → loader → DLRM -----------
CATS = ["t0", "t1", "d0", "w0", "w1"]
CONTS = ["I0", "I1", "I2"]


def criteo_part(seed, n=20_000):
    """Tiny, direct and cuckoo-sized int columns, 3 floats with ~5% NaN, an
    int32 label (tests/test_torch_loader.py's partition at parquet size)."""
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


def criteo_graph(ops):
    cats = CATS >> ops.Categorify()
    conts = CONTS >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.Normalize()
    return cats + conts + ["label"]


def test_criteo_parquet_etl_shuffled_write_loader_dlrm_matches_jax(tmp_path, monkeypatch):
    """Criteo-shaped partitions as parquet → fit → transform →
    ``to_parquet(shuffle=PER_WORKER)`` → ``Dataset`` → ``DeviceLoader(shuffle=
    False)`` → DLRM (JAX parameters carried across) → 3 Adagrad steps,
    against the JAX package on the same files. The codes are equal; floats
    within rtol=atol=1e-5 (log1p ULPs); each output file holds the reference's
    rows in the reference's order (the same writer seeds)."""
    monkeypatch.chdir(tmp_path)  # Categorify's artifacts go under ./categories in both packages
    port_dataset([criteo_part(s) for s in range(4)]).to_parquet("in")
    jwf = jnvt.Workflow(criteo_graph(jops), executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jnvt.Dataset("in"))
    jwf.transform(jnvt.Dataset("in")).to_parquet("jout", shuffle=JShuffle.PER_WORKER, out_files_per_proc=3)
    pwf = pnvt.Workflow(criteo_graph(pops), device="cpu")
    pwf.fit(pnvt.Dataset("in"))
    pwf.transform(pnvt.Dataset("in")).to_parquet("pout", shuffle=PShuffle.PER_WORKER, out_files_per_proc=3)

    assert sorted(os.listdir("pout")) == sorted(os.listdir("jout"))
    for name in sorted(os.listdir("jout")):
        if not name.endswith(".parquet"):
            continue
        want, got = pq.read_table(f"jout/{name}"), pnpq.read_row_groups(f"pout/{name}")
        assert list(got) == want.column_names
        for col in want.column_names:
            w = want[col].to_numpy()
            assert got[col].dtype == w.dtype, col
            if col in CONTS:
                np.testing.assert_allclose(got[col], w, **CONT_TOL, err_msg=col)
            else:
                np.testing.assert_array_equal(got[col], w, err_msg=col)

    common = dict(cat_names=CATS, cont_names=CONTS, label_names=["label"], shuffle=False, batch_size=1024)
    jbatches = list(JDeviceLoader(jnvt.Dataset("jout"), **common))[:3]
    pbatches = list(DeviceLoader(pnvt.Dataset("pout"), device="cpu", **common))[:3]
    kwargs = dict(embedding_dim=8, bottom_mlp=(32, 16), top_mlp=(32, 16))
    jconfig = jdlrm.DLRMConfig.from_schema(jwf.output_schema, **kwargs)
    pconfig = pmodels.DLRMConfig.from_schema(pwf.output_schema, **kwargs)
    assert pconfig.cardinalities == jconfig.cardinalities
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
        np.testing.assert_allclose(got["tables"][name], np.asarray(jp["tables"][name]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("shuffle", SHUFFLES, ids=[s or "unshuffled" for s in SHUFFLES])
def test_transformed_to_parquet_bytes_match_jax(tmp_path, monkeypatch, shuffle):
    """A workflow whose outputs are bit-exact on both sides (Categorify,
    FillMissing) writes the reference's files byte for byte, in every
    shuffle mode (the two-phase form: transform, then the host writer)."""
    monkeypatch.chdir(tmp_path)
    parts = [criteo_part(s, n) for s, n in enumerate(ROWS)]
    jwf = jnvt.Workflow((CATS >> jops.Categorify()) + (CONTS >> jops.FillMissing()) + ["label"],
                        executor=JitExecutor(jit_min_rows=0))
    jwf.fit(jax_dataset(parts))
    pwf = pnvt.Workflow((CATS >> pops.Categorify()) + (CONTS >> pops.FillMissing()) + ["label"], device="cpu")
    pwf.fit(port_dataset(parts))
    jwf.transform(jax_dataset(parts)).to_parquet("j", shuffle=shuffle and JShuffle[shuffle], output_files=3)
    pwf.transform(port_dataset(parts)).to_parquet("p", shuffle=shuffle and PShuffle[shuffle], output_files=3)
    assert pwf.transform(port_dataset(parts)).num_rows == sum(ROWS)
    assert_same_files("p", "j")


def test_default_codec_follows_the_library(monkeypatch):
    """Unset, the codec is "auto" where the library has zstd and "none"
    (uncompressed) where it has not, as on a machine without ``zstd.h``;
    ``NVT_PARQUET_COMPRESSION`` overrides it, and "none" or "" is None."""
    from nvtabular_tpu_torch.io import writer

    monkeypatch.delenv("NVT_PARQUET_COMPRESSION", raising=False)
    for has, want in ((True, "auto"), (False, None)):
        monkeypatch.setattr(pnpq, "has_zstd", lambda has=has: has)
        assert writer.resolve_compression(None) == want
    monkeypatch.setenv("NVT_PARQUET_COMPRESSION", "zstd")
    assert writer.resolve_compression(None) == "zstd"
    assert writer.resolve_compression("none") is None and writer.resolve_compression("") is None
