"""nvtabular_tpu_torch stands alone: it runs with JAX and the JAX package
made unimportable, its parquet I/O with pyarrow unimportable too (the card's
machine has none), and neither its sources nor chip_smoke.py import them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "nvtabular_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["nvtabular_tpu"] = None
import numpy as np
import nvtabular_tpu_torch as nvt
from nvtabular_tpu_torch import ops

rng = np.random.default_rng(0)
def part(seed):
    r = np.random.default_rng(seed)
    x = r.normal(1.0, 3.0, 4000).astype(np.float32)
    x[r.random(4000) < 0.05] = np.nan
    return {
        "tiny": r.integers(0, 30, 4000).astype(np.int32),
        "direct": r.integers(0, 6000, 4000).astype(np.int32),
        "wide": ((r.integers(0, 9000, 4000) * 2654435761) % 2**31).astype(np.int32),
        "x": x,
        "label": r.integers(0, 2, 4000).astype(np.int32),
    }
parts = [part(s) for s in range(3)]
cats = ["tiny", "direct", "wide"] >> ops.Categorify()
conts = ["x"] >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.Normalize()
wf = nvt.Workflow(cats + conts + ["label"], device="cpu")
out = list(wf.fit_transform(nvt.Dataset(parts)).to_batches())
assert len(out) == 3 and out[0].column_names == ["tiny", "direct", "wide", "x", "label"]
assert int(out[0]["wide"].values.min()) >= 3
from nvtabular_tpu_torch import models
from nvtabular_tpu_torch.loader import DeviceLoader
loader = DeviceLoader(wf.transform(nvt.Dataset(parts)), 1000, cat_names=["tiny", "direct", "wide"],
                      cont_names=["x"], label_names=["label"], device="cpu")
config = models.DLRMConfig.from_schema(wf.output_schema, embedding_dim=4, bottom_mlp=(8,), top_mlp=(8,))
model = models.DLRM(config, device="cpu")
losses = models.train_chunk(model, models.Adagrad(model.parameters()), next(loader.chunks()), 1000)
assert losses.shape == (4,) and bool(losses.isfinite().all())
for p in parts:
    p["rating"] = (p["label"] + p["x"]).astype(np.float32)
te = ["tiny", "direct"] >> ops.TargetEncoding("rating", kfold=3, p_smooth=20)
jg = ["wide"] >> ops.JoinGroupby(cont_cols=["x"], stats=["mean", "count"])
lam = ["x"] >> ops.LambdaOp(np.abs) >> ops.Bucketize([0.5, 1.0, 2.0])
cross = ["tiny", "direct"] >> ops.HashedCross(100)
adv = nvt.Workflow(te + jg + lam + cross, device="cpu")
out = list(adv.fit_transform(nvt.Dataset(parts)).to_batches())
assert out[2].column_names == ["TE_tiny_rating", "TE_direct_rating", "wide_x_mean", "wide_count", "x",
                               "direct_X_tiny"]
assert int(out[2]["direct_X_tiny"].values.max()) < 100 and int(out[2]["x"].values.max()) <= 3
for s, p in enumerate(parts):
    r = np.random.default_rng(10 + s)
    offsets = np.concatenate([[0], np.cumsum(r.integers(0, 5, 4000))])
    p["genres"] = nvt.Column(r.integers(1, 21, int(offsets[-1])), offsets)
tables = [nvt.TableBatch(p) for p in parts]
cats = ["tiny", "direct", "genres"] >> ops.Categorify()
label = ["rating"] >> ops.LambdaOp(lambda col: (np.asarray(col) > 1).astype(np.float32))
mh = nvt.Workflow(cats + (["x"] >> ops.FillMissing() >> ops.Clip(min_value=0.0) >> ops.LogOp() >> ops.Normalize())
                  + label, device="cpu")
mh.fit(nvt.Dataset(tables))
loader = DeviceLoader(mh.transform(nvt.Dataset(tables)), 1000, cat_names=["tiny", "direct", "genres"],
                      cont_names=["x"], label_names=["rating"], sparse_max={"genres": 4}, device="cpu")
single, multi = ops.get_embedding_sizes(mh)
model = models.TabularMLP(models.TabularMLPConfig(single, 1, layer_sizes=(8,), multihot_embedding_sizes=multi),
                          device="cpu")
chunk = next(loader.chunks())
chunk["continuous"] = chunk.pop("dense")
losses = models.train_chunk(model, models.Adagrad(model.parameters()), chunk, 1000, models.tabular_mlp_loss)
assert losses.shape == (4,) and bool(losses.isfinite().all()) and multi == {"genres": (23, 16)}
sliced = nvt.Workflow(["genres"] >> ops.Categorify() >> ops.ListSlice(0, 3, pad=True), device="cpu")
out = list(sliced.fit_transform(nvt.Dataset(tables)).to_batches())
assert out[0]["genres"].values.shape == (12000,) and int(out[0]["genres"].offsets[-1]) == 12000
crossed = ([["tiny", "wide"]] >> ops.TargetEncoding("rating", kfold=3)) + \
    ([["tiny", "direct"]] >> ops.JoinGroupby(cont_cols=["x"], stats=["count"])) + \
    ([["tiny", "direct"]] >> ops.Categorify(encode_type="combo")) + (["wide"] >> ops.HashBucket(1000)) + \
    (["x", "rating"] >> ops.DifferenceLag("tiny", shift=[1, -1]))
cw = nvt.Workflow(crossed, device="cpu")
out = list(cw.fit_transform(nvt.Dataset(parts)).to_batches())
assert out[0].column_names == ["TE_tiny_wide_rating", "tiny_direct_count", "tiny_direct", "wide",
                               "x_difference_lag_1", "rating_difference_lag_1", "x_difference_lag_-1",
                               "rating_difference_lag_-1"], out[0].column_names
assert int(out[0]["tiny_direct"].values.min()) >= 3 and int(out[0]["wide"].values.max()) < 1000
assert not any(m == "jax" or m.startswith(("jax.", "nvtabular_tpu.")) for m in sys.modules
               if sys.modules[m] is not None)
print("STANDALONE_OK")
"""


def test_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "STANDALONE_OK" in proc.stdout


PARQUET_BLOCKED_RUN = r"""
import os, sys, tempfile
for name in ("jax", "nvtabular_tpu", "pyarrow", "pandas"):
    sys.modules[name] = None
import numpy as np
import nvtabular_tpu_torch as nvt
from nvtabular_tpu_torch import ops
from nvtabular_tpu_torch.io import Shuffle

tmp = tempfile.mkdtemp()
r = np.random.default_rng(0)
parts = [{"a": r.integers(0, 5000, 20000).astype(np.int32), "x": r.normal(size=20000).astype(np.float32)}
         for _ in range(3)]
nvt.Dataset(parts).to_parquet(os.path.join(tmp, "in"))
files = nvt.Dataset(os.path.join(tmp, "in"))
assert files.num_rows == 60000 and files.npartitions == 3
op = ops.Categorify(out_path=os.path.join(tmp, "cats"), cat_cache="disk")
wf = nvt.Workflow((["a"] >> op) + ["x"], device="cpu")
wf.fit(files)
wf.transform(files).to_parquet(os.path.join(tmp, "out"), shuffle=Shuffle.PER_WORKER, out_files_per_proc=2)
out = nvt.Dataset(os.path.join(tmp, "out")).to_table()
assert out.num_rows == 60000 and int(out["a"].values.min()) >= 3 and not op.vocabs["a"].resident
assert op.cache_stats["reloads"] == 3
assert not any(m == "pyarrow" or m.startswith("pyarrow.") for m in sys.modules if sys.modules[m] is not None)
print("PARQUET_STANDALONE_OK")
"""


def test_parquet_runs_with_pyarrow_blocked():
    """Files in, the fit with the disk tier, the shuffled write and the read
    back, with pyarrow (and pandas) unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", PARQUET_BLOCKED_RUN], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PARQUET_STANDALONE_OK" in proc.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_reference(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "nvtabular_tpu", "pyarrow")
    ]
    assert not bad, f"{path} imports {bad}"
