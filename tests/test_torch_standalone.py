"""nvtabular_tpu_torch stands alone: it runs with JAX and the JAX package
made unimportable, and neither its sources nor chip_smoke.py import them."""

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
        if m == "jax" or m.startswith("jax.") or m == "nvtabular_tpu" or m.startswith("nvtabular_tpu.")
    ]
    assert not bad, f"{path} imports {bad}"
