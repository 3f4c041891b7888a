"""Build and load the hand-written CUDA kernels of the port.

Each source under ``nvtabular_tpu_torch/csrc/`` has a plain C interface and
compiles with ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. Builds start all together (one ``nvcc`` per source) at first use
and land in ``build/nvt_torch_kernels/`` at the root of the checkout, named by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an unchanged source is never rebuilt.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "lookup": _PKG / "csrc" / "lookup.cu",
    "cont_chain": _PKG / "csrc" / "cont_chain.cu",
    "permute": _PKG / "csrc" / "permute.cu",
    "embedding": _PKG / "csrc" / "embedding.cu",
    "interaction": _PKG / "csrc" / "interaction.cu",
    "hash": _PKG / "csrc" / "hash.cu",
    "groupby": _PKG / "csrc" / "groupby.cu",
    "bucketize": _PKG / "csrc" / "bucketize.cu",
    "ragged": _PKG / "csrc" / "ragged.cu",
    "embedding_bag": _PKG / "csrc" / "embedding_bag.cu",
    "hash_pair": _PKG / "csrc" / "hash_pair.cu",
    "difference_lag": _PKG / "csrc" / "difference_lag.cu",
    "fm": _PKG / "csrc" / "fm.cu",
    "cross": _PKG / "csrc" / "cross.cu",
    "exchange": _PKG / "csrc" / "exchange.cu",
    "moments": _PKG / "csrc" / "moments.cu",
    "sharded_embedding": _PKG / "csrc" / "sharded_embedding.cu",
}
BUILD_DIR = _PKG.parent / "build" / "nvt_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# `-Xptxas -v` report of each build: registers, shared memory, spills
PTXAS_REPORT: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted((_PKG / "csrc").glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"libnvt_{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, ctypes.CDLL]:
    """Compile every missing library at once (one nvcc process per source)
    and load them all. Raises with the compiler's output on any failure."""
    names = list(SOURCES) if names is None else names
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            target = _target(name)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
                target,
            )
        for name, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            PTXAS_REPORT[name] = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name].name}:\n{out}")
            os.replace(tmp, target)
        for name in todo:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return {n: _LIBS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all([name])[name]
