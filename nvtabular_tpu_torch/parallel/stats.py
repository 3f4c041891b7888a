"""Sharded moments over the ranks of a mesh axis.

Counterpart of ``nvtabular_tpu/parallel/stats.py:27-92``. Each rank reduces
the rows it holds to per-column partials with kernel K15c (count, mean, the
shifted second moment M2, min, max; NaN as null); one all-gather brings
every rank's partials to every rank, and the host combines them in float64
with Chan et al.'s pairwise update, folded left in rank order as the
reference folds its devices. Counts are integers (exact past 2**24 rows);
M2 about each shard's own mean stays conditioned where sum x^2 - n mean^2
would cancel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..kernels.moments import column_moments
from .mesh import all_gather, mesh_device


def sharded_moments(x, mesh, axis: str = "data") -> Dict[str, np.ndarray]:
    """Global {count, mean, var, std, min, max} (host float64, [cols] each)
    of the float32 [rows, cols] rows every rank of ``axis`` holds (this
    rank's are ``x``). Variance takes ddof=1, as the reference's moments."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(mesh_device(mesh))
    count, mean, m2, mn, mx = column_moments(x.to(torch.float32).contiguous())
    parts = torch.stack([count.double(), mean.double(), m2.double(), mn.double(), mx.double()])
    gathered = all_gather(parts, mesh.get_group(axis)).cpu().numpy()  # [n_shards, 5, cols]
    counts, means, m2s = gathered[:, 0].astype(np.int64), gathered[:, 1], gathered[:, 2]

    count = counts[0].astype(np.float64)
    mean_ = means[0].copy()
    m2_ = m2s[0].copy()
    for i in range(1, counts.shape[0]):
        nb = counts[i].astype(np.float64)
        n = count + nb
        safe_n = np.maximum(n, 1.0)
        delta = means[i] - mean_
        mean_ = mean_ + delta * nb / safe_n
        m2_ = m2_ + m2s[i] + delta * delta * count * nb / safe_n
        count = n

    mean_ = np.where(count > 0, mean_, 0.0)
    var = np.maximum(m2_ / np.maximum(count - 1.0, 1.0), 0.0)
    return {
        "count": count,
        "mean": mean_,
        "var": var,
        "std": np.sqrt(var),
        "min": gathered[:, 3].min(axis=0),
        "max": gathered[:, 4].max(axis=0),
    }
