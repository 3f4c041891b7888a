"""Hashes of tensors: the counterpart of ``nvtabular_tpu/dispatch.py:32-85``.

``hash_lanes`` and ``hash_array`` return uint32 hashes held in int64
tensors (PyTorch has no full uint32 arithmetic), equal bit for bit to the
reference's device path for int32 and float32 values and to its host path
for int64 values outside int32 (see ``kernels/hash.py``). ``hash_array``
launches kernel K7 for a CUDA tensor.
"""

from __future__ import annotations

import torch

from .kernels.hash import hash_lanes_plain, hashed_cross

__all__ = ["hash_array", "hash_lanes"]

UNSUPPORTED_DEVICE_LANES = (
    "hash_lanes of device tensors is not ported yet "
    "(ROADMAP.md queue 2: K10b, the multi-key hash-pair index)"
)


def hash_lanes(lo: torch.Tensor, hi: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash two uint32 lanes (held in int64, each in [0, 2**32)) to a uint32.
    Only the multi-key group index (K10b) combines hashes this way on the
    device, and it is not ported: device tensors raise."""
    if lo.device.type != "cpu":
        raise NotImplementedError(UNSUPPORTED_DEVICE_LANES)
    return hash_lanes_plain(lo, hi, seed)


def hash_array(values: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Deterministic per-element hash of a 1-d numeric tensor."""
    return hashed_cross([values], None, seed)
