"""Hashes of tensors: the counterpart of ``nvtabular_tpu/dispatch.py:32-85``.

``hash_lanes`` and ``hash_array`` return uint32 hashes held in int64
tensors (PyTorch has no full uint32 arithmetic), equal bit for bit to the
reference's device path for int32 and float32 values and to its host path
for int64 values outside int32 (see ``kernels/hash.py``). For CUDA tensors
``hash_array`` launches kernel K7 and ``hash_lanes`` the lanes kernel of
``csrc/hash_pair.cu``; CPU tensors take their plain versions.
"""

from __future__ import annotations

import torch

from .kernels import hash_pair as khp
from .kernels.hash import hashed_cross

__all__ = ["hash_array", "hash_lanes"]


def hash_lanes(lo: torch.Tensor, hi: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Hash two uint32 lanes (held in int64, each in [0, 2**32)) to a uint32."""
    return khp.hash_lanes(lo, hi, seed)


def hash_array(values: torch.Tensor, seed: int = 0, float_bits: int = 32) -> torch.Tensor:
    """Deterministic per-element hash of a 1-d numeric tensor. Floats hash
    the bits of their float32 value, as the reference's device path does,
    or with ``float_bits=64`` those of their float64 value, as its host path
    does (``Dataset.shuffle_by_keys`` and DataStats run there)."""
    if float_bits == 64 and values.is_floating_point():
        bits = values.to(torch.float64).view(torch.int64)
        return hash_lanes(bits & 0xFFFFFFFF, (bits >> 32) & 0xFFFFFFFF, seed)
    return hashed_cross([values], None, seed)
