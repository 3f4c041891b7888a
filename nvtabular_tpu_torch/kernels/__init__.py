"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Every wrapper takes tensors on one device. For CPU tensors it runs the plain
PyTorch version beside it; for CUDA tensors it launches the kernel on the
current stream, or raises. ``LAUNCHES`` counts kernel launches per wrapper
(plain-version calls are not counted), so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

LAUNCHES: Dict[str, int] = {
    "tiny_lookup": 0,
    "direct_lookup": 0,
    "cuckoo_lookup": 0,
    "sorted_lookup": 0,
    "cont_chain": 0,
    "cont_chain_16": 0,
    "cont_chain_mask": 0,
    "permute_rows": 0,
    "embedding_gather": 0,
    "embedding_scatter_grad": 0,
    "interaction_fwd": 0,
    "interaction_bwd": 0,
    "interaction_self_fwd": 0,
    "interaction_self_bwd": 0,
    "hashed_cross": 0,
    "fold_ids": 0,
    "te_encode": 0,
    "stat_gather": 0,
    "bucketize": 0,
    "ragged_to_padded": 0,
    "ragged_slice_padded": 0,
    "ragged_segment_reduce": 0,
    "embedding_bag_fwd": 0,
    "embedding_bag_bwd": 0,
    "hash_pair": 0,
    "hash_pair_verify": 0,
    "hash_lanes": 0,
    "difference_lag": 0,
    "fm_fwd": 0,
    "fm_bwd": 0,
    "cross_fwd": 0,
    "cross_bwd": 0,
    "exchange_route": 0,
    "radix_sort": 0,
    "embedding_range_gather": 0,
    "embedding_range_bag": 0,
    "range_gather_columns": 0,
    "range_scatter_grad": 0,
    "range_bag": 0,
    "range_bag_grad": 0,
    "column_moments": 0,
    "cin_fwd": 0,
    "cin_bwd": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise NotImplementedError(f"no kernel or plain version for device {t.device}")


def check(t: Optional[torch.Tensor], what: str, dtype, device, shape=None, optional=False):
    if t is None:
        if optional:
            return
        raise ValueError(f"{what} is required")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what}: expected device {device}, got {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def check_rows(t: torch.Tensor, what: str, shape, device) -> None:
    """A float32 [B, W] view whose rows may be strided (a slot of a wider
    buffer) but whose W floats are contiguous."""
    if t.dtype != torch.float32 or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected float32 {tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if shape[0] and shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{what}: each row's floats must be contiguous, strides {t.stride()}")


def vec_width(D: int, *tensors: torch.Tensor) -> int:
    """4 (float4 accesses) when D and every row start are 16-byte aligned, else 1."""
    aligned = all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 for t in tensors)
    return 4 if D % 4 == 0 and aligned else 1


def check_range_table(table: torch.Tensor, start: int) -> None:
    """A rank's rows of a row-sharded table: float32 [rows_local >= 1, D]."""
    if table.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"table must be [rows_local >= 1, D], got shape {tuple(table.shape)}")
    check(table, "table", torch.float32, table.device)
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start}")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


# the reference's public kernels (nvtabular_tpu/kernels/__init__.py); the
# padded bag is K13c's
from .embedding_bag import embedding_bag as padded_embedding_bag  # noqa: E402
from .ragged import ragged_segment_reduce, ragged_slice_padded, ragged_to_padded  # noqa: E402

__all__ = ["LAUNCHES", "padded_embedding_bag", "ragged_segment_reduce", "ragged_slice_padded", "ragged_to_padded",
           "reset_launches"]
