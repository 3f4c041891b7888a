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
    "cont_chain": 0,
    "permute_rows": 0,
    "embedding_gather": 0,
    "embedding_scatter_grad": 0,
    "interaction_fwd": 0,
    "interaction_bwd": 0,
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


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
