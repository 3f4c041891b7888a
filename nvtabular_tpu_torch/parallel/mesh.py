"""Process groups and device meshes on ``torch.distributed``.

Counterpart of ``nvtabular_tpu/parallel/mesh.py:19-65``. The JAX package
runs one controller over a named ``Mesh`` of devices; PyTorch runs one
process a GPU. So a mesh here is a ``DeviceMesh`` over the ranks of the
default process group, and rank ``r`` does what device ``r`` of a JAX mesh
of the same shape does. The axes keep the JAX package's names: ``data``
(batch and partition parallel) and ``model`` (embedding-table rows).

The backend follows the device: ``nccl`` for CUDA (one card a rank, the
device set before any collective), ``gloo`` for the CPU. A collective's
tensors follow the group's backend, not the data's device
(``comm_device``).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    timeout: Optional[float] = None,
) -> None:
    """Initialize the default process group once; later calls do nothing.

    ``backend`` is ``nccl`` by default (one CUDA device a rank: rank ``r``
    takes device ``r % device_count``) and ``gloo`` on request, for the CPU.
    ``init_method`` (e.g. ``tcp://localhost:29500`` or ``file:///path``),
    ``rank`` and ``world_size`` go to ``init_process_group``; left None, it
    reads them from the environment (``MASTER_ADDR``, ``RANK``, ...).
    ``timeout`` is in seconds: a collective that waits longer on a lost rank
    raises instead of hanging."""
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_distributed uses NCCL on CUDA devices by default and no CUDA device is "
                "available; pass backend='gloo' to run on the CPU"
            )
        local = rank if rank is not None else int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kwargs = {}
    if init_method is not None:
        kwargs["init_method"] = init_method
    if rank is not None:
        kwargs["rank"] = rank
    if world_size is not None:
        kwargs["world_size"] = world_size
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, **kwargs)


def make_mesh(axes: Dict[str, int], devices: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` from axis name → size over ``devices`` (ranks; all
    ranks of the default group by default). The sizes must multiply to the
    number of ranks; a single ``-1`` axis takes the remainder (the JAX
    package's rules). Lay ``model`` innermost, so its ranks are neighbours."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    n = len(ranks)
    sizes = dict(axes)
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = int(np.prod([v for v in sizes.values() if v != -1])) if sizes else 1
    if wild:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[wild[0]] = n // fixed
    elif fixed != n:
        raise ValueError(f"axis sizes {sizes} do not multiply to {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(tuple(sizes.values()))
    return DeviceMesh(device_type, mesh, mesh_dim_names=tuple(sizes))


def local_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence[int]] = None):
    """The 2-axis (data, model) mesh."""
    return make_mesh({"data": data, "model": model}, devices)


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on: its CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def comm_device(group=None) -> torch.device:
    """Where a collective's tensors must lie: the current CUDA device for an
    NCCL group, the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_to_all(t: torch.Tensor, group=None, out_splits=None, in_splits=None) -> torch.Tensor:
    """``all_to_all_single`` of ``t`` (equal splits unless given, in elements
    of the first dimension), through the group's device; the result on
    ``t``'s device."""
    dev = comm_device(group)
    src = t.to(dev)
    rows = sum(out_splits) if out_splits is not None else t.shape[0]
    out = torch.empty((rows, *t.shape[1:]), dtype=t.dtype, device=dev)
    dist.all_to_all_single(out, src, output_split_sizes=out_splits, input_split_sizes=in_splits, group=group)
    return out.to(t.device)


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group``, in place when it lies on the group's device."""
    dev = comm_device(group)
    if t.device == dev:
        dist.all_reduce(t, op=op, group=group)
        return t
    out = t.to(dev)
    dist.all_reduce(out, op=op, group=group)
    return t.copy_(out)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all), stacked in rank order on ``t``'s device."""
    dev = comm_device(group)
    n = dist.get_world_size(group)
    src = t.to(dev).reshape(1, -1).contiguous()
    out = torch.empty((n, src.shape[1]), dtype=t.dtype, device=dev)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=group)
    return out.reshape(n, *t.shape).to(t.device)
