"""The training loss and its gradient: CUDA kernel K20, wrappers, host plan,
plain versions and the autograd function ``bce_with_logits`` goes through.

``nvtabular_tpu/models/layers.py:144-150`` (``bce_with_logits``) is one
fused reduction under ``jax.jit``: the mean over the batch of
``max(l, 0) - l * y + log1p(exp(-|l|))``. ``bce_fwd`` is that mean in one
launch (fixed per-block partials, the last block summing them in order, so
the same bits from run to run); ``bce_bwd`` is ``jax.grad``'s expression
for it, term by term:

    g = grad_output / B                           (a division, not a product)
    d = (s + (-g) * y) + g * w                    w: 1 for l > 0, 0.5 at l == 0
    s = -(c * e) for l >= 0, else 0 + c * e       (``abs``'s gradient: +1 at 0)
    c = g / (e + 1), e = exp(-|l|)                (``log1p``'s, then ``exp``'s)

in the order JAX's backward pass adds them. ``grad_output`` is read on the
device through its pointer: no host sync. Labels take no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, ptr, raise_on_error, stream_ptr, tickets, use_kernel
from .build import library

THREADS = 256  # csrc/bce.cu kThreads
ITEMS = 4  # elements a thread takes in each turn of the grid
MAX_BLOCKS = 264  # two blocks on each of an H100's 132 SMs; a constant, so the sum's bits depend on B alone

# logits, logits stride, labels, labels stride, B, partial, tickets, loss, blocks, stream
_FWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
                 + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
# logits, logits stride, labels, labels stride, grad_output, B, dlogits, stream
_BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                  ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])


def loss_blocks(B: int) -> int:
    """The forward's blocks: one for each THREADS * ITEMS elements, at most
    MAX_BLOCKS, whose threads then walk the rest in turns."""
    return max(1, min(-(-B // (THREADS * ITEMS)), MAX_BLOCKS))


def _check(logits: torch.Tensor, labels: torch.Tensor) -> int:
    for what, t in (("logits", logits), ("labels", labels)):
        if t.dim() != 1 or t.dtype != torch.float32:
            raise ValueError(f"{what} must be float32 [B], got {t.dtype} {tuple(t.shape)}")
    if labels.shape != logits.shape or labels.device != logits.device:
        raise ValueError(f"labels {tuple(labels.shape)} on {labels.device} must match logits "
                         f"{tuple(logits.shape)} on {logits.device}")
    return logits.shape[0]


def bce_fwd(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean binary cross-entropy of float32 ``logits`` [B] against
    ``labels`` [B] (either may be strided) → a 0-d float32 tensor."""
    B = _check(logits, labels)
    if not use_kernel(logits):
        return bce_fwd_plain(logits, labels)
    dev = logits.device
    loss = torch.empty((), dtype=torch.float32, device=dev)
    if B == 0:
        return loss.fill_(float("nan"))  # torch.mean of nothing
    blocks = loss_blocks(B)
    partial = torch.empty(blocks, dtype=torch.float64, device=dev)
    fn = library("bce").nvt_bce_fwd
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    stream = stream_ptr(dev)
    rc = fn(ptr(logits), logits.stride(0), ptr(labels), labels.stride(0), B, ptr(partial),
            ptr(tickets(dev, stream, 1)), ptr(loss), blocks, stream)
    raise_on_error(rc, "bce_fwd")
    LAUNCHES["bce_fwd"] += 1
    return loss


def bce_bwd(logits: torch.Tensor, labels: torch.Tensor, grad_output: torch.Tensor) -> torch.Tensor:
    """dloss/dlogits [B] (contiguous) for the 0-d float32 ``grad_output``."""
    B = _check(logits, labels)
    if grad_output.numel() != 1 or grad_output.dtype != torch.float32 or grad_output.device != logits.device:
        raise ValueError(f"grad_output must be one float32 on {logits.device}, got {grad_output.dtype} "
                         f"{tuple(grad_output.shape)} on {grad_output.device}")
    if not use_kernel(logits):
        return bce_bwd_plain(logits, labels, grad_output)
    dev = logits.device
    dlogits = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return dlogits
    fn = library("bce").nvt_bce_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(logits), logits.stride(0), ptr(labels), labels.stride(0), ptr(grad_output), B, ptr(dlogits),
            stream_ptr(dev))
    raise_on_error(rc, "bce_bwd")
    LAUNCHES["bce_bwd"] += 1
    return dlogits


def bce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # torch.maximum, like jnp.maximum, propagates NaN
    zero = torch.zeros_like(logits)
    return torch.mean(torch.maximum(logits, zero) - logits * labels + torch.log1p(torch.exp(-logits.abs())))


def bce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor, grad_output: torch.Tensor) -> torch.Tensor:
    l, y = logits, labels
    # a divisor on the device: ATen multiplies by the reciprocal of a Python scalar on CUDA
    g = grad_output.reshape(()) / torch.full((), l.shape[0], dtype=torch.float32, device=l.device)
    e = torch.exp(-l.abs())
    tie = torch.where(l > 0, 1.0, torch.where(l == 0, 0.5, 0.0))  # jnp.maximum's gradient at l vs 0
    c = g / (e + 1) * e
    s = torch.where(l >= 0, -c, c + 0.0)  # jnp.abs's gradient, +1 at 0
    return (s + (-g) * y) + g * tie


class BCEWithLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, plain):
        if ctx.needs_input_grad[1]:
            raise ValueError("bce_with_logits: labels take no gradient")
        ctx.save_for_backward(logits, labels)
        ctx.plain = plain
        return (bce_fwd_plain if plain else bce_fwd)(logits, labels)

    @staticmethod
    def backward(ctx, grad_output):
        logits, labels = ctx.saved_tensors
        return (bce_bwd_plain if ctx.plain else bce_bwd)(logits, labels, grad_output), None, None


__all__ = ["BCEWithLogits", "bce_bwd", "bce_bwd_plain", "bce_fwd", "bce_fwd_plain", "loss_blocks"]
