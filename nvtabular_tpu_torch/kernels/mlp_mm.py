"""The MLP and DCN cross-layer products of the training step: CUDA kernel
K21, its host plan, wrapper, plain versions and the autograd function
``MLP`` and ``CrossNetwork`` go through.

``nvtabular_tpu/models/layers.py:59-62`` multiplies each layer's
``compute_dtype``-rounded input and weight with ``jnp.dot(...,
preferred_element_type=jnp.float32)`` on the MXU, and DCN's cross layers
do the same (``nvtabular_tpu/models/deepfm.py:126-131``); XLA fuses the
bias, ReLU and the hidden layer's round into the product's epilogue. Here
(``csrc/mlp_mm.cu``):

* ``mlp_mm_fwd(h, w, b, relu, round_dtype, exact)``: ``h @ w`` with the
  layer's epilogue fused into the store (``mlp_epilogue_fwd_plain``'s
  arithmetic), ``round_c(relu(h @ w + b))`` and the mask
  ``z > 0`` where ReLU applies (``b`` None: the product alone, a cross
  layer's ``xw``);
* ``mlp_mm_dgrad(dz, w, ...)``: ``dz @ w.T``, the input's gradient;
* ``mlp_mm_wgrad(h, dz, ...)``: ``h.T @ dz``, the weight's gradient, split
  along the batch with the splits summed in a fixed order (the same bits
  from run to run).

The products run in bfloat16 on the tensor cores with float32 sums. An
operand whose values are bfloat16 (``exact``: the rounded inputs and
weights, a hidden layer's rounded gradient) is converted exactly; any other
float32 operand is split into three bfloat16 pieces whose sum is the value
(``operand_pieces``), so every product is exact and only the float32 sums
round, in another order than ``torch.matmul``'s.

``MLPProduct`` is the layer's autograd function: the backward runs K19's
``mlp_epilogue_bwd`` for dz (where the layer has a bias, ReLU or a round),
then ``mlp_mm_dgrad`` where autograd needs the input's gradient and
``mlp_mm_wgrad``. With ``plain=True`` it runs the plain versions
(``torch.matmul`` in float32 and K19's plain epilogue) on any device: the
reference forwards that the kernels are held against on the card.
``plain_products`` gives the plain path another order of the same sums
for a while (K21's, float64's, the depth reversed), so that a reference
step can share its products with the kernels' step or measure what a
change of order alone moves.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import LAUNCHES, ptr, raise_on_error, stream_ptr, tickets, use_kernel
from .build import library
from .mlp_epilogue import ROUND_KINDS, mlp_epilogue_bwd, mlp_epilogue_bwd_plain, mlp_epilogue_fwd_plain

ROWS = 128  # csrc/mlp_mm.cu kRows: a tile's rows of C (64 a warpgroup)
DEPTH = 32  # kDepth: a step's depth along K
BUFS = 3  # kBufs: the ring of staged steps
COLS = (8, 16, 64, 128)  # a tile's columns: wgmma's n-widths the kernel is built for
SPLIT_COLS = 64  # the widest tile with a split operand (two accumulators a thread)
# blocks a launch aims at when it splits K: 2 blocks on each of an H100's
# 132 SMs (a constant, so that the splits, and so the bits, depend on the
# shape alone)
TARGET_BLOCKS = 264
MIN_SPLIT_STEPS = 8  # the least depth of a split, in steps
MAX_SPLITS = 65535  # gridDim.y's limit
MAX_TILES = 2**31 - 1  # gridDim.x's limit

# a, a_sr, a_sk, a_vec, a_pieces, b, b_sr, b_sk, b_vec, b_pieces, M, N, K, bn, k_split, splits, c, bias, mask,
# relu, round, partial, tickets, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int] * 2
             + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3)


class MMPlan(NamedTuple):
    bn: int  # a tile's columns
    col_tiles: int
    row_tiles: int
    splits: int  # splits of K (gridDim.y)
    k_split: int  # the depth of a split, a multiple of DEPTH
    smem: int  # a block's dynamic shared memory in bytes

    @property
    def tiles(self) -> int:
        return self.col_tiles * self.row_tiles


def operand_pieces(exact: bool) -> int:
    """The bfloat16 pieces an operand takes: 1 for bfloat16 values, 3
    (hi, mid, lo) for any other float32 values."""
    return 1 if exact else 3


def mm_plan(M: int, N: int, K: int, a_pieces: int = 1, b_pieces: int = 1) -> MMPlan:
    """The launch of ``C[M, N] = A[M, K] B[K, N]``: tiles of ROWS rows by
    ``bn`` columns (the narrowest of COLS that covers N, at most SPLIT_COLS
    with a split operand), and K in ``splits`` splits of ``k_split`` where
    the tiles leave the card idle (fewer than TARGET_BLOCKS) and K is deep
    (at least 2 MIN_SPLIT_STEPS steps): the wgrad, whose K is the batch."""
    if min(M, N, K) < 0 or a_pieces not in (1, 3) or b_pieces not in (1, 3):
        raise ValueError(f"no product plan for [{M}, {K}] x [{K}, {N}] with pieces {a_pieces}, {b_pieces}")
    widest = COLS[-1] if a_pieces == b_pieces == 1 else SPLIT_COLS
    bn = next((c for c in COLS if c >= N), COLS[-1])
    bn = min(bn, widest)
    col_tiles, row_tiles = -(-N // bn), -(-M // ROWS)
    steps = -(-K // DEPTH)
    splits = 1
    tiles = col_tiles * row_tiles
    if 0 < tiles < TARGET_BLOCKS and steps >= 2 * MIN_SPLIT_STEPS:
        splits = min(-(-TARGET_BLOCKS // tiles), steps // MIN_SPLIT_STEPS, MAX_SPLITS)
    split_steps = max(1, -(-steps // splits))
    splits = max(1, -(-steps // split_steps))
    if tiles > MAX_TILES:
        raise ValueError(f"[{M}, {N}] needs {tiles} tiles, past gridDim.x's {MAX_TILES}")
    smem = BUFS * (a_pieces * ROWS + b_pieces * bn) * DEPTH * 2
    return MMPlan(bn, col_tiles, row_tiles, splits, split_steps * DEPTH, smem)


def _operand(t: torch.Tensor, transposed: bool, what: str) -> Tuple[int, int]:
    """(row stride, depth stride) of the logical operand ``t.T`` if
    ``transposed`` else ``t``, as the kernel reads it: its rows are A's
    rows or B's columns; a stride of a dimension of size 1 never matters."""
    r_dim, k_dim = (1, 0) if transposed else (0, 1)
    sr, sk = t.stride(r_dim), t.stride(k_dim)
    if t.shape[k_dim] == 1:
        sk = 1
    if t.shape[r_dim] == 1:
        sr = 0
    if sk != 1 and sr != 1:
        raise ValueError(f"{what}: one dimension must be contiguous, got strides {t.stride()} for shape "
                         f"{tuple(t.shape)}")
    return sr, sk


def _check2d(t: torch.Tensor, what: str, device) -> None:
    if t.dim() != 2:
        raise ValueError(f"{what} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: expected torch.float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what}: expected device {device}, got {t.device}")


def _shape(a: torch.Tensor, a_t: bool, b: torch.Tensor, b_t: bool, bias: Optional[torch.Tensor],
           round_dtype: Optional[torch.dtype]) -> Tuple[int, int, int]:
    """(M, N, K) of a product the kernel can take, or raises: on either
    device, so that the plain versions keep the kernel's contract."""
    dev = a.device
    _check2d(a, "a", dev)
    _check2d(b, "b", dev)
    M, K = (a.shape[1], a.shape[0]) if a_t else a.shape
    Kb, N = (b.shape[1], b.shape[0]) if b_t else b.shape
    if K != Kb:
        raise ValueError(f"inner dimensions differ: [{M}, {K}] x [{Kb}, {N}]")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.device != dev or tuple(bias.shape) != (N,) or not bias.is_contiguous():
            raise ValueError(f"bias must be contiguous float32 [{N}] on {dev}")
    if round_dtype not in ROUND_KINDS:
        raise NotImplementedError(f"no round to {round_dtype}: bfloat16, float16 or None")
    return M, N, K


def mm_launch(name: str, a: torch.Tensor, a_t: bool, a_exact: bool, b: torch.Tensor, b_t: bool, b_exact: bool,
              bias: Optional[torch.Tensor] = None, relu: bool = False,
              round_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One K21 launch: ``C = A B`` for A = ``a.T`` if ``a_t`` else ``a`` and
    B likewise, with the layer's epilogue in the store → (C [M, N], the
    bool mask where ``relu``, else None). ``*_exact``: the operand's values
    are bfloat16. Counted in ``LAUNCHES[name]``."""
    M, N, K = _shape(a, a_t, b, b_t, bias, round_dtype)
    if not use_kernel(a):
        raise ValueError("mm_launch takes CUDA tensors; the plain versions serve the CPU")
    dev = a.device
    a_sr, a_sk = _operand(a, a_t, "a")
    b_sr, b_sk = _operand(b, not b_t, "b")  # B's rows are its columns n
    pa, pb = operand_pieces(a_exact), operand_pieces(b_exact)
    plan = mm_plan(M, N, K, pa, pb)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    mask = torch.empty((M, N), dtype=torch.bool, device=dev) if relu else None
    if M == 0 or N == 0:
        return out, mask
    stream = stream_ptr(dev)
    partial = torch.empty((plan.splits, M, N), dtype=torch.float32, device=dev) if plan.splits > 1 else None
    counters = tickets(dev, stream, plan.tiles) if plan.splits > 1 else None

    def vec(t, sr, sk, rows):
        return int(sk == 1 and t.data_ptr() % 16 == 0 and (rows == 1 or sr % 4 == 0))

    fn = library("mlp_mm").nvt_mlp_mm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(a), a_sr, a_sk, vec(a, a_sr, a_sk, M), pa, ptr(b), b_sr, b_sk, vec(b, b_sr, b_sk, N), pb,
            M, N, K, plan.bn, plan.k_split, plan.splits, ptr(out), ptr(bias), ptr(mask), int(relu),
            ROUND_KINDS[round_dtype], ptr(partial), ptr(counters), stream)
    raise_on_error(rc, name)
    LAUNCHES[name] += 1
    if bias is not None:
        LAUNCHES[name + "_epilogue"] += 1
    return out, mask


def _check_epilogue(b: Optional[torch.Tensor], relu: bool, round_dtype: Optional[torch.dtype]) -> None:
    if b is None and (relu or round_dtype is not None):
        raise ValueError("a product without a bias stores the product alone (no ReLU, no round)")


def mlp_mm_fwd(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], relu: bool,
               round_dtype: Optional[torch.dtype] = None, exact: bool = True,
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``round_c(relu(h @ w + b))`` (ReLU only where ``relu``; ``b`` None:
    ``h @ w`` alone) → (out [B, N], the bool mask of ``h @ w + b > 0`` or
    None). ``exact``: h's and w's values are bfloat16."""
    _check_epilogue(b, relu, round_dtype)
    if not use_kernel(h):
        _shape(h, False, w, False, b, round_dtype)
        return mlp_mm_fwd_plain(h, w, b, relu, round_dtype)
    return mm_launch("mlp_mm_fwd", h, False, exact, w, False, exact, b, relu, round_dtype)


def mlp_mm_dgrad(dz: torch.Tensor, w: torch.Tensor, dz_exact: bool = True, w_exact: bool = True) -> torch.Tensor:
    """``dz @ w.T``: a layer's input gradient."""
    if not use_kernel(dz):
        _shape(dz, False, w, True, None, None)
        return mlp_mm_dgrad_plain(dz, w)
    return mm_launch("mlp_mm_dgrad", dz, False, dz_exact, w, True, w_exact)[0]


def mlp_mm_wgrad(h: torch.Tensor, dz: torch.Tensor, h_exact: bool = True, dz_exact: bool = True) -> torch.Tensor:
    """``h.T @ dz``: a layer's weight gradient, the same bits from run to run."""
    if not use_kernel(h):
        _shape(h, True, dz, False, None, None)
        return mlp_mm_wgrad_plain(h, dz)
    return mm_launch("mlp_mm_wgrad", h, True, h_exact, dz, False, dz_exact)[0]


def mlp_mm_fwd_plain(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], relu: bool,
                     round_dtype: Optional[torch.dtype] = None, exact: bool = True,
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    _check_epilogue(b, relu, round_dtype)
    y = torch.matmul(h, w)
    mask = None if b is None else mlp_epilogue_fwd_plain(y, b, relu, round_dtype)
    return y, mask


def mlp_mm_dgrad_plain(dz: torch.Tensor, w: torch.Tensor, dz_exact: bool = True, w_exact: bool = True):
    return torch.matmul(dz, w.t())


def mlp_mm_wgrad_plain(h: torch.Tensor, dz: torch.Tensor, h_exact: bool = True, dz_exact: bool = True):
    return torch.matmul(h.t(), dz)


def split_pieces(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's three bfloat16 pieces of float32 values (csrc/mlp_mm.cu
    split3): hi = bf16(x) (rounded toward zero past bfloat16's largest
    finite value), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
    rounded to nearest even; a non-finite x is hi alone. hi + mid + lo == x
    for every finite |x| >= 2^-110, and within 2^-134 of x below."""
    x = x.float()
    finite = torch.isfinite(x)
    hi = x.to(torch.bfloat16)
    toward_zero = (x.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)
    hi = torch.where(torch.isinf(hi) & finite, toward_zero, hi)
    r = torch.where(finite, x - hi.float(), 0.0)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


class _Products(NamedTuple):
    """The products ``plain=True`` runs: the forward (with K19's plain
    epilogue), the input gradient and the weight gradient, each with its
    plain version's arguments."""
    fwd: object
    dgrad: object
    wgrad: object


_MATMUL = _Products(mlp_mm_fwd_plain, mlp_mm_dgrad_plain, mlp_mm_wgrad_plain)
_plain = _MATMUL


def _with_epilogue(product):
    def fwd(h, w, b, relu, round_dtype=None, exact=True):
        _check_epilogue(b, relu, round_dtype)
        y = product(h, w, exact)
        return y, None if b is None else mlp_epilogue_fwd_plain(y, b, relu, round_dtype)

    return fwd


def _order(kind: str) -> _Products:
    if kind == "k21":  # the kernel's sums, K19's plain epilogue after the product alone
        return _Products(_with_epilogue(lambda h, w, exact: mlp_mm_fwd(h, w, None, False, None, exact)[0]),
                             mlp_mm_dgrad, mlp_mm_wgrad)
    if kind == "float64":  # each sum in float64, rounded once
        return _Products(_with_epilogue(lambda h, w, exact: (h.double() @ w.double()).float()),
                             lambda dz, w, *_: (dz.double() @ w.double().t()).float(),
                             lambda h, dz, *_: (h.double().t() @ dz.double()).float())
    if kind == "reversed":  # torch.matmul over the depth in reverse: another float32 order
        return _Products(_with_epilogue(lambda h, w, exact: torch.matmul(h.flip(1), w.flip(0))),
                             lambda dz, w, *_: torch.matmul(dz.flip(1), w.flip(1).t()),
                             lambda h, dz, *_: torch.matmul(h.flip(0).t(), dz.flip(0)))
    if kind == "matmul":
        return _MATMUL
    raise ValueError(f"no plain products {kind!r}: matmul, k21, float64 or reversed")


@contextlib.contextmanager
def plain_products(kind: str):
    """While the block runs, the plain path (``plain=True``) takes its
    products as ``kind`` makes them: "matmul", the plain versions;
    "k21", the kernels (the product alone, then K19's plain epilogue; on a
    CPU tensor the wrappers run the plain versions); "float64", float64
    sums rounded once; "reversed", ``torch.matmul`` over the depth in
    reverse order. Every one sums the same exact products."""
    global _plain
    saved, _plain = _plain, _order(kind)
    try:
        yield
    finally:
        _plain = saved


class MLPProduct(torch.autograd.Function):
    """One layer: (h, w, b) → round_c(relu(h @ w + b)), or ``h @ w`` with
    ``b`` None. ``exact``: h's and w's values are bfloat16 (the compute
    dtype is bfloat16); the gradient dz is bfloat16 where the layer rounds
    to bfloat16. ``plain``: the plain path's products (``plain_products``)."""

    @staticmethod
    def forward(ctx, h, w, b, relu, round_dtype, exact, plain):
        ctx.products = _plain if plain else None
        out, mask = (ctx.products.fwd if plain else mlp_mm_fwd)(h, w, b, relu, round_dtype, exact)
        ctx.relu, ctx.round_dtype, ctx.exact, ctx.plain = relu, round_dtype, exact, plain
        ctx.has_bias = b is not None
        ctx.save_for_backward(h, w, mask)
        return out

    @staticmethod
    def backward(ctx, g):
        h, w, mask = ctx.saved_tensors
        if g.shape[1] > 1 and g.stride(1) != 1:  # an expanded gradient
            g = g.contiguous()
        db = None
        if ctx.has_bias:
            bwd = mlp_epilogue_bwd_plain if ctx.plain else mlp_epilogue_bwd
            dz, db = bwd(g, mask, ctx.relu, ctx.round_dtype)
        else:
            dz = g
        dz_exact = ctx.round_dtype == torch.bfloat16
        need = ctx.needs_input_grad
        dgrad, wgrad = (ctx.products.dgrad, ctx.products.wgrad) if ctx.plain else (mlp_mm_dgrad, mlp_mm_wgrad)
        dh = dgrad(dz, w, dz_exact, ctx.exact) if need[0] else None
        dw = wgrad(h, dz, ctx.exact, dz_exact) if need[1] else None
        return dh, dw, db if need[2] else None, None, None, None, None


def mlp_product(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], relu: bool = False,
                round_dtype: Optional[torch.dtype] = None, exact: bool = True, plain: bool = False) -> torch.Tensor:
    return MLPProduct.apply(h, w, b, relu, round_dtype, exact, plain)


__all__ = ["MLPProduct", "MMPlan", "mlp_mm_dgrad", "mlp_mm_dgrad_plain", "mlp_mm_fwd",
           "mlp_mm_fwd_plain", "mlp_mm_wgrad", "mlp_mm_wgrad_plain", "mlp_product", "mm_launch", "mm_plan",
           "operand_pieces", "plain_products", "split_pieces"]
