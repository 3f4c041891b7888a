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

``mm_plan`` picks one of two paths by the shape alone. Where ``min(M, N,
K) <= NARROW_MAX`` (16: at DLRM's layers the bottom MLP's first layer's
forward and weight gradient and the three products of each MLP's last
layer; every N = 1 last layer) the narrow path sums float32 ``fmaf``
products of the operands as they are on the CUDA cores: the product is
exact inside ``fmaf`` and only the sum rounds. Every other product takes
the wide path, ``wgmma`` on the tensor cores in bfloat16 with float32
sums: an operand whose values are bfloat16 (``exact``: the rounded inputs
and weights, a hidden layer's rounded gradient) is converted exactly; any
other float32 operand is split into three bfloat16 pieces whose sum is the
value (``operand_pieces``). Either way every product is exact and only the
float32 sums round, in another order than ``torch.matmul``'s.

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

NARROW_MAX = 16  # the narrow path where min(M, N, K) <= NARROW_MAX, else the wide path
# The narrow path (csrc/mlp_mm.cu mm_narrow): tiles of C by the smallest dimension, a thread a TM x 4 block of
# them (the "n" tile 128 threads, the others 256)
NARROW_DEPTH = 16  # kNarrowDepth: a stage's depth
NARROW_TILES = {"k": (64, 128), "n": (128, 16), "n4": (256, 4), "m": (16, 256)}
# kNDepth: where N is the small side the stages stream A's rows 32 deep (more bytes in flight a stage)
NARROW_DEPTHS = {"k": NARROW_DEPTH, "n": 32, "n4": 32, "m": NARROW_DEPTH}
NARROW_TARGET_BLOCKS = 264  # blocks a split launch aims at: 2 on each of an H100's 132 SMs
NARROW_MIN_SPLIT_STEPS = 8  # the least depth of a split, in stages
# The wide path (mm_wide): a persistent grid of one block an SM, tiles by the operands' pieces
DEPTH = 64  # kStageDepth: a stage's depth, one 128-byte swizzle row of bfloat16
WIDE_TILES = {(1, 1): (128, 128), (3, 1): (64, 128), (1, 3): (128, 64), (3, 3): (64, 64)}
WIDE_COLS = 256  # the widest tile with bfloat16 operands, taken where N > 128
MIN_STAGES, MAX_STAGES = 4, 8  # kMinStages, kMaxStages: the ring of stages
EPI_BYTES = 2 * 64 * 68 * 4  # kEpiBytes: the consumers' staging of the accumulators for their store
BAR_BYTES = 2 * MAX_STAGES * 8 + 16  # kBarBytes: the full and empty barriers and the ticket flag
SMEM_LIMIT = 232_448  # kSmemLimit: an H100 block's shared memory after the opt-in
# units (a tile and a split) a split launch aims at: one wave of the persistent grid on an H100's 132 SMs (a
# constant, so that the splits, and so the bits, depend on the shape alone)
WAVE = 132
MIN_SPLIT_STEPS = 4  # the least depth of a wide split, in stages
SPLIT_GROUP = 16  # kSplitGroup: splits a group's ticket sums before the tile's ticket sums the groups
MAX_SPLITS = 65535  # kMaxSplits: the narrow path's gridDim.y
MAX_TILES = 2**31 - 1

# a, a_sr, a_sk, a_vec, a_pieces, b, b_sr, b_sk, b_vec, b_pieces, M, N, K, path, bm, bn, stages, k_split, splits,
# groups, c, bias, mask, relu, round, partial, tickets, packed, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int] * 2
             + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4)


class MMPlan(NamedTuple):
    path: str  # "narrow" (CUDA cores, fmaf) or "wide" (tensor cores)
    bm: int  # a tile's rows
    bn: int  # a tile's columns
    col_tiles: int
    row_tiles: int
    splits: int  # splits of K
    k_split: int  # the depth of a split, a multiple of the path's stage depth
    groups: int  # the splits' ticket groups: ceil(splits / SPLIT_GROUP)
    stages: int  # the wide path's ring (0 on the narrow path)
    smem: int  # a block's shared memory in bytes
    packed: int  # the wide path's scratch for B packed into its stages, in bytes (0 on the narrow path)

    @property
    def tiles(self) -> int:
        return self.col_tiles * self.row_tiles

    def terms(self, K: int, a_pieces: int, b_pieces: int) -> int:
        """The products a sum of C adds: K on the narrow path (the float32
        values as they are), K times both operands' pieces on the wide."""
        return K * (a_pieces * b_pieces if self.path == "wide" else 1)


def operand_pieces(exact: bool) -> int:
    """The bfloat16 pieces an operand takes on the wide path: 1 for
    bfloat16 values, 3 (hi, mid, lo) for any other float32 values."""
    return 1 if exact else 3


def narrow_tile(M: int, N: int, K: int) -> str:
    """The narrow path's tile (NARROW_TILES) by the smallest dimension."""
    if K <= min(M, N):
        return "k"
    if N <= M:
        return "n4" if N <= 4 else "n"
    return "m"


def _splits(tiles: int, steps: int, target: int, min_steps: int) -> Tuple[int, int]:
    """(splits, steps a split) of K where the tiles leave the card idle
    (fewer than ``target``) and K is deep (at least 2 ``min_steps``)."""
    splits = 1
    if 0 < tiles < target and steps >= 2 * min_steps:
        splits = min(max(1, target // tiles), steps // min_steps, MAX_SPLITS)
    split_steps = max(1, -(-steps // splits))
    return max(1, -(-steps // split_steps)), split_steps


def mm_plan(M: int, N: int, K: int, a_pieces: int = 1, b_pieces: int = 1) -> MMPlan:
    """The launch of ``C[M, N] = A[M, K] B[K, N]``, by the shape alone: the
    narrow path where ``min(M, N, K) <= NARROW_MAX`` (NARROW_TILES; K split
    for about NARROW_TARGET_BLOCKS blocks where the tiles are few and K deep:
    the wgrad, whose K is the batch), else the wide path (WIDE_TILES, 128 x
    256 where N > 128 with bfloat16 operands; as many stages as shared memory
    holds, at most MAX_STAGES; K split for about one WAVE of units; B packed
    into its stages once a launch, ``packed`` bytes of scratch, where K is
    not split or B takes three pieces)."""
    if min(M, N, K) < 0 or a_pieces not in (1, 3) or b_pieces not in (1, 3):
        raise ValueError(f"no product plan for [{M}, {K}] x [{K}, {N}] with pieces {a_pieces}, {b_pieces}")
    if min(M, N, K) <= NARROW_MAX:
        tile = narrow_tile(M, N, K)
        bm, bn = NARROW_TILES[tile]
        depth, stages = NARROW_DEPTHS[tile], 0
        # A's tile depth-major or, K-major, row-major: the larger of the two
        smem = 2 * max(depth * (bm + 4), bm * (depth + 4)) * 4 + 2 * depth * (bn + 4) * 4
    else:
        bm, bn = WIDE_TILES[(a_pieces, b_pieces)]
        if a_pieces == b_pieces == 1 and N > bn:
            bn = WIDE_COLS
        depth = DEPTH
        stage = (a_pieces * bm + b_pieces * bn) * DEPTH * 2
        stages = min(MAX_STAGES, (SMEM_LIMIT - EPI_BYTES - BAR_BYTES) // stage)
        smem = stages * stage + EPI_BYTES + BAR_BYTES
    col_tiles, row_tiles = -(-N // bn), -(-M // bm)
    tiles = col_tiles * row_tiles
    steps = -(-K // depth)
    if stages:
        splits, split_steps = _splits(tiles, steps, WAVE, MIN_SPLIT_STEPS)
    else:
        splits, split_steps = _splits(tiles, steps, NARROW_TARGET_BLOCKS, NARROW_MIN_SPLIT_STEPS)
    if tiles > MAX_TILES or tiles * splits > MAX_TILES:
        raise ValueError(f"[{M}, {N}] needs {tiles} tiles, past the grid's {MAX_TILES}")
    # B packed once a launch where it is read again for every row tile (a forward's or input gradient's weights)
    # or takes three pieces (DCN's split cross gradient); a weight gradient's bfloat16 dz streams through the
    # producers as A does
    pack = stages and (splits == 1 or b_pieces == 3)
    packed = col_tiles * max(1, steps) * b_pieces * bn * DEPTH * 2 if pack else 0
    return MMPlan("wide" if stages else "narrow", bm, bn, col_tiles, row_tiles, splits, split_steps * depth,
                  -(-splits // SPLIT_GROUP), stages, smem, packed)


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
    counters = tickets(dev, stream, plan.tiles * (plan.groups + 1)) if plan.splits > 1 else None
    packed = torch.empty(plan.packed, dtype=torch.uint8, device=dev) if plan.packed else None

    def vec(t, sr, sk, rows):  # 16-byte loads along the contiguous dimension
        if t.data_ptr() % 16:
            return 0
        return int(rows <= 1 or sr % 4 == 0) if sk == 1 else int(K <= 1 or sk % 4 == 0)

    fn = library("mlp_mm").nvt_mlp_mm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    rc = fn(ptr(a), a_sr, a_sk, vec(a, a_sr, a_sk, M), pa, ptr(b), b_sr, b_sk, vec(b, b_sr, b_sk, N), pb,
            M, N, K, int(plan.path == "wide"), plan.bm, plan.bn, plan.stages, plan.k_split, plan.splits,
            plan.groups, ptr(out), ptr(bias), ptr(mask), int(relu), ROUND_KINDS[round_dtype], ptr(partial),
            ptr(counters), ptr(packed), stream)
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
    split3x2): hi = bf16(x) (rounded toward zero past bfloat16's largest
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
