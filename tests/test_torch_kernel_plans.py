"""The host-side launch plans of K13b's forward and backward, of K13d's
kernels, of ``range_bag_grad`` (K15d's bag gradient, also K13c's
backward) and the range bag's forward (``bag_fwd_plan``), of K11c's merge-path tiles, K3's fastmod, K1's key bound,
K14's element widths, and K21's tiles and splits of K (``mlp_mm.mm_plan``), on the CPU.

Both CUDA kernels take their shapes of work from a plan the wrapper computes
in Python: the samples a group of K13b's backward and the columns a thread
(``interaction.bwd_plan``, ``columns``), and the lanes a bag, the grid
and the choice between private copies in shared memory and global atomics
for the bag gradient (``embedding_bag.bag_grad_plan``). The card cannot be
asked here, so these tests hold every planned launch within the shared
memory an H100 block can opt into and check where each plan changes path.
The kernels themselves are held against their plain versions in
test_torch_gpu.py.
"""

import pytest

from nvtabular_tpu_torch.kernels import bucketize as kbkt
from nvtabular_tpu_torch.kernels import cin as kcin
from nvtabular_tpu_torch.kernels import cross as kcross
from nvtabular_tpu_torch.kernels import embedding as kemb
from nvtabular_tpu_torch.kernels import embedding_bag as kbag
from nvtabular_tpu_torch.kernels import interaction as kint
from nvtabular_tpu_torch.kernels import lookup as klk
from nvtabular_tpu_torch.kernels import permute as kperm
from nvtabular_tpu_torch.kernels import ragged as kragged

# (F, D): DLRM's Criteo step, the multihot DLRM's, the GPU tests' shapes
INTERACTION_SHAPES = [(27, 16), (4, 64), (5, 8), (2, 3), (28, 12), (26, 20), (33, 24), (9, 5), (2, 1)]


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
@pytest.mark.parametrize("F,D", INTERACTION_SHAPES)
def test_interaction_bwd_plan_fits_the_opt_in_shared_memory(F, D, self_interaction):
    """Two stages of G samples fit SMEM_OPT_IN; the G samples' work items
    (BWD_ROWS rows and ``cols`` columns each) are at most one a thread, and
    as many as fit; the columns a thread divide D."""
    cols = kint.columns(D, aligned=True)
    G, stages = kint.bwd_plan(F, D, cols, self_interaction)
    items = -(-F // kint.BWD_ROWS) * (D // cols)
    assert G >= 1 and stages == 2 and D % cols == 0 and G * items <= kint.BWD_THREADS
    assert kint.bwd_smem_bytes(F, D, cols, G, self_interaction) <= kint.SMEM_OPT_IN
    assert (G + 1) * items > kint.BWD_THREADS or kint.bwd_smem_bytes(F, D, cols, G + 1, self_interaction) > \
        kint.SMEM_OPT_IN


def test_interaction_bwd_plan_at_the_dlrm_step():
    """DLRM's [65536, 27, 16]: 4 columns and 4 row blocks of 8 a sample, 16
    samples a group (the block's 256 threads one item each). A stage's
    slots hold a sample's X rows in 464 floats (116 16-byte units: the 4
    column chunks mod 8) and its 351 (self mode: 378) gradient values in 356
    (388): 104,976 B for two stages and the two barriers, 109,072 in the
    self mode, so two blocks fit an SM."""
    assert kint.columns(16, aligned=True) == 4
    assert kint.bwd_plan(27, 16, 4, False) == (16, 2) and kint.bwd_plan(27, 16, 4, True) == (16, 2)
    assert kint.bwd_smem_bytes(27, 16, 4, 16, False) == 2 * 16 * (464 + 356) * 4 + 16 == 104_976
    assert kint.bwd_smem_bytes(27, 16, 4, 16, True) == 2 * 16 * (464 + 388) * 4 + 16 == 109_072
    assert 2 * (kint.bwd_smem_bytes(27, 16, 4, 16, True) + 1024) <= 228 * 1024


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
def test_interaction_bwd_plan_raises_when_one_sample_does_not_fit(self_interaction):
    """Where one stage of one sample passes the opt-in limit, [120, 1024]
    (122,880 floats of X), the plan is the streamed kernel's, (1, STREAMED),
    and no longer raises. [33, 1024] (5 x 256 items) and [120, 256] (two
    stages over 300 KB) still plan one sample a group, one stage, its items
    several a thread."""
    assert kint.bwd_smem_bytes(120, 1024, 4, 1, self_interaction, stages=1) > kint.SMEM_OPT_IN
    assert kint.bwd_plan(120, 1024, 4, self_interaction) == (1, kint.STREAMED) == (1, 0)
    assert kint.bwd_plan(120, 1024, 1, self_interaction) == (1, kint.STREAMED)
    for F, D in ((33, 1024), (120, 256)):
        assert kint.bwd_plan(F, D, 4, self_interaction) == (1, 1)
        assert kint.bwd_smem_bytes(F, D, 4, 1, self_interaction, stages=1) <= kint.SMEM_OPT_IN
    assert kint.bwd_items(33, 1024, 4) > kint.BWD_THREADS


@pytest.mark.parametrize("D,aligned,cols", [(16, True, 4), (64, True, 4), (12, True, 4), (16, False, 1), (5, True, 1),
                                            (3, True, 1)])
def test_interaction_bwd_columns(D, aligned, cols):
    """4 columns a thread (float4 reads) where D is a multiple of 4 and x is
    16-byte aligned, else the scalar path."""
    assert kint.columns(D, aligned) == cols


def _bag_smem(S, rows, D):
    return kbag.BAG_GRAD_THREADS // S * rows * D * 4


# (B, D, rows_local, vec): phase 23's shard, K13c's tables at phases 10 and 22, the GPU tests' shards
BAG_SHAPES = [(65_536, 64, 6, 4), (65_536, 16, 23, 4), (65_536, 64, 24, 4), (65_536, 5, 6, 1), (4099, 64, 28, 4),
              (4099, 64, 29, 4), (65_536, 16, 28, 4), (65_536, 16, 10_000, 4), (3, 16, 2, 4), (65_536, 16, 23, 1),
              (100, 200, 1, 4)]


@pytest.mark.parametrize("B,D,rows,vec", BAG_SHAPES)
def test_bag_grad_plan_fits_and_fills(B, D, rows, vec):
    """The shared path's copies fit SMEM_OPT_IN; S is the least power of two
    >= D / vec, at most 32; the grid is at least one block, at most one a
    group of bags and four 512-thread blocks an SM. The global path is taken
    only where the copies would not fit."""
    S, blocks = kbag.bag_grad_plan(B, D, rows, vec)
    chunks = D // vec
    want_S = 1
    while want_S < min(chunks, 32):
        want_S *= 2
    if S == 0:
        assert blocks == 0 and _bag_smem(want_S, rows, D) > kbag.SMEM_OPT_IN
        return
    assert S == want_S and _bag_smem(S, rows, D) <= kbag.SMEM_OPT_IN
    groups = kbag.BAG_GRAD_THREADS // S
    assert 1 <= blocks <= min(kbag.H100_SMS * 4, -(-B // groups))


@pytest.mark.parametrize("D", [64, 16])
def test_bag_grad_plan_takes_global_atomics_past_28_rows(D):
    """A block's private copies hold a shard of 28 rows of 64 floats (32
    copies) or of 16 floats (128 copies) within the opt-in limit; one row
    more takes the global atomics."""
    assert kbag.bag_grad_plan(65_536, D, 28, 4)[0] > 0
    assert kbag.bag_grad_plan(65_536, D, 29, 4) == (0, 0)


def test_bag_grad_plan_at_the_phase_shapes():
    """Phase 23's genres shard [6, 64]: 16 lanes a bag, 32 copies of 1.5 KB,
    four blocks an SM (528); K13c's [23, 16]: 4 lanes a bag, 128 copies of
    1,472 B (188 KB), one block an SM (132)."""
    assert kbag.bag_grad_plan(65_536, 64, 6, 4) == (16, 528)
    assert kbag.bag_grad_plan(65_536, 16, 23, 4) == (4, 132)
    assert kbag.bag_grad_plan(65_536, 16, 23, 4, sms=114) == (4, 114)


# (L, D, rows_local, vec): phase 23's genres shard, K15b's shard at phases 18-19, no ids, the GPU tests' edges
BAG_FWD_SHAPES = [(4, 64, 6, 4), (26, 16, 5_585_751, 4), (0, 64, 6, 4), (1, 16, 256, 4), (3, 5, 819, 1),
                  (3, 5, 820, 1), (4, 1, 4096, 1), (26, 64, 65, 4), (2048, 16, 6, 4), (2049, 16, 6, 4),
                  (4, 2048, 1, 4), (40, 40, 100, 1)]


def test_bag_fwd_constants_match_the_source():
    """BAG_TILE_IDS, BAG_STAGE_FLOATS and BAG_THREADS, which the range
    bag's plan repeats, are csrc/sharded_embedding.cu's kBagTileIds,
    kBagStageFloats (the C entry refuses tiles past them) and kThreads."""
    import re
    from pathlib import Path

    src = (Path(kbag.__file__).parent.parent / "csrc" / "sharded_embedding.cu").read_text()
    assert int(re.search(r"constexpr int kBagTileIds = (\d+);", src).group(1)) == kbag.BAG_TILE_IDS
    assert int(re.search(r"constexpr int kBagStageFloats = (\d+);", src).group(1)) == kbag.BAG_STAGE_FLOATS
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == kbag.BAG_THREADS


@pytest.mark.parametrize("L,D,rows,vec", BAG_FWD_SHAPES)
def test_bag_fwd_plan_fits_a_tile(L, D, rows, vec):
    """Tiles only where the shard's rows x D floats fit BAG_STAGE_FLOATS and
    a bag's ids BAG_TILE_IDS; a tile's bags x ids fit BAG_TILE_IDS, and are
    a whole number of the block's passes where one fits (every thread sums
    as many bags), the most such up to BAG_TILE_SUMS sums of ``vec``
    floats."""
    bags = kbag.bag_fwd_plan(L, D, rows, vec)
    if rows * D > kbag.BAG_STAGE_FLOATS or L > kbag.BAG_TILE_IDS:
        assert bags == 0
        return
    assert bags >= 1 and bags * L <= kbag.BAG_TILE_IDS
    per_row = D // vec
    most = min(-(-kbag.BAG_TILE_SUMS // per_row), kbag.BAG_TILE_IDS // L if L else 2**31)
    a_pass = kbag.BAG_THREADS // per_row
    if a_pass and most >= a_pass:
        assert bags % a_pass == 0 and most - a_pass < bags <= most
    else:
        assert bags == max(most, 1)


def test_bag_fwd_plan_at_the_phase_shapes():
    """Phase 23's [65536, 4] against the genres shard [6, 64]: tiles of 64
    bags (1,024 float4 sums, 4 a thread), the shard's 1.5 KB staged; K15b's
    [65536, 26] against shard 1 of 4 ([5585751, 16]): a thread a vector."""
    assert kbag.bag_fwd_plan(4, 64, 6, 4) == 64
    assert kbag.bag_fwd_plan(26, 16, 5_585_751, 4) == 0


@pytest.mark.parametrize("D", [64, 16, 5, 1])
def test_bag_fwd_stage_limit_at_its_edge(D):
    """Tiles stage the shard up to BAG_STAGE_FLOATS (16 KB) and no further;
    bags up to BAG_TILE_IDS ids."""
    rows = kbag.BAG_STAGE_FLOATS // D
    vec = 4 if D % 4 == 0 else 1
    assert kbag.bag_fwd_plan(4, D, rows, vec) and not kbag.bag_fwd_plan(4, D, rows + 1, vec)
    assert kbag.bag_fwd_plan(kbag.BAG_TILE_IDS, D, 1, vec) and not kbag.bag_fwd_plan(kbag.BAG_TILE_IDS + 1, D, 1, vec)


def _bag_walk(B, L, D, vec):
    """The sums range_bag_kernel's threads take (csrc/sharded_embedding.cu,
    modelled loop for loop): for each tile of the plan's bags, thread k
    takes vectors q0 + j qstep of bags r0 + i rstep. Returns how often each
    (bag, vector) sum is taken."""
    import numpy as np

    bags = kbag.bag_fwd_plan(L, D, 1, vec)
    per_row = D // vec
    seen = np.zeros((B, per_row), dtype=np.int64)
    for b0 in range(0, B, bags):
        n = min(bags, B - b0)
        for k in range(kbag.BAG_THREADS):
            if per_row <= kbag.BAG_THREADS:
                rstep, r0 = kbag.BAG_THREADS // per_row, k // per_row
                q0, qstep = k - r0 * per_row, per_row
                if r0 >= rstep:
                    continue
            else:
                r0, rstep, q0, qstep = 0, 1, k, kbag.BAG_THREADS
            for r in range(r0, n, rstep):
                for q in range(q0, per_row, qstep):
                    seen[b0 + r, q] += 1
    return seen


@pytest.mark.parametrize("B,L,D,vec", [(200, 4, 64, 4), (130, 26, 16, 4), (70, 0, 64, 4), (9, 3, 5, 1),
                                       (1100, 4, 1, 1), (3, 2048, 16, 4), (5, 4, 2048, 4), (7, 2, 2052, 4),
                                       (90, 40, 40, 1)])
def test_bag_fwd_walk_takes_every_sum_once(B, L, D, vec):
    """Under the plan, range_bag_kernel's walk (tiles, each thread's bags
    and vectors) takes every (bag, vector) sum exactly once, B no multiple
    of a tile's bags included."""
    assert (_bag_walk(B, L, D, vec) == 1).all()


# K13b's shapes that the reference computes and that one-item-a-thread or 48 KB plans refused
NAMED_SHAPES = [(27, 65), (27, 66), (40, 130), (27, 300), (65, 128), (27, 455)]


def _fwd_plan_holds(F, D, self_interaction):
    G, threads, stages = kint.fwd_plan(F, D, self_interaction)
    assert 1 <= G <= 256 and 32 <= threads <= kint.FWD_MAX_THREADS and threads % 32 == 0 and threads % G == 0
    assert kint.fwd_smem_bytes(F, D, G, self_interaction, stages) <= kint.SMEM_OPT_IN
    return G, threads, stages


def _bwd_plan_holds(F, D, cols, self_interaction):
    G, stages = kint.bwd_plan(F, D, cols, self_interaction)
    assert G >= 1 and D % cols == 0
    assert G == 1 or G * kint.bwd_items(F, D, cols) <= kint.BWD_THREADS
    assert kint.bwd_smem_bytes(F, D, cols, G, self_interaction, stages) <= kint.SMEM_OPT_IN
    return G, stages


@pytest.mark.parametrize("aligned", [False, True], ids=["cols1", "cols4"])
@pytest.mark.parametrize("D", [1, 3, 4, 16, 64, 65, 66, 128, 130, 300, 455])
@pytest.mark.parametrize("F", [2, 5, 27, 40, 65])
def test_interaction_bwd_plan_accepts_every_shape_the_forward_plans(F, D, aligned):
    """Both modes: where the forward's plan fits, the backward's does, at
    its column count (4 only where D is a multiple of 4 and x aligned)."""
    cols = kint.columns(D, aligned)
    assert cols == (4 if aligned and D % 4 == 0 else 1)
    for self_interaction in (False, True):
        _fwd_plan_holds(F, D, self_interaction)
        _bwd_plan_holds(F, D, cols, self_interaction)


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
@pytest.mark.parametrize("F,D", NAMED_SHAPES, ids=[f"{f}-{d}" for f, d in NAMED_SHAPES])
def test_interaction_named_shapes_plan_a_block(F, D, self_interaction):
    """The shapes the old limits refused ([27, 455]: the forward's 48 KB
    static launch; the rest: the backward's one item a thread) plan both
    directions; a sample's items past the block's threads take one sample
    a group."""
    _fwd_plan_holds(F, D, self_interaction)
    for cols in {1, kint.columns(D, True)}:
        G, _ = _bwd_plan_holds(F, D, cols, self_interaction)
        if kint.bwd_items(F, D, cols) > kint.BWD_THREADS:
            assert G == 1


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
def test_interaction_fwd_plan_at_the_main_path_shapes(self_interaction):
    """DLRM's [27, 16]: 28 tiles of 4 x 4 rows, 16 samples a group, 256
    threads (two tiles a thread), two stages within a two-blocks-an-SM share
    (101,392 B; 105,488 in the self mode), 16 warps an SM. Phase 22's [4,
    64]: one tile, 32 samples a group in one warp, one stage: two would
    leave an SM 3 warps, one leaves it 6."""
    assert kint.fwd_tiles(27) == 28
    assert kint.fwd_plan(27, 16, self_interaction) == (16, 256, 2)
    smem = kint.fwd_smem_bytes(27, 16, 16, self_interaction)
    assert smem == (105_488 if self_interaction else 101_392) and smem <= kint.SMEM_TWO_BLOCKS
    assert kint.resident_warps(256, smem) == 16
    assert kint.fwd_plan(4, 64, self_interaction) == (32, 32, 1)
    assert kint.fwd_smem_bytes(4, 64, 32, self_interaction) <= kint.SMEM_TWO_BLOCKS
    assert kint.resident_warps(32, kint.fwd_smem_bytes(4, 64, 32, self_interaction)) == 3
    assert kint.resident_warps(32, kint.fwd_smem_bytes(4, 64, 32, self_interaction, stages=1)) == 6


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
@pytest.mark.parametrize("F,D", INTERACTION_SHAPES + NAMED_SHAPES)
def test_interaction_fwd_plan_takes_one_stage_where_two_leave_few_warps(F, D, self_interaction):
    """Two stages exactly where they fit SMEM_OPT_IN and leave an SM
    FWD_MIN_WARPS warps; one stage never leaves fewer warps than two."""
    G, threads, stages = kint.fwd_plan(F, D, self_interaction)
    two = kint.fwd_smem_bytes(F, D, G, self_interaction, stages=2)
    one = kint.fwd_smem_bytes(F, D, G, self_interaction, stages=1)
    want = 2 if two <= kint.SMEM_OPT_IN and kint.resident_warps(threads, two) >= kint.FWD_MIN_WARPS else 1
    assert stages == want
    assert kint.resident_warps(threads, one) >= kint.resident_warps(threads, two)


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
def test_interaction_streamed_plans_at_phase_23(self_interaction):
    """[120, 1024]: one stage of one sample passes the opt-in limit, so both
    directions plan the streamed kernels. The forward: (1, SF_THREADS,
    STREAMED), one item a sample (its 120-row triangle: 120 tiles), a stage
    of 120 rows x 32 columns, three stages in 46,080 B (four blocks an SM).
    The backward: tiles of 64 rows x 256 columns, a row block's weights
    staged once (2 items a sample: g read once, X twice):
    8 chunks of weights (34,816 B) beside three stages of x_j (49,152 B), two
    blocks an SM. [33, 1024] takes one stage of one sample."""
    assert kint.fwd_smem_bytes(120, 1024, 1, self_interaction, 1) > kint.SMEM_OPT_IN
    assert kint.fwd_plan(120, 1024, self_interaction) == (1, kint.SF_THREADS, kint.STREAMED) == (1, 128, 0)
    assert kint.stream_fwd_plan(120) == (120, 3, 1)
    assert kint.stream_fwd_smem_bytes(120) == 46_080
    assert 4 * (46_080 + kint.SMEM_RESERVED) <= kint.SMEM_SM
    assert kint.bwd_plan(120, 1024, 4, self_interaction) == (1, kint.STREAMED)
    assert (kint.SB_ROWS, kint.SB_COLS) == (64, 256) and kint.stream_bwd_plan(120, 1024) == (3, 1, 2)
    assert kint.stream_bwd_smem_bytes(120, 1024) == 34_816 + 49_152 <= kint.SMEM_TWO_BLOCKS
    assert kint.fwd_plan(33, 1024, self_interaction)[0::2] == (1, 1)


@pytest.mark.parametrize("F", [1, 2, 57, 120, 121, 241, 1000, 46_342, 60_000])
def test_interaction_stream_fwd_items_tile_the_triangle(F):
    """The streamed forward's items (row block I of 120 rows: its diagonal
    triangle, then ceil(120 I / 64) strips of 64 columns, the last cut at
    the block's first row) hold every pair once in both modes, each strip
    below its row block, each item at most 120 tiles of 8 x 8 pairs for the
    block's 128 threads."""
    items, pairs = 0, {False: 0, True: 0}
    for I in range(-(-F // kint.SF_ROWS)):
        row0 = I * kint.SF_ROWS
        nrow = min(kint.SF_ROWS, F - row0)
        tiles = -(-nrow // kint.SF_TILE)
        assert tiles * (tiles + 1) // 2 <= kint.SF_ROWS <= kint.SF_THREADS
        items += 1
        for self_interaction in pairs:
            pairs[self_interaction] += kint.num_pairs(nrow, self_interaction)
        for col0 in range(0, row0, kint.SF_STRIP):
            ncol = min(kint.SF_STRIP, row0 - col0)
            assert tiles * -(-ncol // kint.SF_TILE) <= kint.SF_ROWS
            items += 1
            for self_interaction in pairs:
                pairs[self_interaction] += nrow * ncol
    assert items == kint.stream_fwd_items(F) == kint.stream_fwd_plan(F)[2]
    assert pairs == {False: kint.num_pairs(F, False), True: kint.num_pairs(F, True)}


STREAM_SHAPES = [(1, 58_200), (2, 29_100), (57, 1021), (121, 481), (1000, 60), (60_000, 1), (5000, 33), (300, 32),
                 (240, 257), (241, 257), (32, 1024), (33, 1024)]


@pytest.mark.parametrize("F,D", STREAM_SHAPES, ids=[f"{f}-{d}" for f, d in STREAM_SHAPES])
def test_interaction_stream_plans_fit_any_sample(F, D):
    """Both streamed plans stay within the opt-in limit at any F (no column
    of all F rows has to fit: the forward stages at most 184 rows a chunk);
    the forward's stage is 8 ceil(F / 8) rows where F <= 120, else 184; the
    backward stages a row block's weights once exactly where it spans
    several column blocks, has 3 chunks or more and fits two blocks an SM
    (F <= 240), and its 64 x 256 tiles cover dX."""
    rows, stages, items = kint.stream_fwd_plan(F)
    assert rows == (8 * -(-F // 8) if F <= 120 else 184) and stages == kint.STREAM_STAGES
    assert items == kint.stream_fwd_items(F) and kint.stream_fwd_smem_bytes(F) <= kint.SMEM_OPT_IN
    stages, once, items = kint.stream_bwd_plan(F, D)
    assert stages == kint.STREAM_STAGES and once == (D > 256 and 33 <= F <= 240)
    assert items == -(-F // 64) * (1 if once else -(-D // 256))
    assert kint.stream_bwd_smem_bytes(F, D) <= (kint.SMEM_TWO_BLOCKS if once else kint.SMEM_OPT_IN)


@pytest.mark.parametrize("total", [52, 226, 437, 438, 742, 926])
def test_cin_plans_chunk_x_k_where_it_does_not_fit(total):
    """K13d at F = 26 and Hk = total - 26 (xDeepFM's layers at 52 and 226):
    the forward stages all Hk + F rows of its 64 columns where they fit the
    opt-in limit beside the w and z buffers, else x_k in chunks beside all
    of x_0; the backward's plans do not depend on Hk (x_k a pass's ipp rows
    at a time)."""
    F, Hk = 26, total - 26
    for Hn in (200, 8):
        rows, ci, cj = kcin.fwd_plan(Hk, F, Hn)
        assert rows == kcin.pass_rows(Hn) and kcin.fwd_smem_bytes(rows, ci, cj) <= kcin.SMEM_OPT_IN
        whole = kcin.fwd_smem_bytes(rows, Hk, F) <= kcin.SMEM_OPT_IN
        assert (ci, cj) == (Hk, F) if whole else (cj == F and 16 <= ci < Hk)
    assert kcin.fwd_plan(Hk, F, 200)[1] == (Hk if total <= 742 else 744)
    jr, xk_rows, smem = kcin.bwd_x_plan(F)
    assert (jr, xk_rows) == (26, 11) and 2 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("ws", [2, 4], ids=["w16", "w32"])
@pytest.mark.parametrize("total", [52, 226, 926, 1726, 1826, 3026])
def test_cin16_plans_stage_half_the_bytes(total, ws):
    """K13d in 16 bits: x_k's and x_0's rows staged in 2 bytes an element
    (w's tiles in ``ws``), so the forward stages all rows up to about twice
    as many of them as float32 does (1,724 rows of 64 columns beside
    float32 w tiles; with 16-bit w the tensor-core kernel's rows of 128
    columns, 512 of them) and chunks x_k past that; the backward's x rows
    and g tiles take half their bytes, its plan's rows unchanged."""
    F, Hk = 26, total - 26
    for Hn in (200, 16):
        rows, ci, cj = kcin.fwd_plan(Hk, F, Hn, 2, ws)
        assert rows == kcin.pass_rows(Hn) and kcin.fwd_smem_bytes(rows, ci, cj, 2, ws) <= kcin.SMEM_OPT_IN
        whole = kcin.fwd_smem_bytes(rows, Hk, F, 2, ws) <= kcin.SMEM_OPT_IN
        assert (ci, cj) == (Hk, F) if whole else (cj == F and 16 <= ci < Hk)
    assert (kcin.fwd_plan(Hk, F, 16, 2, ws)[1] == Hk) == (total <= (1724 if ws == 4 else 512))
    jr, xk_rows, smem = kcin.bwd_x_plan(F, 2)
    assert (jr, xk_rows) == kcin.bwd_x_plan(F)[:2]
    assert kcin.bwd_x_plan(F)[2] - smem == (2 * kcin.BX_DEPTH * kcin.BX_COLS + (jr + xk_rows) * kcin.BX_COLS) * 2


@pytest.mark.parametrize("F", [1, 8, 9, 26, 128, 129, 256, 257, 900])
def test_cin_bwd_x_plan_fits_any_field_count(F):
    """x_0 in ceil(F / 128) chunks of near-equal rows; a pass's 256 pairs
    span at most xk_rows rows of x_k in the narrowest chunk; always within
    the opt-in limit."""
    jr, xk_rows, smem = kcin.bwd_x_plan(F)
    n = -(-F // jr)
    narrowest = F - (n - 1) * jr
    assert jr <= kcin.BX_CHUNK and n == -(-F // kcin.BX_CHUNK) and 1 <= narrowest <= jr
    for p0 in range(0, 3 * kcin.BX_ROWS, 7):  # the rows of x_k a pass spans
        assert (p0 + kcin.BX_ROWS - 1) // narrowest - p0 // narrowest + 1 <= xk_rows
    assert smem <= kcin.SMEM_OPT_IN


# K13d's 16-bit shapes (Hk, F, Hn) in tests/test_torch_gpu.py (the cin16 tests and the tensor-core edges) and
# xDeepFM's layers 1-2 ([65536, 26, 16]^2 and [8192, 200, 16] x [8192, 26, 16], 200 maps)
CIN16_GPU_SHAPES = [(26, 26, 200), (200, 26, 200), (7, 5, 9), (3, 2, 1), (5, 1, 257), (30, 17, 36), (900, 26, 8),
                    (1800, 26, 16), (6, 5, 24), (3, 7, 1), (5, 26, 9), (26, 26, 16), (4, 13, 17), (7, 26, 200),
                    (3, 5, 257)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("Hk,F,Hn", CIN16_GPU_SHAPES, ids=[f"{hk}_{f}_{hn}" for hk, f, hn in CIN16_GPU_SHAPES])
def test_cin16_tensor_core_plans_fit(Hk, F, Hn, dtype):
    """The tensor-core kernels' plans (x and w in T) within the opt-in
    limit at every GPU test shape and xDeepFM's layers: the forward's 128
    columns of all rows or of x_k's chunks beside x_0, cin_bwd_x's chunks
    of x_0 whose passes' x_k rows it stages, and cin_bwd_w's ring (any w
    dtype: its products are 16-bit whatever w is)."""
    es = 2  # both types' bytes an element
    rows, ci, cj = kcin.fwd_plan(Hk, F, Hn, es, es)
    assert rows == kcin.pass_rows(Hn) and 1 <= ci <= Hk and cj == F
    assert kcin.fwd_smem_bytes(rows, ci, cj, es, es) <= kcin.SMEM_OPT_IN
    assert (ci == Hk) == (kcin.fwd_smem_bytes(rows, Hk, F, es, es) <= kcin.SMEM_OPT_IN)
    jr, xk_rows, smem = kcin.bwd_x_plan(F, es, es)
    narrowest = F - (F - 1) // jr * jr
    assert 1 <= jr <= min(F, kcin.BX_CHUNK) and xk_rows == -(-(kcin.BX_ROWS - 1) // narrowest) + 1
    assert smem <= kcin.SMEM_OPT_IN and smem > kcin.bwd_x_plan(F, es)[2]  # 128 columns a block, not 64
    assert kcin.bwd_w_smem_bytes(Hk, F) <= kcin.SMEM_OPT_IN


@pytest.mark.parametrize("F", [1, 26, 127, 128, 129, 1000, 25_601])
def test_cin16_bwd_x_plan_lowers_jr_until_it_fits(F):
    """cin_bwd_x on the tensor cores holds x_0's chunk and x_k's rows a
    pass spans in 128 columns: jr stays ceil(F / n) where that fits, and
    is lowered where the narrowest chunk's rows would pass 227 KB (at F =
    25,601 the 128-row chunks leave one row, whose passes span 256 rows of
    x_k); every pass's rows within xk_rows."""
    jr, xk_rows, smem = kcin.bwd_x_plan(F, 2, 2)
    n = -(-F // kcin.BX_CHUNK)
    assert smem <= kcin.SMEM_OPT_IN and (jr == -(-F // n)) == (F != 25_601)
    narrowest = F - (F - 1) // jr * jr
    for p0 in range(0, 3 * kcin.BX_ROWS, 7):
        assert (p0 + kcin.BX_ROWS - 1) // narrowest - p0 // narrowest + 1 <= xk_rows


# --- K14's launch groups and element widths, K12b's bound chunks, K17's row ranges, K13a / K13c row chunks ---
@pytest.mark.parametrize("row_bytes,addresses,elem", [
    (4, (0, 256), 4), (52, (16, 64), 4), (1, (0, 0), 1), (2, (0, 0), 2), (6, (0, 0), 2), (5, (0, 0), 1),
    (8, (2, 0), 2), (8, (0, 1), 1), (16, (4, 12), 4), (16, (0, 512), 4), (16, (8, 0), 4), (32, (16, 48), 4),
    (24, (0, 16), 4), (8, (8, 0), 4), (48, (0, 4), 4),
])
def test_permute_element_bytes(row_bytes, addresses, elem):
    """K14 copies each array in the widest of 4, 2 or 1 bytes that divides
    its row width and both its addresses: int8 codes byte by byte, int16
    and float16 in 2 bytes, a 4-byte-aligned row of 4-byte multiples in
    words, the multihot feed's [n, 4] int32 rows and int64 columns too."""
    assert kperm.element_bytes(row_bytes, *addresses) == elem


def test_permute_max_arrays_matches_the_source():
    """MAX_ARRAYS, the arrays of one launch in the wrapper's count, is
    csrc/permute.cu's kMaxArrays."""
    import re
    from pathlib import Path

    src = (Path(kperm.__file__).parent.parent / "csrc" / "permute.cu").read_text()
    assert int(re.search(r"constexpr int kMaxArrays = (\d+);", src).group(1)) == kperm.MAX_ARRAYS


@pytest.mark.parametrize("num_arrays,n,widest,launches", [
    (28, 262_144, 13, 1), (64, 1000, 1, 1), (65, 1000, 1, 2), (70, 10_007, 13, 2), (129, 5, 1, 3),
    (1, 1_051_000, 2_045, 2), (70, 2**31, 1, 4), (1, 2**31 - 1, 1, 1), (3, 0, 4, 0),
])
def test_permute_launch_groups(num_arrays, n, widest, launches):
    """One launch a chunk of MAX_ARRAYS arrays and of ``launch_rows`` rows
    (the plan ``nvt_permute_rows`` takes and checks), whose widest row's
    elements times the rows stay within int32."""
    rows = kperm.launch_rows(n, [widest])
    assert rows >= 1 and (n == 0 or rows * widest <= kperm.MAX_INDEX)
    assert rows == min(n, kperm.MAX_INDEX // widest) or n == 0
    assert kperm.MAX_ARRAYS == 64 and -(-num_arrays // 64) * -(-n // rows) == launches


@pytest.mark.parametrize("nb,chunk,chunks", [(0, 0, 1), (5, 5, 1), (4096, 4096, 1), (4097, 4096, 2), (5000, 4096, 2),
                                           (8192, 4096, 2), (8193, 4096, 3)])
def test_bucketize_bound_chunks(nb, chunk, chunks):
    """K12b's blocks stage ``bound_chunk`` bounds at once (the dynamic
    shared memory ``nvt_bucketize`` takes and checks), all of them up to
    4,096, and sum each chunk's count in one launch."""
    got = kbkt.bound_chunk(nb)
    assert kbkt.BOUNDS_CHUNK == 4096 and got == chunk
    assert (1 if nb <= got else -(-nb // got)) == chunks


@pytest.mark.parametrize("B,blocks,ranges", [(0, 1, 1), (65_536, 256, 1), (65_535 * 256, 65_535, 1),
                                             (65_535 * 256 + 1, 65_535, 2), (65_535 * 512, 65_535, 2),
                                             (65_535 * 512 + 1, 65_535, 3)])
def test_cross_row_ranges_past_grid_y(B, blocks, ranges):
    """K17's blocks of 256 rows: ``row_blocks`` in y (the gridDim.y that
    ``nvt_cross_fwd`` / ``_bwd`` take and check), at most 65,535, the ranges
    past them walked by the same blocks."""
    got = kcross.row_blocks(B)
    assert kcross.MAX_ROW_BLOCKS == 65_535 and got == blocks
    assert max(1, -(-(-(-B // 256)) // got)) == ranges  # the ranges the busiest block walks


@pytest.mark.parametrize("B,C,D,vec,launches", [
    (65_536, 26, 16, 4, 1), (262_144, 64, 128, 4, 1), (264_209, 64, 127, 1, 2), (2053, 70, 8, 4, 2),
    (1_048_577, 64, 128, 4, 2), (0, 26, 16, 4, 0),
])
def test_embedding_launch_count(B, C, D, vec, launches):
    """K13a: a launch for each 64 columns and, in it, each chunk of
    ``launch_rows`` rows (the plan ``nvt_embedding_gather`` /
    ``_scatter_grad`` take and check), whose vectors stay within int32
    ([262144, 64, 128] in float4 needs one; in floats, [264209, 64, 127],
    two)."""
    rows = kemb.launch_rows(B, C, D, vec)
    per_row = min(C, 64) * (D // vec)
    assert rows >= 1 and rows * per_row <= 2**31 - 1 and (rows == B or (rows + 1) * per_row > 2**31 - 1 or B == 0)
    assert kemb.LAUNCH_COLUMNS == 64 and -(-C // 64) * -(-B // rows) == launches


@pytest.mark.parametrize("B,D,vec,launches", [(65_536, 16, 4, 1), (2_100_000, 1023, 1, 2), (2**31, 4, 4, 2),
                                              (0, 16, 4, 0)])
def test_embedding_bag_fwd_launches(B, D, vec, launches):
    """K13c's forward: a launch for each chunk of ``fwd_rows`` rows (the plan
    ``nvt_embedding_bag_fwd`` takes and checks), whose vectors stay within
    int32."""
    rows = kbag.fwd_rows(B, D, vec)
    assert rows >= 1 and rows * (D // vec) <= 2**31 - 1 and (rows == B or (rows + 1) * (D // vec) > 2**31 - 1 or B == 0)
    assert -(-B // rows) == launches


# (T, R, num_rows, tiles): phase 26's lists, empty inputs, rows dropped or added
SEGMENT_PLANS = [
    (12_372_651, 146_994, 146_994, 3_261),
    (0, 0, 3, 0),
    (0, 3, 3, 1),
    (3_840 - 5, 5, 5, 1),
    (3_840 - 5, 5, 6, 1),
    (3_840 - 4, 5, 5, 2),
    (5, 0, 1, 1),
    (100, 50, 10, 1),
    (3_000_000, 5_000, 5_001, 783),
]


@pytest.mark.parametrize("T,R,num_rows,tiles", SEGMENT_PLANS)
def test_segment_reduce_plan(T, R, num_rows, tiles):
    """K11c's merge path holds the T values and the row ends of rows [0,
    min(num_rows, R)) in tiles of SEG_TILE = 256 threads x 15 items (odd, so
    that a warp's neighbouring runs of values start in other banks); the
    scratch holds the tiles + 1 boundaries' row counts and each tile's two
    4-byte carries."""
    assert kragged.SEG_TILE == 3_840 and kragged.SEG_ITEMS % 2 == 1
    assert kragged.segment_plan(T, R, num_rows) == (tiles, 2 * tiles + 1)
    assert (tiles - 1) * kragged.SEG_TILE < min(num_rows, R) + T <= tiles * kragged.SEG_TILE


def test_segment_reduce_constants_match_the_source():
    """SEG_THREADS and SEG_ITEMS are csrc/ragged.cu's kSegThreads and kSegItems."""
    import re
    from pathlib import Path

    src = (Path(kragged.__file__).parent.parent / "csrc" / "ragged.cu").read_text()
    assert int(re.search(r"kSegThreads = (\d+);", src).group(1)) == kragged.SEG_THREADS
    assert int(re.search(r"kSegItems = (\d+);", src).group(1)) == kragged.SEG_ITEMS


@pytest.mark.parametrize("d", [1, 2, 3, 7, 1000, 2**31 + 11, 2**32 - 1, 262_147, 4_002_446 // 3 + 1])
def test_cuckoo_fastmod_equals_the_remainder(d):
    """K3's bucket index takes fastmod(a, m, d) for a % d: exact for every
    32-bit a at each bucket count (edges, multiples of d, their neighbours,
    and random words)."""
    import numpy as np

    m = klk.fastmod_multiplier(d)
    rng = np.random.default_rng(d % 1_000_003)
    edges = [0, 1, 2, d - 1, d, d + 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    multiples = [q * d + r for q in rng.integers(0, 2**32 // d, 200).tolist() for r in (-1, 0, 1)]
    words = rng.integers(0, 2**32, 20_000, dtype=np.uint64).tolist()
    for a in [a for a in edges + multiples + words if 0 <= a < 2**32]:
        assert klk.fastmod(a, m, d) == a % d, (a, d)


# --- K1's bound on a column's keys -----------------------------------------------------------------------------
def test_tiny_max_matches_the_source():
    """TINY_MAX, the most keys the wrapper lets a tiny column hold, is
    csrc/lookup.cu's kTinyMax, which sizes the kernel's staging."""
    import re
    from pathlib import Path

    src = (Path(klk.__file__).parent.parent / "csrc" / "lookup.cu").read_text()
    assert int(re.search(r"constexpr int kTinyMax = (\d+);", src).group(1)) == klk.TINY_MAX


@pytest.mark.parametrize("lengths", [(1,), (2,), (5, 1), (2209,), (4096, 3, 1), (155, 1543, 2209)])
def test_tiny_library_yardstick_finds_the_same_slots(lengths):
    """chip_smoke.py times ``torch.searchsorted`` over ``tiny_padded_rows``
    (each value row's keys, INT32_MAX past its length) as K1's library call:
    the same search, positions only. Where tiny_lookup_plain finds a value,
    the yardstick's position holds its code; where it does not, the
    position holds another key or lies past the row's keys."""
    import numpy as np
    import torch

    import chip_smoke
    from nvtabular_tpu_torch.ops import lookup as plookup

    rng = np.random.default_rng(sum(lengths))
    keysets = [rng.permutation(np.unique(rng.integers(-(2**31), 2**31 - 1, 2 * v)))[:v].astype(np.int32)
               for v in lengths]
    t = plookup.BatchedTiny([plookup.TinyLookup(k, np.arange(len(k)) + 3) for k in keysets])
    sel = torch.tensor([c % len(lengths) for c in range(len(lengths) + 1)], dtype=torch.int32)
    n = 5000
    values = torch.from_numpy(np.stack([np.where(rng.random(n) < 0.5, rng.choice(keysets[s], n),
                                                 rng.integers(-(2**31), 2**31 - 1, n)).astype(np.int32)
                                        for s in sel.tolist()]))
    codes = klk.tiny_lookup_plain(values, None, t.keys, t.codes, t.lens, sel, torch.zeros(len(sel), dtype=torch.int32))
    rows = chip_smoke.tiny_padded_rows(t, sel)
    pos = torch.searchsorted(rows, values)
    hit = codes >= 3
    assert bool(hit.any()) and bool((~hit).any())
    at = torch.gather(rows, 1, pos.clamp(max=rows.shape[1] - 1))
    assert torch.equal(torch.gather(t.codes[sel.long()], 1, pos.clamp(max=rows.shape[1] - 1))[hit], codes[hit])
    past = pos >= t.lens[sel.long()][:, None]
    assert bool((past | (at != values))[~hit].all())


# --- K21: the MLP and cross-layer products ---------------------------------------------------------------------
from nvtabular_tpu_torch.kernels import mlp_mm as kmm  # noqa: E402

SMEM_OPT_IN = 232_448  # an H100 block's shared memory after the opt-in
# (M, K, N, a_pieces, b_pieces) -> (path, bm, bn, col_tiles, row_tiles, splits, k_split): phase 7's forwards, input
# and weight gradients (the last layer's dz float32: 3 pieces on the wide path, read as it is on the narrow),
# DCN's cross layer, and the edges
MM_PLANS = {
    (65536, 13, 512, 1, 1): ("narrow", 64, 128, 4, 1024, 1, 16),  # DLRM bottom.0 forward: K = 13
    (65536, 256, 16, 1, 1): ("narrow", 128, 16, 1, 512, 1, 256),  # bottom.2 forward: N = 16
    (65536, 256, 1, 1, 1): ("narrow", 256, 4, 1, 256, 1, 256),  # top.2 forward: N = 1
    (65536, 16, 256, 3, 1): ("narrow", 64, 128, 2, 1024, 1, 16),  # bottom.2 dgrad: K = 16, dz float32
    (65536, 1, 256, 3, 1): ("narrow", 64, 128, 2, 1024, 1, 16),  # top.2 dgrad: K = 1
    (13, 65536, 512, 1, 1): ("narrow", 16, 256, 2, 1, 128, 512),  # bottom.0 wgrad: M = 13, K = the batch, split
    (256, 65536, 16, 1, 3): ("narrow", 128, 16, 1, 2, 128, 512),  # bottom.2 wgrad
    (256, 65536, 1, 1, 3): ("narrow", 256, 4, 1, 1, 256, 256),  # top.2 wgrad
    (65536, 512, 256, 1, 1): ("wide", 128, 256, 1, 512, 1, 512),  # bottom.1 / top.1 forward
    (65536, 256, 512, 1, 1): ("wide", 128, 256, 2, 512, 1, 256),  # bottom.1 / top.1 dgrad
    (65536, 367, 512, 1, 1): ("wide", 128, 256, 2, 512, 1, 384),  # top.0 forward
    (65536, 512, 367, 1, 1): ("wide", 128, 256, 2, 512, 1, 512),  # top.0 dgrad
    (512, 65536, 256, 1, 1): ("wide", 128, 256, 1, 4, 32, 2048),  # bottom.1 / top.1 wgrad: K = the batch, split
    (367, 65536, 512, 1, 1): ("wide", 128, 256, 2, 3, 22, 3008),  # top.0 wgrad
    (65536, 429, 429, 1, 1): ("wide", 128, 256, 2, 512, 1, 448),  # DCN cross forward
    (65536, 429, 429, 3, 1): ("wide", 64, 128, 4, 1024, 1, 448),  # cross dgrad: x0 * g split
    (429, 65536, 429, 1, 3): ("wide", 128, 64, 7, 4, 4, 16384),  # cross wgrad
    (65536, 429, 429, 3, 3): ("wide", 64, 64, 7, 1024, 1, 448),  # float32 compute: both split
    (65536, 256, 128, 1, 1): ("wide", 128, 128, 1, 512, 1, 256),  # DCN deep.1 forward: N = 128
    (100, 13, 1, 1, 1): ("narrow", 256, 4, 1, 1, 1, 32),
    (3, 0, 5, 1, 1): ("narrow", 64, 128, 1, 1, 1, 16),  # K = 0: no step, the sums +0.0
    (0, 7, 9, 1, 1): ("narrow", 16, 256, 1, 0, 1, 16),
    (1000, 1000, 9, 1, 1): ("narrow", 128, 16, 1, 8, 4, 256),
    (17, 17, 17, 1, 1): ("wide", 128, 128, 1, 1, 1, 64),  # just past NARROW_MAX
}


@pytest.mark.parametrize("shape", list(MM_PLANS), ids=["x".join(map(str, s)) for s in MM_PLANS])
def test_mm_plan(shape):
    """The narrow path where min(M, N, K) <= NARROW_MAX, its tile by the
    smallest dimension; else the wide path, 128 x 256 tiles for bfloat16
    operands where N > 128, the split operand's side 64; K split only where
    the tiles leave the card idle and K is deep, each split a multiple of the
    path's stage depth and none empty; every plan within the opt-in shared
    memory, the wide path's ring at least MIN_STAGES deep, its B packed once
    a launch where K is not split or B takes three pieces."""
    M, K, N, pa, pb = shape
    plan = kmm.mm_plan(M, N, K, pa, pb)
    assert (plan.path, plan.bm, plan.bn, plan.col_tiles, plan.row_tiles, plan.splits, plan.k_split) == MM_PLANS[shape]
    assert plan.path == ("narrow" if min(M, N, K) <= kmm.NARROW_MAX else "wide")
    depth = kmm.NARROW_DEPTHS[kmm.narrow_tile(M, N, K)] if plan.path == "narrow" else kmm.DEPTH
    assert plan.k_split % depth == 0 and plan.k_split >= depth
    assert (plan.splits - 1) * plan.k_split < max(K, 1) <= plan.splits * plan.k_split or K == 0
    assert plan.col_tiles * plan.bn >= N and plan.row_tiles * plan.bm >= M
    assert plan.groups == -(-plan.splits // kmm.SPLIT_GROUP)
    if plan.path == "wide":
        assert (plan.bm, plan.bn) in (kmm.WIDE_TILES[(pa, pb)], (128, kmm.WIDE_COLS))
        assert kmm.MIN_STAGES <= plan.stages <= kmm.MAX_STAGES
        stage = (pa * plan.bm + pb * plan.bn) * kmm.DEPTH * 2
        assert plan.smem == plan.stages * stage + kmm.EPI_BYTES + kmm.BAR_BYTES <= SMEM_OPT_IN
        assert plan.smem + stage > SMEM_OPT_IN or plan.stages == kmm.MAX_STAGES  # as deep as memory allows
        # B packed into its stages once a launch where K is not split (the weights) or B is split (DCN's x0 * g)
        pack = plan.splits == 1 or pb == 3
        stages_b = plan.col_tiles * max(1, -(-K // kmm.DEPTH))
        assert plan.packed == (stages_b * pb * plan.bn * kmm.DEPTH * 2 if pack else 0)
    else:
        assert (plan.bm, plan.bn) == kmm.NARROW_TILES[kmm.narrow_tile(M, N, K)] and plan.stages == plan.packed == 0
        a_floats = max(depth * (plan.bm + 4), plan.bm * (depth + 4))  # A's tile depth-major or row-major
        assert plan.smem == 2 * a_floats * 4 + 2 * depth * (plan.bn + 4) * 4 <= SMEM_OPT_IN
    if plan.splits > 1:
        target = kmm.WAVE if plan.path == "wide" else kmm.NARROW_TARGET_BLOCKS
        min_steps = kmm.MIN_SPLIT_STEPS if plan.path == "wide" else kmm.NARROW_MIN_SPLIT_STEPS
        assert plan.tiles < target and plan.splits <= max(1, target // plan.tiles)
        assert plan.k_split >= min_steps * depth


# The layers of every main path (M, K, N of the forward [M, K] x [K, N]): DLRM's six (phase 7), the multihot
# DLRM's bottom (one dense feature) and its 512-256 MLPs, DCN's cross layer and its deep and out MLPs, DeepFM's
# MLP, the tabular MLP's 1041-512-256-1
MAIN_LAYERS = {
    "dlrm.b0": (65536, 13, 512), "dlrm.b1": (65536, 512, 256), "dlrm.b2": (65536, 256, 16),
    "dlrm.t0": (65536, 367, 512), "dlrm.t1": (65536, 512, 256), "dlrm.t2": (65536, 256, 1),
    "multihot.b0": (65536, 1, 512), "multihot.b2": (65536, 256, 64),
    "dcn.cross": (65536, 429, 429), "dcn.deep0": (65536, 429, 256), "dcn.deep1": (65536, 256, 128),
    "dcn.out": (65536, 557, 1), "deepfm.mlp0": (65536, 416, 400), "deepfm.out": (65536, 400, 1),
    "tabular.0": (65536, 1041, 512), "tabular.1": (65536, 512, 256), "tabular.2": (65536, 256, 1),
}
# The products of DLRM's layers on the narrow path: eight of seventeen (the bottom MLP's first layer has no dgrad)
DLRM_NARROW = {("dlrm.b0", "fwd"), ("dlrm.b0", "wgrad"), ("dlrm.b2", "fwd"), ("dlrm.b2", "dgrad"),
               ("dlrm.b2", "wgrad"), ("dlrm.t2", "fwd"), ("dlrm.t2", "dgrad"), ("dlrm.t2", "wgrad")}


@pytest.mark.parametrize("layer", list(MAIN_LAYERS))
@pytest.mark.parametrize("mode", ["fwd", "dgrad", "wgrad"])
def test_mm_plan_routes_the_main_paths(layer, mode):
    """Every main path's layer, in each mode, on the path its shape names:
    the narrow path exactly where one of M, N and K is at most NARROW_MAX
    (at DLRM's layers the eight products of DLRM_NARROW), with the last
    layer's float32 dz split only where the wide path takes it."""
    M, K, N = MAIN_LAYERS[layer]
    dz_pieces = 3 if layer.endswith(("2", "out", "cross")) else 1
    shape = {"fwd": (M, N, K, 1, 1), "dgrad": (M, K, N, dz_pieces, 1), "wgrad": (K, N, M, 1, dz_pieces)}[mode]
    plan = kmm.mm_plan(*shape)
    want = "narrow" if min(shape[:3]) <= kmm.NARROW_MAX else "wide"
    assert plan.path == want
    if layer.startswith("dlrm.") and (layer, mode) != ("dlrm.b0", "dgrad"):  # not launched: its input is data
        assert (plan.path == "narrow") == ((layer, mode) in DLRM_NARROW)
    if layer in ("dlrm.b2", "dlrm.t2", "tabular.2", "deepfm.out", "dcn.out"):
        assert plan.path == "narrow" and plan.terms(shape[2], *shape[3:]) == shape[2]
    if layer == "dcn.cross" and mode != "fwd":
        assert plan.terms(shape[2], *shape[3:]) == 3 * shape[2]


@pytest.mark.parametrize("N", range(1, 200, 7))
@pytest.mark.parametrize("pieces", [(1, 1), (1, 3), (3, 1), (3, 3)])
def test_mm_plan_widths(N, pieces):
    """Every shape plans on exactly one path, its tile from that path's
    table, across the narrow-wide edge on each dimension."""
    for M, K in [(1000, 64), (1, 64), (13, 64), (16, 64), (17, 64), (65, 64), (64, 0), (64, 1), (64, 15), (64, 16),
                 (64, 17), (64, 100)]:
        plan = kmm.mm_plan(M, N, K, *pieces)
        if min(M, N, K) <= kmm.NARROW_MAX:
            assert plan.path == "narrow" and (plan.bm, plan.bn) in kmm.NARROW_TILES.values()
        else:
            assert plan.path == "wide" and (plan.bm, plan.bn) in (kmm.WIDE_TILES[pieces], (128, kmm.WIDE_COLS))
            assert plan.bn == kmm.WIDE_COLS or pieces != (1, 1) or N <= 128


def test_mm_plan_depends_on_the_shape_alone():
    """The splits, and so the wgrad's bits, are a function of the shape:
    the same plan on every call and for every card."""
    assert kmm.mm_plan(512, 256, 65536) == kmm.mm_plan(512, 256, 65536)
    assert kmm.mm_plan(13, 512, 65536) == kmm.mm_plan(13, 512, 65536)
    with pytest.raises(ValueError):
        kmm.mm_plan(5, 5, 5, 2, 1)
    with pytest.raises(ValueError):
        kmm.mm_plan(-1, 5, 5)


@pytest.mark.parametrize("transposed", [False, True])
def test_mm_operand_strides(transposed):
    """An operand's (row, depth) strides as the kernel reads them: a row
    stride of a strided view kept, a size-1 dimension's stride ignored, no
    contiguous dimension refused."""
    import torch

    t = torch.zeros(8, 1044)[:, :1041]
    want = (1, 1044) if transposed else (1044, 1)
    assert kmm._operand(t, transposed, "a") == want
    col = torch.zeros(8, 1)
    assert kmm._operand(col, transposed, "a") == ((0, 1) if transposed else (1, 1))
    row = torch.zeros(1, 8)
    assert kmm._operand(row, transposed, "a") == ((1, 1) if transposed else (0, 1))
    with pytest.raises(ValueError):
        kmm._operand(torch.zeros(8, 8)[::2, ::2], transposed, "a")


def test_mm_constants_match_the_source():
    import re
    from pathlib import Path

    src = (Path(kmm.__file__).parent.parent / "csrc" / "mlp_mm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kStageDepth"), const("kNarrowDepth"), const("kMinStages"), const("kMaxStages"),
            const("kMaxSplits"), const("kSplitGroup"), const("kSmemLimit")) == (
        kmm.DEPTH, kmm.NARROW_DEPTH, kmm.MIN_STAGES, kmm.MAX_STAGES, kmm.MAX_SPLITS, kmm.SPLIT_GROUP, kmm.SMEM_LIMIT)
    assert const("kNDepth") == kmm.NARROW_DEPTHS["n"]
    assert kmm.NARROW_DEPTHS == {"k": kmm.NARROW_DEPTH, "n": 32, "n4": 32, "m": kmm.NARROW_DEPTH}
    assert 2 * 64 * const("kEpiStride") * 4 == kmm.EPI_BYTES
    assert 2 * kmm.MAX_STAGES * 8 + 16 == kmm.BAR_BYTES
    # setmaxnreg moves registers within the block's launch allocation: 65536 / threads a thread, a multiple of 8
    for producers in (1, 2):
        threads = 256 + 128 * producers
        assert 128 * producers * const(f"kProducerRegs{producers}") + 256 * const(f"kConsumerRegs{producers}") <= (
            threads * (65536 // threads // 8 * 8))
    # the tiles the C entry launches are the plan's
    for (pa, pb), (bm, bn) in kmm.WIDE_TILES.items():
        assert f"pa == {pa} && pb == {pb} && bm == {bm} && bn == {bn}" in src
    assert "pa == 1 && pb == 1 && bm == 128 && bn == 256" in src
    for bm, bn in kmm.NARROW_TILES.values():
        assert f"bm == {bm} && bn == {bn}" in src
