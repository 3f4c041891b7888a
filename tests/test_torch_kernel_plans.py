"""The host-side launch plans of K13b's forward and backward, of K13d's
kernels and of ``range_bag_grad`` (K15d's bag gradient, also K13c's
backward), on the CPU.

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

from nvtabular_tpu_torch.kernels import cin as kcin
from nvtabular_tpu_torch.kernels import embedding_bag as kbag
from nvtabular_tpu_torch.kernels import interaction as kint

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
    """Only where one stage of one sample passes the opt-in limit: [120,
    1024] (122,880 floats of X). [33, 1024] (5 x 256 items) and [120, 256]
    (two stages over 300 KB) now plan one sample a group, one stage, its
    items several a thread."""
    assert kint.bwd_smem_bytes(120, 1024, 4, 1, self_interaction, stages=1) > kint.SMEM_OPT_IN
    with pytest.raises(ValueError, match="shared memory"):
        kint.bwd_plan(120, 1024, 4, self_interaction)
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


def test_interaction_fwd_plan_raises_only_where_one_sample_does_not_fit():
    """[120, 1024]: one stage of one sample passes the opt-in limit; [33,
    1024] takes one stage of one sample."""
    with pytest.raises(ValueError, match="ROADMAP.md queue 3"):
        kint.fwd_plan(120, 1024, False)
    assert kint.fwd_plan(33, 1024, False)[0::2] == (1, 1)


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
