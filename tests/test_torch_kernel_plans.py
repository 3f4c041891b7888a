"""The host-side launch plans of K13b's backward and of ``range_bag_grad``
(K15d's bag gradient, also K13c's backward), on the CPU.

Both CUDA kernels take their shapes of work from a plan the wrapper computes
in Python: the samples a group of K13b's backward and the columns a thread
(``interaction.bwd_plan``, ``bwd_columns``), and the lanes a bag, the grid
and the choice between private copies in shared memory and global atomics
for the bag gradient (``embedding_bag.bag_grad_plan``). The card cannot be
asked here, so these tests hold every planned launch within the shared
memory an H100 block can opt into and check where each plan changes path.
The kernels themselves are held against their plain versions in
test_torch_gpu.py.
"""

import pytest

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
    cols = kint.bwd_columns(D, aligned=True)
    G = kint.bwd_plan(F, D, cols, self_interaction)
    items = -(-F // kint.BWD_ROWS) * (D // cols)
    assert G >= 1 and D % cols == 0 and G * items <= kint.BWD_THREADS
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
    assert kint.bwd_columns(16, aligned=True) == 4
    assert kint.bwd_plan(27, 16, 4, False) == 16 and kint.bwd_plan(27, 16, 4, True) == 16
    assert kint.bwd_smem_bytes(27, 16, 4, 16, False) == 2 * 16 * (464 + 356) * 4 + 16 == 104_976
    assert kint.bwd_smem_bytes(27, 16, 4, 16, True) == 2 * 16 * (464 + 388) * 4 + 16 == 109_072
    assert 2 * (kint.bwd_smem_bytes(27, 16, 4, 16, True) + 1024) <= 228 * 1024


@pytest.mark.parametrize("self_interaction", [False, True], ids=["strict", "self"])
def test_interaction_bwd_plan_raises_when_one_sample_does_not_fit(self_interaction):
    """Two stages of one [120, 256] sample (30,720 floats of X and over 7,000
    gradient values) need over 300 KB, and a [33, 1024] sample would be 5 x
    256 items: the plan refuses both."""
    assert kint.bwd_smem_bytes(120, 256, 4, 1, self_interaction) > kint.SMEM_OPT_IN
    with pytest.raises(ValueError, match="shared memory"):
        kint.bwd_plan(120, 256, 4, self_interaction)
    with pytest.raises(ValueError, match="items"):
        kint.bwd_plan(33, 1024, 4, self_interaction)


@pytest.mark.parametrize("D,aligned,cols", [(16, True, 4), (64, True, 4), (12, True, 4), (16, False, 1), (5, True, 1),
                                            (3, True, 1)])
def test_interaction_bwd_columns(D, aligned, cols):
    """4 columns a thread (float4 reads) where D is a multiple of 4 and x is
    16-byte aligned, else the scalar path."""
    assert kint.bwd_columns(D, aligned) == cols


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
