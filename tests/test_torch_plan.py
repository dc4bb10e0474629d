"""The launchers' shared-memory plans, mirrored in Python (``ops/ilu.py::
ilu_plan`` for the ILU sweep, ``ops/fused_gmres.py::plan_smem`` for the
fused GMRES kernel), against sizes worked out by hand. The kernels report
what they chose; ``tests/test_torch_kernels.py`` holds those reports to these
mirrors on the card."""

import pytest

from perphil_tpu_torch.ops.fused_gmres import INNER_STATE_DOUBLES, fused_gmres_plan, plan_smem, work_doubles
from perphil_tpu_torch.ops.ilu import IluPlan, ilu_plan, line_plan

ILU_PLANS = [
    # 2D field at N=64 (K8), narrow levels of 33 rows: level bounds 8 x 97,
    # 8 stages of 33 rows x 6 doubles plus their row indices (13,728), z
    # 8 x 4226; 48,312 bytes, rounded to 16
    ((4, 4, 4225, 193, 33, 205008), IluPlan(33, 6, 8, True, True, 48320)),
    # a 129^2 field (65 rows a level): the ring, 8 stages of 65 x 6 doubles
    # (27,040) beside the level bounds (1,032) and z (133,136)
    ((4, 4, 129 * 129, 257, 65, 231216), IluPlan(65, 6, 8, True, True, 161216)),
    # the 2D N=128 monolithic factor: the ring, z stays in device memory
    ((13, 13, 2 * 129 * 129, 389, 130, 231216), IluPlan(130, 15, 8, False, True, 130528)),
    # z (160 KB) does not fit beside two stages: the ring, 8 stages, without
    # z (26,168 bytes, rounded to 16)
    ((4, 4, 20000, 300, 60, 150000), IluPlan(60, 6, 8, False, True, 26176)),
    # 3D monolithic, 15 rows a level but 40 offsets a side: the ring, 8
    # stages of 15 x 42 doubles and their rows (40,800), bounds 152, z 2,008
    ((40, 40, 250, 37, 15, 200000), IluPlan(15, 42, 8, True, True, 42960)),
    # levels too wide for two stages: the direct loop
    ((40, 40, 1000, 10, 100, 10000), IluPlan(0, 42, 0, False, True, 48)),
]


@pytest.mark.parametrize(
    "args,plan", ILU_PLANS, ids=["narrow", "ring-z", "ring", "ring-no-room", "ring-40", "direct"]
)
def test_ilu_plan_by_hand(args, plan):
    assert ilu_plan(*args) == plan


def test_plan_smem_k6_quad64():
    """K6 at 2D N=64: slices 5 x 8 x 265, two line buffers of 4 x 63, then the
    input copy (67,600) that also holds p (33,800) or the one distinct
    eigenbasis (31,752), then the basis slice 31 x 8 x 530."""
    plan = plan_smem((65, 65), "fieldsplit_lu", 205664)
    assert (plan.input_smem, plan.p_smem, plan.s_smem, plan.basis_smem) == (True, True, True, True)
    assert (plan.pc_bytes, plan.bytes) == (67600, 67600 + 131440)
    # with two distinct eigenbases (63,504) the region still holds them
    assert plan_smem((65, 65), "fieldsplit_lu", 205664, distinct=(True, True)).s_smem


def test_plan_smem_k8_quad64():
    """K8 at 2D N=64: the line pipeline's 3 warps first (two edge lines of
    65 doubles for each of the first two warps, 2,080 bytes, and each warp's
    ring of 12 row stages of 32 lanes x 64 bytes, 73,728), then the input
    copy (67,600) with p beside it; the basis slice (131,440) does not fit.
    No ILU ring: z lives in no shared memory."""
    plan = plan_smem((65, 65), "fieldsplit_ilu", 204768)
    assert plan.ilu is None and plan.line_warps == 3
    assert (plan.input_smem, plan.p_smem, plan.s_smem, plan.basis_smem) == (True, True, False, False)
    assert plan.bytes == 2080 + 73728 + 67600


K8_PLANS = [
    # 17^2 (2 blocks): one warp, no edge line, a ring of 24,576; the slices
    # 5 x 8 x 145 (5,808 rounded) grow to hold p (8,128); the basis slice
    # 31 x 8 x 290
    ((17, 17), 1, None, (True, True, True), 24576 + 8128 + 71920),
    # 129^2: five warps (edge lines 2 x 4 x 129 x 8 = 8,256, rings 122,880),
    # the slices 5 x 8 x 1041 (41,648); neither the input copy (266,256) nor
    # p (174,784) nor the basis slice fits
    ((129, 129), 5, None, (False, False, False), 8256 + 122880 + 41648),
    # 9^3 (tet or hex nx=8, 4 blocks): 3D fields keep the ring, 8 stages of
    # 23 rows x 15 doubles and their rows (22,816), the level bounds (232)
    # and z (5,840), 28,896 rounded; the input copy (11,664) grows to hold
    # p (13,200); the basis slice 31 x 8 x 366
    ((9, 9, 9), 0, 28896, (True, True, True), 28896 + 13200 + 90768),
]


@pytest.mark.parametrize("shape,warps,ring,flags,total", K8_PLANS, ids=["17x17", "129x129", "9x9x9"])
def test_plan_smem_k8_by_hand(shape, warps, ring, flags, total):
    """K8's plan at the meshes it serves, as the gate (and the launcher)
    makes it, against sizes worked out by hand."""
    plan = fused_gmres_plan(shape, "fieldsplit_ilu")
    assert plan.line_warps == warps
    assert (plan.ilu is None) == (ring is None) and (ring is None or plan.ilu.bytes == ring)
    assert (plan.input_smem, plan.p_smem, plan.basis_smem) == flags and not plan.s_smem
    assert plan.bytes == total


def test_k8_takes_the_ring_where_the_pipeline_does_not_fit():
    """Where the pipeline's edge lines and rings leave the slices no room
    (2D N=192 / 256: 7 / 9 warps, 173 / 223 KB of rings), K8 sweeps on the
    ring, which shrinks to fit, so every mesh the gate placed stays placed;
    a tall field of short lines (41 nodes a line, 301 lines) too, and the
    transposed one keeps the pipeline."""
    for shape in ((193, 193), (257, 257), (301, 41)):
        plan = fused_gmres_plan(shape, "fieldsplit_ilu")
        assert plan.line_warps == 0 and plan.ilu is not None and line_plan(shape) is not None
    assert fused_gmres_plan((41, 301), "fieldsplit_ilu").line_warps == 2


LINE_PLANS = [  # node shape, slots a lane -> (warps, bytes) or None
    ((17, 17), 1, (1, 24576)),
    ((41, 41), 1, (2, 16 * 41 + 2 * 24576)),   # 41 lines: not a multiple of 32
    ((65, 65), 2, (2, 16 * 65 + 2 * 24576)),   # two lines a lane, 6 steps ahead
    ((129, 129), 5, (1, 2 * 5 * 32 * 64)),     # one warp, 2 steps ahead
    ((362, 362), 1, (12, 16 * 11 * 362 + 12 * 24576)),
    ((3, 3), 1, None),                          # narrower than 5 nodes: the ring
    ((17, 4), 1, None),                         # lines of 4 nodes
    ((9, 9, 9), 1, None),                       # 3D: the ring
    ((513, 5), 1, None),                        # 17 warps: more than a block's 16
]


@pytest.mark.parametrize("shape,slots,want", LINE_PLANS, ids=["x".join(map(str, c[0])) + f"-{c[1]}" for c in LINE_PLANS])
def test_line_plan_by_hand(shape, slots, want):
    """K8's line pipeline (``csrc/field_sweep.cuh::line_warps`` /
    ``line_bytes``): ceil(ny / 32 slots) warps, two edge lines of nx doubles
    for each warp but the last, and each warp's ring of 12 rows a lane (at
    least one step) of 64 bytes."""
    got = line_plan(shape, slots)
    assert (got is None and want is None) or tuple(got) == want


def test_plan_smem_small_and_tight():
    # pc none on 9 x 9 nodes: one block, the input (1,296) and the slice (40,176)
    plan = plan_smem((9, 9), "none", 200000)
    assert plan.ilu is None and (plan.pc_bytes, plan.bytes) == (1296, 1296 + 40176)
    # the fieldsplit roles need their slices and line buffers: 5 x 8 x 81 + 16 x 7 x 7,
    # rounded to 16 bytes
    assert plan_smem((9, 9), "fieldsplit_lu", 4032).pc_bytes == 4032
    with pytest.raises(ValueError):
        plan_smem((9, 9), "fieldsplit_lu", 4031)


def test_plan_smem_k6_tet8():
    """K6 at tet nx=8 on 4 blocks: slices 5 x 8 x 184 (7,360) and two line
    buffers of 13 x 7 (1,456): 8,816 bytes; beside them p (5,832, so the
    region grows past the input copy's 11,664 to 14,656 with rounding) and
    the eigenbasis (392); the basis slice is 31 x 8 x 366."""
    plan = plan_smem((9, 9, 9), "fieldsplit_lu", 200000)
    assert (plan.input_smem, plan.p_smem, plan.s_smem, plan.basis_smem) == (True, True, True, True)
    assert (plan.pc_bytes, plan.bytes) == (14656, 14656 + 90768)


def test_k8_literal_scratch_by_hand():
    """K8's literal inner GMRES keeps its state in device scratch behind the
    frame's 10 n: the basis, (restart + 1) n, and a block's Givens state (R
    32 x 32, g 33, cs and sn 32 each: 1,121 doubles, rounded up to 256-byte
    pieces) each block. The shared-memory plan is the PCG mode's, so every
    mesh K8 placed still places (the published 2D N=16..128)."""
    assert INNER_STATE_DOUBLES == 1152 >= 32 * 32 + 33 + 2 * 32
    assert work_doubles(4225, 16, 0) == 42250  # PCG: the frame's scratch
    assert work_doubles(4225, 16, 30) == 42250 + 31 * 4225 + 16 * 1152  # 2D N=64: 1.4 MB
    assert 8 * 31 * 129 * 129 == 4126968  # the 2D N=128 basis, 4.1 MB
    for n in (16, 64, 128):
        assert fused_gmres_plan((n + 1, n + 1), "fieldsplit_ilu") is not None
