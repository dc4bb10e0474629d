"""The launchers' shared-memory plans, mirrored in Python (``ops/ilu.py::
ilu_plan`` for the ILU sweep, ``ops/fused_gmres.py::plan_smem`` for the
fused GMRES kernel), against sizes worked out by hand. The kernels report
what they chose; ``tests/test_torch_kernels.py`` holds those reports to these
mirrors on the card."""

import pytest

from perphil_tpu_torch.ops.fused_gmres import INNER_STATE_DOUBLES, fused_gmres_plan, plan_smem, work_doubles
from perphil_tpu_torch.ops.ilu import IluPlan, ilu_plan

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
    """K8 at 2D N=64: the ILU ring's 48,320 bytes first (8 stages, z in
    shared memory), then the input copy, with p beside it; the basis slice
    (131,440) no longer fits."""
    plan = plan_smem((65, 65), "fieldsplit_ilu", 204768, ilu_shape=(4, 4, 193, 33))
    assert (plan.ilu.stages, plan.ilu.z_smem, plan.ilu.bytes) == (8, True, 48320)
    assert (plan.input_smem, plan.p_smem, plan.s_smem, plan.basis_smem) == (True, True, False, False)
    assert plan.bytes == 48320 + 67600


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
