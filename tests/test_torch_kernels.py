"""The port's CUDA kernels K1-K8 and ``structured_ilu_apply`` against their
plain PyTorch twins, on the
card. A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one; run them on the card with
``python -m pytest tests/test_torch_kernels.py -q``."""

import numpy as np
import pytest
import torch

from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator, FieldOperator, dpp_stencils
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply, fused_dpp_apply_plain
from perphil_tpu_torch.ops.fused_direct import fused_direct_solve, fused_simplicial_direct_solve
from perphil_tpu_torch.ops.fused_gmres import K4, K5, FusedGMRESSolver, launch_geometry, plan_smem
from perphil_tpu_torch.ops.ilu import StructuredILU0, ilu_plan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _state(element, cells, device, seed=0):
    shape = tuple(c + 1 for c in reversed(cells))
    rng = np.random.default_rng(seed)
    g1, g2 = (rng.standard_normal(shape) for _ in range(2))
    return from_numpy_state({"k1": 1.2, "beta": 0.9}, cells, element, g1, g2, device=device)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


K1_CASES = [
    ("quad", (13, 9), torch.float64, 1e-13), ("hex", (7, 6, 5), torch.float64, 1e-13),
    ("triangle", (13, 9), torch.float32, 2e-6), ("tet", (7, 6, 5), torch.float32, 2e-6),
    ("quad", (1, 1), torch.float64, 0.0),  # no interior: every row is a boundary row
]


@pytest.mark.parametrize(
    "element,cells,dtype,tol", K1_CASES, ids=[f"{c[0]}{len(c[1])}d-{c[1][0]}" for c in K1_CASES]
)
@pytest.mark.parametrize("mode", ["matvec", "lift"])
def test_k1_matches_twin(cuda, element, cells, dtype, tol, mode):
    state = _state(element, cells, cuda)
    S = dpp_stencils(state.mesh, state.params)
    z1, z2 = (g.to(dtype) for g in state.grids)
    before = _cuda.KERNEL_LAUNCHES["fused_dpp_apply"]
    out = fused_dpp_apply(z1, z2, *S, mode=mode)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES["fused_dpp_apply"] == before + 1
    for a, b in zip(out, fused_dpp_apply_plain(z1, z2, *S, mode=mode)):
        assert a.dtype == dtype and a.device == cuda
        assert _rel(a, b) <= tol


def test_k1_rejects_bad_inputs(cuda):
    state = _state("quad", (4, 4), cuda)
    S = dpp_stencils(state.mesh, state.params)
    g1, g2 = state.grids
    with pytest.raises(ValueError):
        fused_dpp_apply(g1, g2.cpu(), *S)
    with pytest.raises(TypeError):
        fused_dpp_apply(g1, g2.float(), *S)
    with pytest.raises(ValueError):
        fused_dpp_apply(g1.t(), g2.t(), *S)


@pytest.mark.parametrize(
    "element,cells", [("quad", (16, 16)), ("quad", (64, 64)), ("hex", (8, 8, 8))],
    ids=["quad16", "quad64", "hex8"],
)
def test_k2_matches_twin(cuda, element, cells):
    state = _state(element, cells, cuda, seed=1)
    k2 = fused_direct_solve(DPPOperator(state.W, state.params))
    b = torch.stack(state.grids)
    x = k2.launch(b)
    torch.cuda.synchronize()
    assert _rel(x, k2.plain(b)) <= 1e-11


@pytest.mark.parametrize(
    "element,cells", [("triangle", (8, 8)), ("tet", (4, 4, 4)), ("tet", (8, 8, 8))],
    ids=["tri8", "tet4", "tet8"],
)
def test_k3_matches_twin(cuda, element, cells):
    state = _state(element, cells, cuda, seed=2)
    k3 = fused_simplicial_direct_solve(DPPOperator(state.W, state.params))
    b = torch.stack(state.grids)
    x, its = k3.launch(b)
    torch.cuda.synchronize()
    xp, its_p = k3.plain(b)
    assert _rel(x, xp) <= 1e-11
    assert abs(int(its.item()) - its_p) <= 2


GMRES_ROLES = [(K5, "none"), (K4, "none"), (K4, "jacobi")]


@pytest.mark.parametrize("role,pc", GMRES_ROLES, ids=["k5", "k4-none", "k4-jacobi"])
@pytest.mark.parametrize(
    "element,cells", [("quad", (8, 8)), ("quad", (16, 16)), ("tet", (4, 4, 4))],
    ids=["quad8", "quad16", "tet4"],
)
def test_fused_gmres_matches_twin(cuda, element, cells, role, pc):
    """Bit-level agreement is the target: the kernel keeps the twin's
    halving trees and rounds every multiply and add on its own."""
    state = _state(element, cells, cuda, seed=3)
    op = DPPOperator(state.W, state.params)
    solver = FusedGMRESSolver(op, pc, role, rtol=1e-8, atol=1e-12, max_it=5000)
    b = torch.stack(op.lifted_rhs(*state.grids)).contiguous()
    before = _cuda.KERNEL_LAUNCHES[role]
    got = solver.launch(b)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[role] == before + 1
    ref = solver.plain(b)
    assert got.iterations == ref.iterations > 0
    assert got.converged == ref.converged
    assert _rel(got.x, ref.x) <= 1e-13


BLOCK_PCS = [  # pc, max_it, bound on the relative difference
    ("none", 40, 0.0),  # one restart, then stops on max_it
    ("jacobi", 40, 0.0),  # (converges at 50 on the smallest mesh)
    ("ilu", 5000, 0.0),
    ("fieldsplit_ilu", 5000, 0.0),
    ("fieldsplit_lu", 5000, 1e-10),
]
BLOCK_MESHES = [  # blocks, cells: 2 (nx + 1) (ny + 1) values, no multiple of 512
    (1, (12, 18)),  # 494
    (2, (20, 22)),  # 966
    (4, (30, 31)),  # 1984
    (8, (44, 43)),  # 3960
    (16, (48, 42)),  # 4214
]


@pytest.mark.parametrize("blocks,cells", BLOCK_MESHES, ids=[str(c[0]) for c in BLOCK_MESHES])
@pytest.mark.parametrize("pc,max_it,tol", BLOCK_PCS, ids=[c[0] for c in BLOCK_PCS])
def test_fused_gmres_every_block_count(cuda, pc, max_it, tol, blocks, cells):
    """Every block count the launcher can choose, for every preconditioner:
    the launcher takes its blocks from the length alone, so each count has
    its mesh."""
    state = _state("quad", cells, cuda, seed=6)
    op = DPPOperator(state.W, state.params)
    solver = FusedGMRESSolver(op, pc, rtol=1e-8, atol=1e-12, max_it=max_it)
    b = torch.stack(op.lifted_rhs(*state.grids)).contiguous()
    ref = solver.plain(b)
    assert launch_geometry(b.numel()).blocks == blocks
    got = solver.launch(b)
    torch.cuda.synchronize()
    assert solver.last_geometry[0] == blocks
    assert got.iterations == ref.iterations > 0
    assert got.converged == ref.converged
    assert (got.iterations == max_it) == (pc in ("none", "jacobi"))
    assert got.residual_norm == ref.residual_norm or tol > 0.0
    assert _rel(got.x, ref.x) <= tol


def test_fused_gmres_rejects_bad_inputs(cuda):
    state = _state("quad", (4, 4), cuda)
    solver = FusedGMRESSolver(DPPOperator(state.W, state.params), "jacobi")
    b = torch.stack(state.grids).contiguous()
    with pytest.raises(ValueError):
        solver.launch(b.cpu())
    with pytest.raises(ValueError):
        solver.launch(b, x0=b.cpu())
    with pytest.raises(TypeError):
        solver.launch(b.float())
    with pytest.raises(ValueError):
        solver.launch(b[:, :-1].contiguous())
    with pytest.raises(ValueError):
        solver.launch(b.transpose(1, 2))


PC_ROLES = [  # pc, mesh, bound on the relative difference
    ("ilu", ("quad", (16, 16)), 0.0),  # the twin's order: bit for bit
    ("ilu", ("tet", (4, 4, 4)), 0.0),
    ("fieldsplit_ilu", ("quad", (8, 8)), 0.0),
    ("fieldsplit_ilu", ("tet", (4, 4, 4)), 0.0),
    # per-axis loops against torch.matmul's sums: rounding apart
    ("fieldsplit_lu", ("quad", (16, 16)), 1e-10),
    ("fieldsplit_lu", ("tet", (4, 4, 4)), 1e-10),
]


@pytest.mark.parametrize(
    "pc,mesh,tol", PC_ROLES, ids=[f"{pc}-{m[0]}{m[1][0]}" for pc, m, _ in PC_ROLES]
)
def test_preconditioned_gmres_matches_twin(cuda, pc, mesh, tol):
    """K6, K7, K8: equal counts; K7 and K8 keep the twin's order bit for bit."""
    state = _state(*mesh, cuda, seed=4)
    op = DPPOperator(state.W, state.params)
    solver = FusedGMRESSolver(op, pc, rtol=1e-8, atol=1e-12, max_it=5000)
    b = torch.stack(op.lifted_rhs(*state.grids)).contiguous()
    before = _cuda.KERNEL_LAUNCHES[solver.role]
    got = solver.launch(b)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[solver.role] == before + 1
    ref = solver.plain(b)
    assert got.iterations == ref.iterations > 0
    assert got.converged == ref.converged
    assert _rel(got.x, ref.x) <= tol


ROLES_64 = [  # the preconditioned roles at 2D N=64, where they cost the most
    ("fieldsplit_ilu", 0.0),  # K8: the ring on 33 rows a level, bit for bit
    ("fieldsplit_lu", 1e-10),  # K6: the cluster's fast-diag transform
    ("ilu", 0.0),  # K7: 66 rows a level, the ring
]


@pytest.mark.parametrize("pc,tol", ROLES_64, ids=["k8", "k6", "k7"])
def test_preconditioned_gmres_at_quad64(cuda, pc, tol):
    """K6-K8 at 2D N=64 on 16 blocks: equal counts (K8 also its inner PCG's),
    and the shared memory the launcher reports is the Python mirror's."""
    state = _state("quad", (64, 64), cuda, seed=8)
    op = DPPOperator(state.W, state.params)
    solver = FusedGMRESSolver(op, pc, rtol=1e-8, atol=1e-12, max_it=5000)
    b = torch.stack(op.lifted_rhs(*state.grids)).contiguous()
    got = solver.launch(b)
    torch.cuda.synchronize()
    ref = solver.plain(b)
    assert got.iterations == ref.iterations > 0
    assert got.converged == ref.converged
    assert _rel(got.x, ref.x) <= tol
    geo = solver.last_geometry
    ilu = solver.ilu if pc == "ilu" else (solver.field_ilu[0] if solver.field_ilu is not None else None)
    plan = plan_smem(
        solver.node_shape, pc, geo.budget,
        ilu_shape=None if ilu is None else (len(ilu.lower), len(ilu.upper), ilu.num_levels, ilu.max_level_rows),
        distinct=getattr(solver, "distinct_axes", None),
    )
    assert geo.blocks == 16
    assert (geo.input_smem, geo.p_smem, geo.s_smem, geo.basis_smem) == (
        plan.input_smem, plan.p_smem, plan.s_smem, plan.basis_smem)
    if ilu is not None:
        assert geo.ilu_z_smem == plan.ilu.z_smem
    if pc == "fieldsplit_ilu":
        # the twin applies P(b - A x0) twice, the kernel once
        twin = (solver.inner_iterations, solver.inner_solves)
        solver.inner_iterations = solver.inner_solves = 0
        solver.plain_pc()(b)
        assert solver.launch_inner == (twin[0] - solver.inner_iterations, twin[1] - solver.inner_solves)


SWEEP_PATHS = [  # system, mesh, offsets a side and rows of the widest level
    ("field", ("quad", (16, 16)), 4, 9),  # narrow levels: one consumer warp
    ("field", ("tet", (4, 4, 4)), 13, 8),
    ("monolithic", ("quad", (16, 16)), 13, 18),
    ("monolithic", ("tet", (4, 4, 4)), 40, 15),
    ("field", ("quad", (128, 128)), 4, 65),  # three consumer warps
    ("monolithic", ("quad", (64, 64)), 13, 66),
]


@pytest.mark.parametrize(
    "kind,mesh,nt,widest", SWEEP_PATHS, ids=[f"{k}-{m[0]}{m[1][0]}" for k, m, _, _ in SWEEP_PATHS]
)
def test_structured_ilu_sweep_paths(cuda, kind, mesh, nt, widest):
    """Narrow levels and wide ones, each the plain sweep's bits on the ring,
    with the layout ops/ilu.py::ilu_plan gives for the kernel's budget."""
    state = _state(*mesh, cuda, seed=9)
    p = state.params
    if kind == "monolithic":
        pc = StructuredILU0.for_monolithic(state.mesh, p, cuda)
    else:
        pc = StructuredILU0.for_field(FieldOperator(state.W.sub(0), p.k1, p.beta, p.mu))
    r = torch.randn(pc.nrows, dtype=torch.float64, device=cuda)
    z = pc.apply_flat(r)
    torch.cuda.synchronize()
    assert float((z - pc.plain(r)).abs().max()) == 0.0
    geo = pc.last_geometry
    plan = ilu_plan(len(pc.lower), len(pc.upper), pc.nrows, pc.num_levels, pc.max_level_rows, geo.budget)
    assert (len(pc.lower), pc.max_level_rows) == (nt, widest)
    assert geo.stages >= 2 and (geo.stages, geo.z_smem, geo.bytes) == (plan.stages, plan.z_smem, plan.bytes)
    assert float((pc.apply_flat(r) - z).abs().max()) == 0.0  # and the same again


ILU_MESHES = [
    ("quad", (16, 16)), ("tet", (4, 4, 4)),
    # 129^2 rows of a field fit shared memory (133 KB), the monolithic
    # system's 33,282 do not (266 KB)
    ("quad", (128, 128)),
    # 3D monolithic: 40 offsets a side, the widest stage rows
    ("hex", (12, 12, 12)),
]


@pytest.mark.parametrize("kind", ["monolithic", "field"])
@pytest.mark.parametrize("element,cells", ILU_MESHES, ids=["quad16", "tet4", "quad128", "hex12"])
def test_structured_ilu_apply_matches_plain_sweep(cuda, element, cells, kind):
    state = _state(element, cells, cuda, seed=5)
    p = state.params
    if kind == "monolithic":
        pc = StructuredILU0.for_monolithic(state.mesh, p, cuda)
    else:
        pc = StructuredILU0.for_field(FieldOperator(state.W.sub(1), p.k2, p.beta, p.mu))
    r = torch.randn(pc.nrows, dtype=torch.float64, device=cuda)
    before = _cuda.KERNEL_LAUNCHES["structured_ilu_apply"]
    z = pc.apply_flat(r)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES["structured_ilu_apply"] == before + 1
    assert float((z - pc.plain(r)).abs().max()) == 0.0
    geo = pc.last_geometry
    if cells == (128, 128):
        assert geo.stages >= 2 and geo.z_smem == (kind == "field")


ILU_DEPTHS = [  # monolithic mesh, ring stages (0: the direct loop), z in shared memory
    # 40 offsets a side: the run-time offset loop
    ("hex", (15, 15, 15), 3, True),
    ("hex", (16, 16, 16), 2, True),
    ("hex", (20, 20, 20), 2, False),
    ("hex", (28, 28, 28), 0, False),  # 436 rows a level: no two stages fit
    # 13 offsets a side: the straight code
    ("quad", (512, 512), 3, False),
    ("quad", (640, 640), 2, False),
]


@pytest.mark.parametrize(
    "element,cells,stages,z_shared", ILU_DEPTHS, ids=[f"{c[0]}{c[1][0]}" for c in ILU_DEPTHS]
)
def test_structured_ilu_apply_shallow_rings(cuda, element, cells, stages, z_shared):
    """Levels so wide that the ring holds fewer stages than the sweep has
    producer warps, down to none (the direct loop): still the plain sweep's
    bits."""
    state = _state(element, cells, cuda, seed=7)
    pc = StructuredILU0.for_monolithic(state.mesh, state.params, cuda)
    r = torch.randn(pc.nrows, dtype=torch.float64, device=cuda)
    z = pc.apply_flat(r)
    torch.cuda.synchronize()
    assert pc.last_geometry[:2] == (stages, z_shared)
    assert float((z - pc.plain(r)).abs().max()) == 0.0
    assert float((pc.apply_flat(r) - z).abs().max()) == 0.0  # and the same again


def test_structured_ilu_apply_rejects_bad_inputs(cuda):
    state = _state("quad", (4, 4), cuda)
    pc = StructuredILU0.for_monolithic(state.mesh, state.params, cuda)
    r = torch.zeros(pc.nrows, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        pc.launch(r.cpu())
    with pytest.raises(TypeError):
        pc.launch(r.float())
    with pytest.raises(ValueError):
        pc.launch(r[:-1])
    with pytest.raises(ValueError):
        pc.launch(torch.zeros(2 * pc.nrows, dtype=torch.float64, device=cuda)[::2])
