"""The port's CUDA kernels K1-K8, ``structured_ilu_apply`` (and its
Gauss-Seidel mode), ``fused_ngs``, ``fused_gs`` and ``band_trisolve`` against their plain PyTorch twins, on the
card. A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one; run them on the card with
``python -m pytest tests/test_torch_kernels.py -q``."""

import numpy as np
import pytest
import torch

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.forms import create_function_spaces, mixed_space
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.mesh import create_mesh
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops import _cuda, _native
from perphil_tpu_torch.ops import bandsolve as bs
from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator, FieldOperator, dpp_stencils
from perphil_tpu_torch.ops.fused_apply import (
    fill_chunk,
    fused_dpp_apply,
    fused_dpp_apply_halo,
    fused_dpp_apply_halo_planes,
    fused_dpp_apply_halo_planes_plain,
    fused_dpp_apply_plain,
    fused_dpp_apply_stacked,
    halo_plan,
    halo_wave,
)
from perphil_tpu_torch.ops.fused_direct import K2, K3, fused_direct_solve, fused_simplicial_direct_solve, mesh_plan
from perphil_tpu_torch.ops.fused_direct import SMEM_BUDGET as DIRECT_SMEM_BUDGET
from perphil_tpu_torch.ops.fused_gmres import (
    K4,
    K5,
    MAX_SMEM_PER_BLOCK,
    SMEM_BUDGET,
    FusedGMRESSolver,
    fused_gmres_plan,
    fused_gmres_supported,
    launch_geometry,
    plan_smem,
    static_smem,
)
from perphil_tpu_torch.ops.fused_gs import KERNEL as FUSED_GS_KERNEL, FusedGSSolver
from perphil_tpu_torch.ops.fused_ngs import COLOUR_KERNEL, KERNEL as NGS_KERNEL, FusedNGSSolver
from perphil_tpu_torch.ops.ilu import GS_KERNEL, GaussSeidelSweeper, StructuredILU0, ilu_plan
from perphil_tpu_torch.parallel.halo import block_geometry, join_blocks, loopback_planes, split_blocks
from perphil_tpu_torch.parallel.halo import loopback_apply
from perphil_tpu_torch.parallel.transpose import LoopbackBlocks
from perphil_tpu_torch.ops.ordering import parity_system
from perphil_tpu_torch.solvers import solve_dpp_nonlinear
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions

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


# node grids that are no multiple of the 16 x 16 tile, the first and last
# z chunk short, and the largest the main path gives K1 (129^3)
K1_TILES = [  # element, cells (node grid: each + 1, reversed), halo blocks
    ("quad", (2, 2), None),  # 3 x 3
    ("triangle", (6, 4), None),  # 5 x 7
    ("hex", (32, 44, 66), None),  # 67 x 45 x 33
    ("tet", (32, 44, 66), None),
    ("hex", (128, 128, 128), None),  # 129^3
    # K1's halo form over loopback blocks of the phantom-padded grid
    ("triangle", (6, 4), (2, 2)),
    ("hex", (32, 44, 66), (4, 2)),
    ("hex", (128, 128, 128), (8,)),
]


def _k1_tile_id(element, cells, blocks):
    return f"{element}{'x'.join(map(str, cells))}" + (f"-halo{'x'.join(map(str, blocks))}" if blocks else "")


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 2e-6)], ids=["f64", "f32"])
@pytest.mark.parametrize("element,cells,blocks", K1_TILES, ids=[_k1_tile_id(*c) for c in K1_TILES])
@pytest.mark.parametrize("mode", ["matvec", "lift"])
def test_k1_tiles_match_twin(cuda, element, cells, blocks, dtype, tol, mode):
    """The tiled kernel on ragged tiles and chunks, in both entries: the
    stacked one equals the (z1, z2) one bit for bit, one launch each. With
    ``blocks``: K1's halo form, one launch a block, equals K1 bit for bit on
    the physical grid and its halo twin within ``tol``."""
    state = _state(element, cells, cuda, seed=10)
    S = dpp_stencils(state.mesh, state.params)
    z = torch.stack(state.grids).to(dtype)
    if blocks is not None:
        shape = tuple(z.shape[1:])
        pad = [(-n) % b for n, b in zip(shape, blocks)] + [0] * (len(shape) - len(blocks))
        zp = torch.nn.functional.pad(z, [v for q in reversed(pad) for v in (0, q)])
        crop = (slice(None),) + tuple(slice(0, n) for n in shape)
        before = _cuda.KERNEL_LAUNCHES["fused_dpp_apply_halo"]
        y = loopback_apply(zp, S, blocks, mode, n_phys=shape)
        torch.cuda.synchronize()
        assert _cuda.KERNEL_LAUNCHES["fused_dpp_apply_halo"] == before + int(np.prod(blocks))
        want = zp.clone()  # phantom rows: the identity
        want[crop] = fused_dpp_apply_stacked(z, *S, mode=mode)
        assert torch.equal(y, want)
        plain = loopback_apply(zp.cpu(), S, blocks, mode, n_phys=shape)
        assert _rel(y.cpu(), plain) <= tol
        return
    before = _cuda.KERNEL_LAUNCHES["fused_dpp_apply"]
    y1, y2 = fused_dpp_apply(z[0], z[1], *S, mode=mode)
    y = fused_dpp_apply_stacked(z, *S, mode=mode)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES["fused_dpp_apply"] == before + 2
    assert y.shape == z.shape and y.dtype == dtype
    assert torch.equal(y[0], y1) and torch.equal(y[1], y2)
    for a, b in zip((y1, y2), fused_dpp_apply_plain(z[0], z[1], *S, mode=mode)):
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
    z = torch.stack(state.grids)
    with pytest.raises(ValueError):
        fused_dpp_apply_stacked(z.transpose(1, 2), *S)
    with pytest.raises(ValueError):
        fused_dpp_apply_stacked(z[:1], *S)
    with pytest.raises(TypeError):
        fused_dpp_apply_stacked(z.to(torch.int64), *S)



# K1's halo form on an owned block and the planes its neighbours sent:
# slabs, (2, 2) and (4, 2) pencils and a 3-axis mesh, padded and not, 2D and 3D
HALO_LAYOUTS = [  # element, cells (node grid: each + 1, reversed), blocks
    ("quad", (32, 31), (4,)), ("triangle", (40, 27), (2, 2)), ("quad", (33, 40), (4, 2)),
    ("hex", (34, 20, 47), (8,)), ("tet", (31, 33, 20), (2, 2)), ("hex", (20, 23, 17), (4, 2)),
    ("hex", (17, 12, 15), (2, 3, 2)),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 2e-6)], ids=["f64", "f32"])
@pytest.mark.parametrize("element,cells,blocks", HALO_LAYOUTS, ids=[_k1_tile_id(*c) for c in HALO_LAYOUTS])
@pytest.mark.parametrize("mode", ["matvec", "lift"])
def test_k1_halo_planes_match_twin_and_k1(cuda, element, cells, blocks, dtype, tol, mode):
    """The planes entry, one launch a block, each block's planes read where
    they lie: every block within ``tol`` of its twin, and the joined owned
    blocks K1 on the whole grid bit for bit (phantom rows the identity)."""
    state = _state(element, cells, cuda, seed=11)
    S = dpp_stencils(state.mesh, state.params)
    z = torch.stack(state.grids).to(dtype)
    shape = tuple(z.shape[1:])
    pad = [(-n) % b for n, b in zip(shape, blocks)] + [0] * (len(shape) - len(blocks))
    zp = torch.nn.functional.pad(z, [v for q in reversed(pad) for v in (0, q)])
    split = split_blocks(zp, blocks)
    planes = loopback_planes(split, blocks)
    local = [n // b for n, b in zip(zp.shape[1:], blocks)] + list(zp.shape[1 + len(blocks):])
    before = _cuda.KERNEL_LAUNCHES["fused_dpp_apply_halo"]
    out = {}
    for c, b in split.items():
        _, offsets, n_phys = block_geometry(blocks, c, local, shape)
        out[c] = fused_dpp_apply_halo_planes(b[0], b[1], planes[c], *S, mode=mode, offsets=offsets, n_phys=n_phys)
        cpu = [None if g is None else g.cpu() for pair in planes[c] for g in pair]
        twin = fused_dpp_apply_halo_planes_plain(b[0].cpu(), b[1].cpu(), [cpu[i:i + 2] for i in range(0, len(cpu), 2)],
                                                 *S, mode=mode, offsets=offsets, n_phys=n_phys)
        assert _rel(out[c].cpu(), twin) <= tol
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES["fused_dpp_apply_halo"] == before + len(split)
    want = zp.clone()
    want[(slice(None),) + tuple(slice(0, n) for n in shape)] = fused_dpp_apply_stacked(z, *S, mode=mode)
    assert torch.equal(join_blocks(out, blocks), want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("element,cells,padding", [("hex", (128, 128, 128), (0, 0, 0)), ("hex", (128, 128, 128), (7, 0, 0)),
                                                   ("quad", (40, 27), (3, 5)), ("tet", (9, 14, 20), (1, 2, 3))],
                         ids=["hex128", "hex128-padded", "quad-padded", "tet-padded"])
def test_k1_halo_with_no_ghost_is_k1(cuda, element, cells, padding, dtype):
    """With no ghost the halo form is K1 bit for bit in both entries and
    both modes, one launch each; on a padded grid the physical block is
    K1's and the phantom rows the identity. A 129^3 box launches K1's 8 x 8
    x 32 blocks."""
    state = _state(element, cells, cuda, seed=12)
    S = dpp_stencils(state.mesh, state.params)
    z = torch.stack(state.grids).to(dtype)
    shape = tuple(z.shape[1:])
    zp = torch.nn.functional.pad(z, [v for q in reversed(padding) for v in (0, q)])
    for mode in ("matvec", "lift"):
        want = zp.clone()
        want[(slice(None),) + tuple(slice(0, n) for n in shape)] = fused_dpp_apply_stacked(z, *S, mode=mode)
        before = _cuda.KERNEL_LAUNCHES["fused_dpp_apply_halo"]
        box = fused_dpp_apply_halo(zp, *S, mode=mode, n_phys=shape)
        planes = fused_dpp_apply_halo_planes(zp[0], zp[1], (), *S, mode=mode, n_phys=shape)
        torch.cuda.synchronize()
        assert _cuda.KERNEL_LAUNCHES["fused_dpp_apply_halo"] == before + 2
        assert torch.equal(box, want) and torch.equal(planes, want)
    if not any(padding) and len(shape) == 3:
        assert halo_plan(shape, chunk=4).blocks == (32, 8, 8)  # K1's tiles and chunk
        assert halo_plan(shape, wave=halo_wave(cuda, dtype, 3)).blocks == (16, 8, 8)


def test_k1_halo_fill_rule_at_a_slab(cuda):
    """The card's wave (occupancy times SMs) and the plan at the slabs of
    the padded 128^3 grid over 8 ranks: K1's chunk of 4 (8 only where a
    launch at 8 holds one and a half waves, as on the whole grid)."""
    wave = halo_wave(cuda, torch.float64, 3)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert wave >= 4 * sms and wave % sms == 0  # __launch_bounds__: at least kMinBlocks an SM
    for rank in range(8):
        plan = halo_plan((19, 129, 129), ((1, 1), (0, 0), (0, 0)), (17 * rank, 0, 0), (129, 129, 129), wave)
        columns, planes = plan.blocks[1] * plan.blocks[2], plan.c1[0] - plan.c0[0]
        assert plan.chunk == fill_chunk(columns, planes, wave) == 4
        assert 2 * columns * -(-planes // 8) < 3 * wave
    middle = halo_plan((19, 129, 129), ((1, 1), (0, 0), (0, 0)), (17 * 3, 0, 0), (129, 129, 129), wave)
    assert middle.blocks == (-(-17 // middle.chunk), 8, 8)

# each placement of the plan (direct_smem.cuh): one block of 64 (K3: the
# dense one), 128, 256 and 512 threads owning 1 interior node, 512 owning 2,
# 4 and 8; the last mesh one block holds (quad 65, hex 17, tri 51, tet 14);
# clusters of 2, 4, 8 and 16 blocks (K2 quad 66/128/256, hex 18/24/32; K3
# tri 52/128, tet 16/32); the largest mesh the solve route takes each on
# (quad 120, hex 33, tri 150, tet 39); the published sizes; axes of unequal
# length (each eigenbasis staged on its own)
K2_CASES = [
    ("quad", (4, 4)), ("quad", (8, 8)), ("quad", (10, 10)), ("quad", (16, 16)), ("quad", (30, 30)),
    ("quad", (40, 40)), ("quad", (64, 64)), ("quad", (65, 65)), ("quad", (13, 9)),
    ("hex", (8, 8, 8)), ("hex", (14, 14, 14)), ("hex", (17, 17, 17)), ("hex", (7, 6, 5)),
    ("quad", (66, 66)), ("quad", (128, 128)), ("quad", (256, 256)), ("quad", (100, 70)),
    ("hex", (18, 18, 18)), ("hex", (24, 24, 24)), ("hex", (32, 32, 32)),
    ("quad", (120, 120)), ("hex", (33, 33, 33)),
]
K3_CASES = [
    ("triangle", (5, 5)), ("tet", (3, 3, 3)), ("tet", (4, 4, 4)), ("triangle", (8, 8)), ("triangle", (13, 9)),
    ("tet", (6, 6, 6)), ("tet", (8, 8, 8)), ("tet", (11, 11, 11)), ("triangle", (40, 40)),
    ("tet", (14, 14, 14)), ("triangle", (51, 51)), ("tet", (7, 6, 5)),
    ("triangle", (52, 52)), ("triangle", (128, 128)), ("tet", (16, 16, 16)), ("tet", (32, 32, 32)),
    ("tet", (20, 18, 16)), ("triangle", (150, 150)), ("tet", (39, 39, 39)),
    # the dense placement (64 threads) on unequal axes: its matrix's Kronecker order
    ("triangle", (4, 6)), ("tet", (3, 4, 2)),
]


def _direct_id(case):
    return f"{case[0]}{'x'.join(map(str, case[1]))}"


@pytest.mark.parametrize("element,cells", K2_CASES, ids=[_direct_id(c) for c in K2_CASES])
def test_k2_matches_twin(cuda, element, cells):
    state = _state(element, cells, cuda, seed=1)
    op = DPPOperator(state.W, state.params)
    k2 = fused_direct_solve(op)
    b = torch.stack(state.grids)
    before = _cuda.KERNEL_LAUNCHES[K2]
    x = k2.launch(b)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[K2] == before + 1
    assert _rel(x, k2.plain(b)) <= 1e-11
    assert k2.last_placement == mesh_plan(op)  # the launcher's shared memory is the plan's


@pytest.mark.parametrize("element,cells", K3_CASES, ids=[_direct_id(c) for c in K3_CASES])
def test_k3_matches_twin(cuda, element, cells):
    state = _state(element, cells, cuda, seed=2)
    op = DPPOperator(state.W, state.params)
    k3 = fused_simplicial_direct_solve(op)
    b = torch.stack(state.grids)
    before = _cuda.KERNEL_LAUNCHES[K3]
    x, its = k3.launch(b)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[K3] == before + 1
    xp, its_p = k3.plain(b)
    assert _rel(x, xp) <= 1e-11
    assert abs(int(its.item()) - its_p) <= 2
    assert k3.last_placement == mesh_plan(op)


@pytest.mark.parametrize("symbol,dims", [
    ("perphil_fused_direct", (1, 301, 301, 2)), ("perphil_fused_direct", (49, 49, 49, 3)),
    ("perphil_fused_pcg", (1, 257, 257, 2)), ("perphil_fused_pcg", (41, 41, 41, 3)),
], ids=["k2-quad300", "k2-hex48", "k3-tri256", "k3-tet40"])
def test_direct_launch_beyond_the_plan_refuses(cuda, symbol, dims):
    """A launcher refuses (cudaErrorInvalidValue, 1) a grid its plan does not
    place, before it reads any pointer: it never runs."""
    lib = _cuda.library()
    stream = torch.cuda.current_stream().cuda_stream
    weights = np.zeros(81)
    sx = torch.zeros(1, dtype=torch.float64 if symbol == "perphil_fused_pcg" else torch.float32, device=cuda)
    ptr = sx.data_ptr()  # one matrix for every axis: the fewest bytes the plan can count
    placement = np.full(4, -1, np.int32)
    if symbol == "perphil_fused_direct":
        err = lib.perphil_fused_direct(None, None, ptr, ptr, ptr, None, None, None, 1.0, weights.ctypes.data,
                                       *dims, 5, placement.ctypes.data, stream)
    else:
        err = lib.perphil_fused_pcg(None, None, None, ptr, ptr, ptr, None, None, weights.ctypes.data, *dims,
                                    1e-13, 2000, placement.ctypes.data, stream)
    torch.cuda.synchronize()
    assert err == 1 and (placement == -1).all()


def test_direct_kernels_leave_the_budget(cuda):
    """Every placement's kernel, 2D and 3D, leaves the launches' budget
    (kDirectSmemBudget) of a block's shared memory beside its static shared
    memory."""
    lib = _cuda.library()
    for fn in (lib.perphil_fused_direct_static_smem, lib.perphil_fused_pcg_static_smem):
        for dim in (2, 3):
            nbytes = fn(dim)
            assert 0 < nbytes and MAX_SMEM_PER_BLOCK - nbytes >= DIRECT_SMEM_BUDGET


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


LEAF_MESHES = [  # leaves a thread on 16 blocks, element, cells: 2 (nx + 1) (ny + 1) [(nz + 1)] values,
    # no multiple of 512
    (4, "quad", (100, 110)),  # 22,422
    (8, "quad", (150, 160)),  # 48,622
    (16, "quad", (220, 230)),  # 102,102
    (32, "quad", (300, 320)),  # 193,242
    # 3D, the preconditioned roles only: K7's 40 offsets a side on the direct
    # loop, K8's field sweep, K6's eigenbases in shared memory (8 leaves) and
    # outside it (16)
    (8, "hex", (30, 28, 26)),  # 48,546
    (8, "tet", (30, 28, 26)),
    (16, "hex", (40, 36, 34)),  # 106,190
    (16, "tet", (40, 36, 34)),
]
LEAF_PCS = [  # pc, max_it (the twins stay short), bound on the relative difference
    ("none", 40, 0.0),
    ("jacobi", 40, 0.0),
    ("ilu", 10, 0.0),
    ("fieldsplit_lu", 3, 1e-10),
    ("fieldsplit_ilu", 1, 0.0),
]
# every role the gate admits there (the fieldsplit roles' slices leave out 32
# leaves; plain and Jacobi GMRES run in 3D at 16 and 32 leaves in chip_smoke.py)
LEAF_CASES = [(pc, it, tol, leaves, element, cells) for pc, it, tol in LEAF_PCS
              for leaves, element, cells in LEAF_MESHES
              if (leaves < 32 or not pc.startswith("fieldsplit")) and (element == "quad" or pc not in ("none", "jacobi"))]


@pytest.mark.parametrize(
    "pc,max_it,tol,leaves,element,cells", LEAF_CASES,
    ids=[f"{c[0]}-{c[3]}" if c[4] == "quad" else f"{c[0]}-{c[4]}{c[3]}" for c in LEAF_CASES],
)
def test_fused_gmres_every_leaf_count(cuda, pc, max_it, tol, leaves, element, cells):
    """The 16-block cluster at 4 to 32 leaves a thread (the frame's and the
    inner PCG's per-leaf loops, the many-leaf tree, the basis in device
    memory), in 2D and, for the preconditioned roles, 3D, against the twin,
    with max_it bounded; the shared memory the launcher reports is the
    gate's plan."""
    state = _state(element, cells, cuda, seed=11)
    op = DPPOperator(state.W, state.params)
    assert fused_gmres_supported(op, pc)
    solver = FusedGMRESSolver(op, pc, rtol=1e-12, atol=1e-50, max_it=max_it)
    b = torch.stack(op.lifted_rhs(*state.grids)).contiguous()
    assert launch_geometry(b.numel()) == (16, leaves)
    got = solver.launch(b)
    torch.cuda.synchronize()
    ref = solver.plain(b)
    assert solver.last_geometry.blocks == 16
    assert got.iterations == ref.iterations == max_it
    assert got.converged == ref.converged
    assert got.residual_norm == ref.residual_norm or tol > 0.0
    assert _rel(got.x, ref.x) <= tol
    plan = fused_gmres_plan(solver.node_shape, pc)
    geo = solver.last_geometry
    assert (geo.basis_smem, geo.input_smem, geo.p_smem, geo.s_smem) == (
        plan.basis_smem, plan.input_smem, plan.p_smem, plan.s_smem)
    assert geo.line_warps == plan.line_warps
    if plan.ilu is not None:
        assert geo.ilu_z_smem == plan.ilu.z_smem


@pytest.mark.parametrize("pc", ["none", "jacobi", "ilu", "fieldsplit_lu", "fieldsplit_ilu"])
def test_fused_gmres_units_leave_the_budget(cuda, pc):
    """Each role's kernel, 2D and 3D, leaves the launches' budget
    (kGmresSmemBudget) of a block's shared memory beside its static shared
    memory: the gate plans with that budget, so a unit that leaves less
    would refuse every launch."""
    for dim in (2, 3):
        assert MAX_SMEM_PER_BLOCK - static_smem(pc, dim) >= SMEM_BUDGET


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


PC_ROLES = [  # pc, mesh, bound on the relative difference, K8's inner solve
    ("ilu", ("quad", (16, 16)), 0.0, "literal"),  # the twin's order: bit for bit
    ("ilu", ("tet", (4, 4, 4)), 0.0, "literal"),
    ("fieldsplit_ilu", ("quad", (8, 8)), 0.0, "literal"),
    ("fieldsplit_ilu", ("tet", (4, 4, 4)), 0.0, "literal"),
    ("fieldsplit_ilu", ("quad", (8, 8)), 0.0, "pcg"),
    ("fieldsplit_ilu", ("tet", (4, 4, 4)), 0.0, "pcg"),
    # per-axis loops against torch.matmul's sums: rounding apart
    ("fieldsplit_lu", ("quad", (16, 16)), 1e-10, "literal"),
    ("fieldsplit_lu", ("tet", (4, 4, 4)), 1e-10, "literal"),
]


def _inner_counts_match(solver, b):
    """The kernel's inner counts are the twin's but for the twin's repeated
    first application of P(b - A x0), two block solves."""
    twin = (solver.inner_iterations, solver.inner_solves)
    solver.inner_iterations = solver.inner_solves = 0
    solver.plain_pc()(b)
    return solver.launch_inner == (twin[0] - solver.inner_iterations, twin[1] - solver.inner_solves)


@pytest.mark.parametrize(
    "pc,mesh,tol,inner", PC_ROLES,
    ids=[f"{pc}-{m[0]}{m[1][0]}" + ("-pcg" if inner == "pcg" else "") for pc, m, _, inner in PC_ROLES],
)
def test_preconditioned_gmres_matches_twin(cuda, pc, mesh, tol, inner):
    """K6, K7, K8: equal counts; K7 and K8 (both inner modes, their inner
    counts too) keep the twin's order bit for bit."""
    state = _state(*mesh, cuda, seed=4)
    op = DPPOperator(state.W, state.params)
    solver = FusedGMRESSolver(op, pc, rtol=1e-8, atol=1e-12, max_it=5000, inner_ksp=inner)
    b = torch.stack(op.lifted_rhs(*state.grids)).contiguous()
    before = _cuda.KERNEL_LAUNCHES[solver.role]
    got = solver.launch(b)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[solver.role] == before + 1
    ref = solver.plain(b)
    assert got.iterations == ref.iterations > 0
    assert got.converged == ref.converged
    assert _rel(got.x, ref.x) <= tol
    if pc == "fieldsplit_ilu":
        assert _inner_counts_match(solver, b)


K8_LINES = [  # element, cells, K8's inner solve, max_it (the twin stays short at N=128)
    ("quad", (8, 8), "literal", 5000),       # one warp
    ("quad", (64, 64), "literal", 5000),     # three warps
    ("quad", (40, 40), "literal", 5000),     # 41 lines: not a multiple of a warp's 32
    ("quad", (128, 128), "literal", 1),      # 129 lines, five warps: the first outer step
    ("quad", (40, 40), "pcg", 5000),         # the PCG blocks sweep on the pipeline too
    ("tet", (4, 4, 4), "literal", 5000),     # 3D fields: the ring
    ("hex", (5, 5, 5), "literal", 5000),
]


@pytest.mark.parametrize("element,cells,inner,max_it", K8_LINES,
                         ids=[f"{c[0]}{c[1][0]}-{c[2]}" for c in K8_LINES])
def test_k8_line_pipeline_matches_twin(cuda, element, cells, inner, max_it):
    """K8 with its 2D field sweeps on the line pipeline
    (``csrc/field_sweep.cuh``; 3D fields on the ring): bit for bit with the
    twin, equal outer and inner counts, the pipeline's warps the plan's
    (ceil(ny / 32) in 2D, none in 3D)."""
    state = _state(element, cells, cuda, seed=5)
    op = DPPOperator(state.W, state.params)
    solver = FusedGMRESSolver(op, "fieldsplit_ilu", rtol=1e-8, atol=1e-12, max_it=max_it, inner_ksp=inner)
    b = torch.stack(op.lifted_rhs(*state.grids)).contiguous()
    got = solver.launch(b)
    torch.cuda.synchronize()
    ref = solver.plain(b)
    assert got.iterations == ref.iterations > 0 and got.converged == ref.converged
    assert torch.equal(got.x, ref.x)
    assert _inner_counts_match(solver, b)
    lines = -(-solver.node_shape[0] // 32) if element == "quad" else 0
    assert solver.last_geometry.line_warps == fused_gmres_plan(solver.node_shape, "fieldsplit_ilu").line_warps == lines


ROLES_64 = [  # the preconditioned roles at 2D N=64, where they cost the most
    ("fieldsplit_ilu", 0.0, "literal"),  # K8: the line pipeline on 3 warps, bit for bit
    ("fieldsplit_ilu", 0.0, "pcg"),
    ("fieldsplit_lu", 1e-10, "literal"),  # K6: the cluster's fast-diag transform
    ("ilu", 0.0, "literal"),  # K7: 66 rows a level, the ring
]


@pytest.mark.parametrize("pc,tol,inner", ROLES_64, ids=["k8", "k8-pcg", "k6", "k7"])
def test_preconditioned_gmres_at_quad64(cuda, pc, tol, inner):
    """K6-K8 at 2D N=64 on 16 blocks: equal counts (K8 also its inner block
    solves'), and the shared memory the launcher reports is the Python
    mirror's, in K8's two inner modes alike."""
    state = _state("quad", (64, 64), cuda, seed=8)
    op = DPPOperator(state.W, state.params)
    solver = FusedGMRESSolver(op, pc, rtol=1e-8, atol=1e-12, max_it=5000, inner_ksp=inner)
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
        solver.node_shape, pc, SMEM_BUDGET,
        ilu_shape=None if ilu is None else (len(ilu.lower), len(ilu.upper), ilu.num_levels, ilu.max_level_rows),
        distinct=getattr(solver, "distinct_axes", None),
    )
    assert geo.blocks == 16
    assert (geo.input_smem, geo.p_smem, geo.s_smem, geo.basis_smem) == (
        plan.input_smem, plan.p_smem, plan.s_smem, plan.basis_smem)
    assert geo.line_warps == plan.line_warps  # K8: the line pipeline, no ILU stage
    if plan.ilu is not None:
        assert geo.ilu_z_smem == plan.ilu.z_smem
    if pc == "fieldsplit_ilu":
        assert _inner_counts_match(solver, b)


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


# -- the Picard path: fused_ngs and the ILU sweep's Gauss-Seidel mode --------


def _lifted(element, cells, device, seed=0):
    """(operator, b, x0) of random boundary data on ``device``."""
    rng = np.random.default_rng(seed)
    shape = tuple(c + 1 for c in reversed(cells))
    state = from_numpy_state({"k1": 1.2, "beta": 0.9}, cells, element, rng.standard_normal(shape),
                             rng.standard_normal(shape), device=device)
    op = DPPOperator(state.W, state.params)
    b = torch.stack(op.lifted_rhs(*state.grids)).contiguous()
    bdry = op._mask_arrays[0]
    x0 = torch.stack([torch.where(bdry, g, 0.0) for g in state.grids]).contiguous()
    return op, b, x0


@pytest.mark.parametrize("N", [4, 8, 16, 32, 64, 128])
def test_fused_ngs_matches_twin(cuda, N):
    """One launch on the launcher's block count (1, 1, 2, 8, 16, 16 blocks):
    counts equal to the twin's, x and both norms bit for bit."""
    op, b, x0 = _lifted("quad", (N, N), cuda)
    solver = FusedNGSSolver(op, rtol=1e-8, atol=1e-12, max_it=50000)
    before = _cuda.KERNEL_LAUNCHES[NGS_KERNEL]
    got = solver.launch(b, x0)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[NGS_KERNEL] == before + 1
    ref = solver.plain(b, x0)
    assert got.iterations == ref.iterations > 0
    assert torch.equal(got.x, ref.x)
    assert (got.residual_norm, got.initial_norm) == (ref.residual_norm, ref.initial_norm)
    assert got.residual_norm <= max(1e-8 * got.initial_norm, 1e-12)


@pytest.mark.parametrize("N,blocks", [(32, 1), (32, 2), (32, 4), (64, 4), (128, 4), (128, 8), (255, 16)])
def test_fused_ngs_block_counts_match_twin(cuda, N, blocks):
    """The block counts the launcher's rule does not take, and N=255 (the
    plan's largest mesh with 255 cells a side): the twin's bits at 20
    iterations."""
    op, b, x0 = _lifted("quad", (N, N), cuda)
    solver = FusedNGSSolver(op, rtol=1e-8, atol=1e-12, max_it=20, blocks=blocks)
    assert solver.plan.blocks == blocks
    got = solver.launch(b, x0)
    ref = solver.plain(b, x0)
    assert got.iterations == ref.iterations == 20
    assert torch.equal(got.x, ref.x) and got.residual_norm == ref.residual_norm


@pytest.mark.parametrize("element,cells", [("triangle", (13, 9)), ("hex", (5, 4, 3)), ("tet", (5, 4, 3)), ("tet", (16, 16, 16))])
def test_gs_mode_matches_twin(cuda, element, cells):
    """The ILU sweep's Gauss-Seidel mode against the plain sweep, bit for
    bit (the same products and differences in the same order), with the
    layout ops/ilu.py::ilu_plan gives a stage of every off-centre entry."""
    mesh = StructuredMesh(cells=cells, element=element)
    op, _, _ = _lifted(element, cells, cuda)
    swp = GaussSeidelSweeper.for_monolithic(mesh, op.params, cuda)
    rng = np.random.default_rng(3)
    x, b = (torch.tensor(rng.standard_normal(swp.nrows), device=cuda) for _ in range(2))
    before = _cuda.KERNEL_LAUNCHES[GS_KERNEL]
    z = swp.launch(x, b)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[GS_KERNEL] == before + 1
    assert torch.equal(z, swp.plain(x, b))
    geo, nt = swp.last_geometry, len(swp.offsets)
    plan = ilu_plan(nt, nt, swp.nrows, swp.num_levels, swp.max_level_rows, geo.budget)
    assert (geo.stages, geo.z_smem, geo.bytes) == (plan.stages, plan.z_smem, plan.bytes)


def test_picard_on_the_card_launches_the_kernel_once(cuda):
    """PICARD_LU_SOLVER_PARAMS at 2D N=8 on the manufactured solution: the
    published 63, one launch."""
    mesh = create_mesh(8, 8)
    _, V = create_function_spaces(mesh, device=cuda)
    W = mixed_space(V)
    params = DPPParameters()
    _, p1e, _, p2e = exact_expressions(mesh, params)
    before = _cuda.KERNEL_LAUNCHES[NGS_KERNEL]
    sol = solve_dpp_nonlinear(
        W, params, [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)], sp.PICARD_LU_SOLVER_PARAMS
    )
    assert _cuda.KERNEL_LAUNCHES[NGS_KERNEL] == before + 1
    assert sol.iteration_number == 63
    assert sol.solution.data[0].device == cuda


def test_picard_beyond_the_plan_takes_the_host_loop(cuda, monkeypatch):
    """A mesh the kernel's plan refuses (here every mesh, the plan patched
    away) runs the host loop on the card: K1 residuals, no fused_ngs
    launch, the same published count."""
    from perphil_tpu_torch.ops import fused_ngs
    from perphil_tpu_torch.solvers.solver import _build_nonlinear_solver

    monkeypatch.setattr(fused_ngs, "fused_ngs_plan", lambda node_shape, ncolors, blocks=None: None)
    _build_nonlinear_solver.cache_clear()
    mesh = create_mesh(8, 8)
    _, V = create_function_spaces(mesh, device=cuda)
    W = mixed_space(V)
    params = DPPParameters()
    _, p1e, _, p2e = exact_expressions(mesh, params)
    before = dict(_cuda.KERNEL_LAUNCHES)
    try:
        sol = solve_dpp_nonlinear(
            W, params, [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)], sp.PICARD_LU_SOLVER_PARAMS
        )
    finally:
        _build_nonlinear_solver.cache_clear()
    assert _cuda.KERNEL_LAUNCHES[NGS_KERNEL] == before.get(NGS_KERNEL, 0)
    assert _cuda.KERNEL_LAUNCHES["fused_dpp_apply"] - before.get("fused_dpp_apply", 0) > 63
    assert sol.iteration_number == 63


# (element, cells, blocks, max_it): one placement of each kind, 2D and 3D --
# one block (full solves; hex nx=16 and tet nx=17 at the one-block edge,
# the taps' largest instance), a cluster by the launcher's rule (tri N=128
# and tet nx=24 on 16 blocks) and asked for (tri N=48 on 16, tri N=128 and
# tet nx=24 on 4), capped
FUSED_GS_CASES = [("triangle", (16, 16), None, 50000), ("tet", (4, 4, 4), None, 50000),
                  ("hex", (6, 6, 6), None, 50000), ("hex", (16, 16, 16), None, 3), ("tet", (17, 17, 17), None, 3),
                  ("triangle", (128, 128), None, 10), ("tet", (24, 24, 24), None, 5), ("triangle", (48, 48), 16, 10),
                  ("triangle", (128, 128), 4, 10), ("tet", (24, 24, 24), 4, 5)]

FUSED_GS_REPEATS = 10


@pytest.mark.parametrize("element,cells,blocks,max_it", FUSED_GS_CASES,
                         ids=[f"{c[0]}{c[1][0]}-{c[2] or 'rule'}" for c in FUSED_GS_CASES])
def test_fused_gs_matches_twin(cuda, element, cells, blocks, max_it):
    """One launch a solve on the plan's placement: the count, x and both
    norms bit for bit with FusedGSSolver.plain (the twin's count or the
    cap); then FUSED_GS_REPEATS launches more, each with the same bits."""
    op, b, x0 = _lifted(element, cells, cuda)
    solver = FusedGSSolver(op, rtol=1e-8, atol=1e-12, max_it=max_it, blocks=blocks)
    before = _cuda.KERNEL_LAUNCHES[FUSED_GS_KERNEL]
    got = solver.launch(b, x0)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[FUSED_GS_KERNEL] == before + 1
    assert solver.last_placement[:2] == (solver.plan.blocks, solver.plan.rows)
    ref = solver.plain(b, x0)
    assert got.iterations == ref.iterations > 0 and (max_it == 50000 or got.iterations == max_it)
    assert torch.equal(got.x, ref.x)
    assert (got.residual_norm, got.initial_norm) == (ref.residual_norm, ref.initial_norm)
    # launched again and again, each launch the same bits (a halo wait that
    # hung now and then would trap and fail one)
    for _ in range(FUSED_GS_REPEATS):
        again = solver.launch(b, x0)
        assert torch.equal(again.x, ref.x) and again.iterations == ref.iterations
        assert (again.residual_norm, again.initial_norm) == (ref.residual_norm, ref.initial_norm)


def test_lexicographic_picard_on_the_card_launches_fused_gs_once(cuda):
    """PICARD_LU_SOLVER_PARAMS on a tri N=8 mesh, the option left open (the
    wavefront): one fused_gs launch, no GS-mode sweep, the CPU's count
    (partri, K1 residuals) within the knife edge of the two norms' orders."""
    state = _state("triangle", (8, 8), cuda)
    before = dict(_cuda.KERNEL_LAUNCHES)
    sol = solve_dpp_nonlinear(state.W, state.params, state.bcs, sp.PICARD_LU_SOLVER_PARAMS)
    assert _cuda.KERNEL_LAUNCHES[FUSED_GS_KERNEL] == before.get(FUSED_GS_KERNEL, 0) + 1
    assert _cuda.KERNEL_LAUNCHES[GS_KERNEL] == before.get(GS_KERNEL, 0)
    cpu = _state("triangle", (8, 8), "cpu")
    ref = solve_dpp_nonlinear(cpu.W, cpu.params, cpu.bcs, sp.PICARD_LU_SOLVER_PARAMS)
    assert abs(sol.iteration_number - ref.iteration_number) <= 2


def test_lexicographic_picard_beyond_the_plan_takes_the_host_route(cuda, monkeypatch):
    """A mesh the plan refuses (here every mesh, the plan patched away): one
    GS-mode sweep and K1 residuals an iteration, no fused_gs launch."""
    from perphil_tpu_torch.ops import fused_gs
    from perphil_tpu_torch.solvers.solver import _build_nonlinear_solver

    monkeypatch.setattr(fused_gs, "fused_gs_plan", lambda node_shape, element, blocks=None: None)
    _build_nonlinear_solver.cache_clear()
    state = _state("tet", (4, 4, 4), cuda)
    before = dict(_cuda.KERNEL_LAUNCHES)
    try:
        sol = solve_dpp_nonlinear(state.W, state.params, state.bcs, sp.PICARD_LU_SOLVER_PARAMS)
    finally:
        _build_nonlinear_solver.cache_clear()
    assert _cuda.KERNEL_LAUNCHES[FUSED_GS_KERNEL] == before.get(FUSED_GS_KERNEL, 0)
    assert _cuda.KERNEL_LAUNCHES[GS_KERNEL] - before.get(GS_KERNEL, 0) == sol.iteration_number > 0
    assert _cuda.KERNEL_LAUNCHES["fused_dpp_apply"] - before.get("fused_dpp_apply", 0) > sol.iteration_number


def _parity_factor(nx):
    mesh = StructuredMesh(cells=(nx, nx, nx), element="tet")
    _, perm, Ap = parity_system(mesh, DPPParameters())
    Fc, diag = _native.native_ilu0(Ap)
    return mesh, perm, Fc, diag


# (tet nx, blocks, vector in shared memory; None: the plan's): the plan's
# placements (nx=8, 24, 40), one block with the vector in device memory,
# clusters of 2, 4 and 16 blocks with the vector spread over their shared
# memory or in device memory
BAND_PLACEMENTS = [(8, None, None), (24, None, None), (40, None, None), (8, 1, False), (12, 2, True),
                   (12, 2, False), (12, 4, True), (16, 16, True), (16, 16, False)]


@pytest.mark.parametrize("nx,blocks,shared", BAND_PLACEMENTS,
                         ids=[f"nx{n}-{b or 'plan'}-{'smem' if s else 'l2' if s is False else ''}"
                              for n, b, s in BAND_PLACEMENTS])
def test_band_trisolve_matches_twin(cuda, nx, blocks, shared):
    """The level-scheduled kernel against its twin bit for bit (torch.equal)
    on each placement, one launch, counted; the same bits on a second
    launch (no race between levels)."""
    mesh, perm, Fc, _ = _parity_factor(nx)
    sched = bs.level_schedule(Fc, perm, blocks, shared)
    assert shared is None or (sched.blocks, sched.shared_vector) == (blocks, shared)
    band = bs.build_band_parity_ilu(sched, cuda)
    r = torch.from_numpy(np.random.default_rng(nx).standard_normal(Fc.shape[0])).to(cuda)
    before = _cuda.KERNEL_LAUNCHES[bs.KERNEL]
    z = bs.level_apply(band, r)
    torch.cuda.synchronize()
    assert _cuda.KERNEL_LAUNCHES[bs.KERNEL] == before + 1
    assert torch.equal(z, bs.level_apply_plain(band, r))
    assert torch.equal(z, bs.level_apply(band, r))


def test_band_apply_on_the_card_matches_the_cpu(cuda):
    """The whole parity ILU apply (one launch) against the same apply on the
    CPU (the twin) and the host engine's sequential apply, bit for bit, at
    tet nx=8."""
    from perphil_tpu_torch.ops.ordering import host_ilu_apply

    mesh, perm, Fc, diag = _parity_factor(8)
    sched = bs.level_schedule(Fc, perm)
    r = np.random.default_rng(6).standard_normal((2,) + mesh.node_shape)
    ref = bs.build_band_parity_ilu(sched, "cpu").apply(torch.from_numpy(r))
    before = _cuda.KERNEL_LAUNCHES[bs.KERNEL]
    got = bs.build_band_parity_ilu(sched, cuda).apply(torch.from_numpy(r).to(cuda))
    assert _cuda.KERNEL_LAUNCHES[bs.KERNEL] == before + 1
    assert torch.equal(got.cpu(), ref)
    host = np.empty(r.size)
    host[perm] = host_ilu_apply(Fc, diag, r.ravel()[perm])
    assert np.array_equal(got.cpu().numpy().ravel(), host)


@pytest.mark.parametrize("remote", [False, True], ids=["in-place", "buffers"])
@pytest.mark.parametrize("ms", [(1,), (2,), (4,), (2, 2)])
def test_colour_step_kernel_against_twin(cuda, ms, remote):
    """``ngs_colour_halo``: a sweep of colour steps, one launch a colour over
    every loopback block of 2D N=16 (phantom-padded where the mesh does not
    divide it), the neighbours read in place or through the exchange
    buffers, then the norm kernel with its residuals, bit for bit with the
    twin (the same sweep on the CPU): iterate, residuals and norm."""
    from perphil_tpu_torch.ops.fused_ngs import FN, NORM_KERNEL, NgsSweep
    from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper

    mesh = create_mesh(16, 16)
    shape = mesh.node_shape
    pad = [(-n) % s for n, s in zip(shape, ms)] + [0] * (2 - len(ms))
    grid = tuple(n + p for n, p in zip(shape, pad))
    L = LoopbackBlocks(ms)
    rng = np.random.default_rng(1)
    x, b = (torch.nn.functional.pad(torch.as_tensor(rng.standard_normal((2,) + shape)), [0, pad[1], 0, pad[0]])
            for _ in range(2))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        sweep = NgsSweep(ColoredNGSSweeper(mesh, DPPParameters(), dev), grid, L, remote=remote)
        sweep.reset(0.0, 0.0, 1)
        sweep.load(L.cut(b.to(dev), lead=1), L.cut(x.to(dev), lead=1))
        _cuda.KERNEL_LAUNCHES.clear()
        for k in range(sweep.ncolors):
            sweep.step(k)
        r = {c: torch.empty(sweep.shape, dtype=torch.float64, device=dev) for c in L.coords}
        sweep.norm(init=True, residuals=r)
        out[dev.type] = (L.join(sweep.x).cpu(), L.join(r).cpu(), float(sweep.state[FN]))
        if dev.type == "cuda":
            assert _cuda.KERNEL_LAUNCHES[COLOUR_KERNEL] == sum(int(end > start) for start, _, end in sweep.spans)
            assert _cuda.KERNEL_LAUNCHES[NORM_KERNEL] == 1
    assert torch.equal(out["cuda"][0], out["cpu"][0]) and torch.equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2] == out["cpu"][2]


@pytest.mark.parametrize("every", [1, 3, 16])
@pytest.mark.parametrize("ms", [(1,), (2,), (2, 2)])
def test_blocked_ngs_device_stop(cuda, ms, every):
    """The blocked Picard solve with the norm and stop test on the card
    (``every`` iterations between read-backs; from a CUDA graph) at 2D N=16
    on the manufactured solution: the twin's count (194), norms and iterate
    bit for bit, with both kernels launched."""
    from perphil_tpu_torch.ops.assembly import bc_values_per_field
    from perphil_tpu_torch.ops.fused_ngs import NORM_KERNEL, NgsSweep, blocked_ngs
    from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper

    # the inputs made once, on the CPU (K1 on the card sums the lift in
    # another order than its twin)
    W = mixed_space(create_function_spaces(create_mesh(16, 16), device="cpu")[1])
    _, p1e, _, p2e = exact_expressions(W.mesh, DPPParameters())
    g = torch.stack(bc_values_per_field(W, [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]))
    op = DPPOperator(W, DPPParameters())
    b = torch.stack(op.lifted_rhs(g[0], g[1]))
    x0 = torch.where(op._mask_arrays[0], g, 0.0)
    L = LoopbackBlocks(ms)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        sweep = NgsSweep(ColoredNGSSweeper(W.mesh, DPPParameters(), dev), W.mesh.node_shape, L)
        _cuda.KERNEL_LAUNCHES.clear()
        res = blocked_ngs(sweep, L.cut(b.to(dev), lead=1), L.cut(x0.to(dev), lead=1), 1e-8, 1e-50, 50000,
                          every=every)
        out[dev.type] = (res.iterations, res.residual_norm, res.initial_norm, L.join(res.x).cpu())
        if dev.type == "cuda":
            assert _cuda.KERNEL_LAUNCHES[COLOUR_KERNEL] > 0 and _cuda.KERNEL_LAUNCHES[NORM_KERNEL] > 0
    assert out["cuda"][0] == out["cpu"][0] == 194
    assert out["cuda"][1:3] == out["cpu"][1:3] and torch.equal(out["cuda"][3], out["cpu"][3])
