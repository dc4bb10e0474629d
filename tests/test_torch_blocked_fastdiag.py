"""The sharded path's blocked parts on the CPU, on the blocks of one grid in
one process (``parallel/transpose.py::LoopbackBlocks``): the all-to-all
moves round-trip exactly on slabs and pencils with padded and unpadded
axes; the fast-diag solvers on extended eigenvector matrices against their
whole-grid solves and the JAX package's (``perphil_tpu/ops/direct.py``);
the blocked mixed-precision direct solve against the whole grid; the
coupling and field matvecs of the blocked fieldsplit against
``coupling_apply`` / ``FieldOperator.matvec``; the colour-step twin
(``ops/fused_ngs.py::colour_step_plain``) bit for bit with
``ColoredNGSSweeper`` (the kernel, ``csrc/ngs_colour_halo.cu``, is held
to it on the card in ``tests/test_torch_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import perphil_tpu.mesh.structured as jmesh
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops import direct as jdirect

from perphil_tpu_torch.mesh import create_cube_mesh, create_mesh
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops.assembly import DPPOperator, FieldOperator, bc_values_per_field, coupling_apply
from perphil_tpu_torch.ops.direct import FastDiagDPPSolver, FastDiagFieldSolver, LumpedDPPPreconditioner
from perphil_tpu_torch.ops.fused_ngs import FusedNGSSolver, NgsBlock, NgsSweep, blocked_ngs
from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper
from perphil_tpu_torch.ops.mixed import MixedPrecisionDPPDirect
from perphil_tpu_torch.parallel.halo import COLLECTIVES
from perphil_tpu_torch.parallel.transpose import LoopbackBlocks, Move, layout_index, transform_plan
from perphil_tpu_torch.solvers.solver import _blocked_coupling, _blocked_field_solver, _halo_apply
from perphil_tpu_torch.tools.dryrun import _manufactured_bcs, _space

PARAMS = dict(k1=1.3, beta=0.8, mu=1.1)
# (grid, mesh): slabs and pencils; the destination axes of the moves padded
# (5 on 2 ranks, 7 on 3, ...) and not
LAYOUTS = [
    ((8, 6, 5), (2,)),
    ((8, 6, 5), (2, 2)),
    ((9, 6, 7), (3, 2)),
    ((9, 9), (3,)),
    ((4, 6), (2, 2)),
    ((6, 10), (3, 2)),
    ((7, 5, 4), (1, 1)),
]
# (element, cells, meshes): the fast-diag solves on blocks
FASTDIAG = [
    ("hex", (5, 6, 7), [(), (1, 1), (2,), (3,), (2, 2), (3, 2)]),
    ("quad", (9, 6), [(), (1,), (2,), (2, 2), (3, 4)]),
]
LUMPED = [("tet", (4, 5, 3), [(), (2,), (2, 2)]), ("triangle", (7, 8), [(), (3,), (2, 2)])]
NGS = [(7, [(1,), (2,), (4,), (2, 2), (4, 2), (1, 1)]), (12, [(2,), (4,), (2, 2)]), (15, [(4,), (2, 2)])]


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _padding(shape, mesh_shape):
    return tuple([(-n) % s for n, s in zip(shape, mesh_shape)] + [0] * (len(shape) - len(mesh_shape)))


def _pad(x: torch.Tensor, padding, lead: int = 1) -> torch.Tensor:
    return F.pad(x, [v for p in reversed(padding) for v in (0, p)]) if any(padding) else x


def test_transform_plan_hand_worked():
    """The moves of a transform: 3D pencils contract x, move the y split to
    x, contract y, move the z split to y, contract z; 2D pencils need a
    third move (x's split goes to y, which is not yet contracted); slabs
    one; a mesh of none, no move."""
    steps, splits = transform_plan((9, 8, 8), (2, 2))
    assert steps == [("contract", 2), Move(1, 1, 2, 8, 8), ("contract", 1), Move(0, 0, 1, 9, 8), ("contract", 0)]
    assert splits == [[], [(0, 8)], [(1, 8)]]
    steps, _ = transform_plan((6, 10), (3, 2))
    assert steps == [Move(1, 1, 0, 10, 2), ("contract", 1), Move(1, 0, 1, 2, 10), Move(0, 0, 1, 6, 5),
                     ("contract", 0)]
    assert transform_plan((8, 6, 5), (2,))[0] == [("contract", 2), ("contract", 1), Move(0, 0, 1, 8, 6),
                                                  ("contract", 0)]
    assert transform_plan((5, 4), ())[0] == [("contract", 1), ("contract", 0)]


@pytest.mark.parametrize("grid,mesh_shape", LAYOUTS, ids=[f"{g}-{m}" for g, m in LAYOUTS])
@pytest.mark.parametrize("lead", [0, 1])
def test_loopback_moves_round_trip(grid, mesh_shape, lead):
    """A transform's moves take every block to the layout ``layout_index``
    says (zeros where the layout pads), one all-to-all a move, and their
    inverses, in reverse, give the blocks back bit for bit."""
    rng = np.random.default_rng(len(grid) * 10 + len(mesh_shape))
    x = torch.as_tensor(rng.standard_normal((2,) * lead + grid))
    L = LoopbackBlocks(mesh_shape)
    blocks = L.cut(x, lead=lead)
    steps, splits = transform_plan(grid, mesh_shape)
    moves = [s for s in steps if isinstance(s, Move)]
    COLLECTIVES.clear()
    moved = blocks
    for m in moves:
        moved = L.regrid(moved, m, lead)
    assert COLLECTIVES["all_to_all"] == len(moves)
    padded = F.pad(x, [0, 1] * len(grid))  # index -1 reads the zero past the end
    for c, b in moved.items():
        want = padded[(slice(None),) * lead + np.ix_(*layout_index(grid, splits, c, mesh_shape))]
        assert torch.equal(b, want)
    back = moved
    for m in reversed(moves):
        back = L.regrid(back, m.inverse(), lead)
    assert all(torch.equal(back[c], blocks[c]) for c in blocks)
    assert torch.equal(L.join(back, lead=lead), x)


def _jax_mesh(element, cells):
    return jmesh.StructuredMesh(cells=cells, element=element)


@pytest.mark.parametrize("element,cells,meshes", FASTDIAG, ids=[e for e, _, _ in FASTDIAG])
def test_blocked_fastdiag_equals_whole_and_jax(element, cells, meshes):
    """``FastDiagDPPSolver.solve_blocks`` and ``FastDiagFieldSolver.
    solve_blocks`` on the extended matrices (one block, ``()``: the
    single-device form) and over loopback slabs and pencils of the padded
    grid: the whole-grid ``solve`` within 1e-14 and the JAX package's
    solvers within 1e-13 on the physical grid; boundary and phantom rows
    pass ``b`` through."""
    mesh = StructuredMesh(cells=cells, element=element)
    p = DPPParameters(**PARAMS)
    shape = mesh.node_shape
    b = torch.as_tensor(np.random.default_rng(3).standard_normal((2,) + shape))
    dpp = FastDiagDPPSolver(mesh, p, device="cpu")
    fs = FastDiagFieldSolver(mesh, p.k1, p.beta, p.mu, device="cpu")
    whole = torch.stack(dpp.solve(b[0], b[1]))
    whole_f = fs.solve(b[0])
    jm = _jax_mesh(element, cells)
    jw = np.stack([np.asarray(a) for a in jdirect.FastDiagDPPSolver(jm, JParams(**PARAMS)).solve(jnp.asarray(b[0].numpy()),
                                                                                                  jnp.asarray(b[1].numpy()))])
    jf = np.asarray(jdirect.FastDiagFieldSolver(jm, p.k1, p.beta, p.mu).solve(jnp.asarray(b[0].numpy())))
    for ms in meshes:
        pad = _padding(shape, ms)
        bp = _pad(b, pad)
        L = LoopbackBlocks(ms)
        z = L.join(dpp.solve_blocks(L.cut(bp, lead=1), L, pad))
        zf = L.join(fs.solve_blocks(L.cut(bp[0]), L, pad), lead=0)
        crop = tuple(slice(0, n) for n in shape)
        assert _rel(z[(slice(None),) + crop], whole) <= 1e-14 and _rel(zf[crop], whole_f) <= 1e-14
        assert _rel(z[(slice(None),) + crop], jw) <= 1e-13 and _rel(zf[crop], jf) <= 1e-13
        outside = torch.ones(bp.shape[1:], dtype=torch.bool)
        outside[crop] = False
        assert torch.equal(z[:, outside], bp[:, outside]) and torch.equal(zf[outside], bp[0][outside])


@pytest.mark.parametrize("element,cells,meshes", LUMPED, ids=[e for e, _, _ in LUMPED])
def test_blocked_lumped_pc_equals_whole_and_jax(element, cells, meshes):
    """The simplicial direct solves' lumped fast-diag preconditioner on
    blocks (both fields on shared transforms): the whole grid's within
    1e-14 and the JAX package's (its two lumped field solvers, as its
    ``_monolithic_direct`` builds them) within 1e-13."""
    mesh = StructuredMesh(cells=cells, element=element)
    p = DPPParameters(**PARAMS)
    shape = mesh.node_shape
    r = torch.as_tensor(np.random.default_rng(4).standard_normal((2,) + shape))
    pc = LumpedDPPPreconditioner(mesh, p, device="cpu")
    whole = pc(r)
    jm = _jax_mesh(element, cells)
    jw = np.stack([np.asarray(jdirect.FastDiagFieldSolver(jm, k, p.beta, p.mu, lumped=True).solve(jnp.asarray(v)))
                   for k, v in ((p.k1, r[0].numpy()), (p.k2, r[1].numpy()))])
    for ms in meshes:
        pad = _padding(shape, ms)
        L = LoopbackBlocks(ms)
        z = L.join(pc.solve_blocks(L.cut(_pad(r, pad), lead=1), L, pad))
        crop = (slice(None),) + tuple(slice(0, n) for n in shape)
        assert _rel(z[crop], whole) <= 1e-14 and _rel(z[crop], jw) <= 1e-13


@pytest.mark.parametrize("element,n,meshes", [("hex", 9, [(2,), (2, 2), (3, 2)]), ("quad", 30, [(4,), (2, 2)])],
                         ids=["hex", "quad"])
def test_blocked_mixed_direct_equals_whole(element, n, meshes):
    """``MixedPrecisionDPPDirect.solve_blocks`` over loopback slabs and
    pencils of the padded grid: the whole-grid solve within 1e-12, f64
    relative residual below 1e-10, every scalar of the refinement reduced
    over the blocks."""
    mesh = create_cube_mesh(n, n, n, hexahedral=True) if element == "hex" else create_mesh(n, n)
    p = DPPParameters()
    shape = mesh.node_shape
    b = torch.as_tensor(np.random.default_rng(5).standard_normal((2,) + shape))
    whole = torch.stack(MixedPrecisionDPPDirect(mesh, p, device="cpu").solve(b[0], b[1]))
    W = _space(element, n, 1, "cpu")
    op = DPPOperator(W, p)
    for ms in meshes:
        pad = _padding(shape, ms)
        L = LoopbackBlocks(ms)
        z = L.join(MixedPrecisionDPPDirect(mesh, p, device="cpu", padding=pad).solve_blocks(
            L.cut(_pad(b, pad), lead=1), L))
        crop = (slice(None),) + tuple(slice(0, m) for m in shape)
        assert _rel(z[crop], whole) <= 1e-12
        res = b - torch.stack(op.matvec(z[crop][0].contiguous(), z[crop][1].contiguous()))
        assert float(res.norm() / b.norm()) < 1e-10


def test_mixed_solve_builds_its_block_data_once():
    """``MixedPrecisionDPPDirect.solve`` (the blocked route on one block)
    builds the fast-diag's block data (extended matrices, mode data) on its
    first call and reuses them: a second solve adds and replaces nothing."""
    mesh = create_cube_mesh(5, 5, 5, hexahedral=True)
    m = MixedPrecisionDPPDirect(mesh, DPPParameters(), device="cpu")
    b = torch.as_tensor(np.random.default_rng(6).standard_normal((2,) + mesh.node_shape))
    first = torch.stack(m.solve(b[0], b[1]))
    built = dict(m.whole.memo)
    assert built
    assert torch.equal(torch.stack(m.solve(b[0], b[1])), first)
    assert m.whole.memo.keys() == built.keys() and all(m.whole.memo[k] is v for k, v in built.items())


@pytest.mark.parametrize("element,n", [("quad", 9), ("hex", 5), ("triangle", 9)])
def test_blocked_coupling_and_field_matvec(element, n):
    """The blocked fieldsplit's coupling ``C y`` (K1's halo form on
    ``(0, y)``) equals ``coupling_apply`` within 1e-15 relative (``(c M) y``
    against ``c (M y)``: one rounding apart), and its field matvec (K1's
    halo form with the other field zero) ``FieldOperator.matvec`` within
    1e-15, on the whole grid as one block."""
    W = _space(element, n, 1, "cpu")
    p = DPPParameters(**PARAMS)
    op = DPPOperator(W, p)
    y = torch.as_tensor(np.random.default_rng(6).standard_normal(W.mesh.node_shape))
    L = LoopbackBlocks(())
    assert _rel(_blocked_coupling(op, L)(y), coupling_apply(W.mesh, p, "cpu")(y)) <= 1e-15
    zero = torch.zeros_like(y)
    for i, k in ((0, p.k1), (1, p.k2)):
        fop = FieldOperator(W.sub(i), k, p.beta, p.mu)
        got = _halo_apply(op, L)(torch.stack([y, zero] if i == 0 else [zero, y]))[i]
        assert _rel(got, fop.matvec(y)) <= 1e-15
    # an exact block solve on blocks is the field's fast-diag solve
    if W.mesh.is_tensor_product:
        solve = _blocked_field_solver(op, 0, {"ksp_type": "preonly", "pc_type": "lu"})(L)
        assert _rel(solve(y), FastDiagFieldSolver(W.mesh, p.k1, p.beta, p.mu, device="cpu").solve(y)) <= 1e-14


@pytest.mark.parametrize("n,meshes", NGS, ids=[f"N={n}" for n, _ in NGS])
def test_colour_steps_bit_for_bit(n, meshes):
    """A whole sweep of colour steps over loopback slabs and pencils (a
    plane exchange before every colour; phantom-padded where the mesh does
    not divide the grid) equals ``ColoredNGSSweeper.sweep_stacked`` bit for
    bit, the residual mode ``residual`` bit for bit, and phantom rows stay
    as they were."""
    mesh = create_mesh(n, n)
    sw = ColoredNGSSweeper(mesh, DPPParameters(), "cpu")
    shape = mesh.node_shape
    rng = np.random.default_rng(n)
    x, b = (torch.as_tensor(rng.standard_normal((2,) + shape)) for _ in range(2))
    want, want_r = sw.sweep_stacked(x.clone(), b), sw.residual(x, b)
    for ms in meshes:
        pad = _padding(shape, ms)
        grid = tuple(m + q for m, q in zip(shape, pad))
        L = LoopbackBlocks(ms)
        parts = {c: NgsBlock(sw, grid, ms, c) for c in L.coords}
        xp, bp = _pad(x, pad), _pad(b, pad)
        xs, bs = L.cut(xp, lead=1), L.cut(bp, lead=1)
        planes = L.planes(xs)
        r = L.join({c: parts[c].residual(xs[c], bs[c], planes[c]) for c in L.coords})
        for k in range(sw.ncolors):
            planes = L.planes(xs)
            xs = {c: parts[c].step(xs[c], bs[c], planes[c], k) for c in L.coords}
        got = L.join(xs)
        crop = (slice(None),) + tuple(slice(0, m) for m in shape)
        assert torch.equal(got[crop], want) and torch.equal(r[crop], want_r), ms
        outside = torch.ones(grid, dtype=torch.bool)
        outside[crop[1:]] = False
        assert torch.equal(got[:, outside], xp[:, outside])


def test_blocked_ngs_loop_equals_single_device():
    """The blocked Picard loop (``blocked_ngs`` on a ``NgsSweep``: the
    iterations issued in batches between read-backs of the stop state) over
    loopback slabs and pencils at 2D N=7 on the manufactured solution: the
    single-device twin's 49 iterations and its iterate bit for bit (the
    norm, the blocks' tree sums added, may differ in its last bits)."""
    n = 7
    W = _space("quad", n, 1, "cpu")
    op = DPPOperator(W, DPPParameters())
    sw = ColoredNGSSweeper(W.mesh, DPPParameters(), "cpu")
    g = torch.stack(bc_values_per_field(W, _manufactured_bcs(W)))
    bdry = op._mask_arrays[0]
    b = torch.stack(op.lifted_rhs(g[0], g[1]))
    x0 = torch.where(bdry, g, 0.0)
    ref = FusedNGSSolver(op, sw, 1e-8, 1e-12, 50000).plain(b, x0)
    for ms in [(2,), (2, 2)]:
        L = LoopbackBlocks(ms)
        sweep = NgsSweep(sw, W.mesh.node_shape, L)
        res = blocked_ngs(sweep, L.cut(b, lead=1), L.cut(x0, lead=1), 1e-8, 1e-12, 50000)
        assert res.iterations == ref.iterations == 49
        assert torch.equal(L.join(res.x), ref.x)
        assert abs(res.residual_norm - ref.residual_norm) <= 1e-14 * ref.initial_norm
