"""The degree-p parts of the sharded path on the CPU, on the blocks of one
lattice in one process (``parallel/transpose.py::LoopbackBlocks``, (4,)
slabs and (2, 2) pencils, phantom-padded and divisible lattices):

- the plane exchange of width w (``parallel/halo.py``): every block's box
  is the zero-extended lattice's slice, corners included;
- the Qp operator on blocks (``ops/tensorfem.py::TensorDPPOperator.
  apply_blocks`` / ``mass_blocks``, degree 2 and 3 in 2D, degree 2 on hex):
  the matvec, the lift and M within 1e-13 relative of the whole grid's, and
  the matvec within 1e-13 of the JAX package's padded operator;
- the Qp solves on blocks (the fast-diag direct solve, the multiplicative
  fieldsplit with exact blocks, Jacobi) and the P2 GMRES solves (none,
  Jacobi), GMRES over the joined blocks (``tools/dryrun.py::loopback_solve``,
  the program's ``_run_parts`` on a ``JoinedBlocks``): within 1e-12 of the
  single-device solve, with its count; a second solve builds nothing;
- the P2 operator on blocks (``ops/simplexfem.py::P2SimplexDPPOperator.
  apply_blocks``, tri and tet): the matvec and the lift bit for bit the
  whole lattice's, blocks at odd global offsets included;
- a block thinner than the halo raises ``ValueError`` in the blocked
  operator, and the solver's parts run such a mesh gathered instead
  (``parallel/halo.py::halo_fits``): the whole grid's count and fields, one
  all-gather an application;
- ``tools/degree_p_walls.py``'s rows and operator counts run on the CPU;
- on a world of one rank, ``sharded_solve_dpp`` is ``solve_dpp`` bit for
  bit and issues no collective.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.ops.tensorfem as jtf
from perphil_tpu.models.dpp import DPPParameters as JParams

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops.simplexfem import P2SimplexDPPOperator
from perphil_tpu_torch.ops.tensorfem import TensorDPPOperator
from perphil_tpu_torch.parallel.halo import COLLECTIVES
from perphil_tpu_torch.parallel.sharding import blocked_solve_dpp, device_mesh, mesh_padding, sharded_solve_dpp
from perphil_tpu_torch.parallel.transpose import LoopbackBlocks, block_slices
from perphil_tpu_torch.solvers import solve_dpp
from perphil_tpu_torch.solvers.solver import _freeze, _linear_parts
from perphil_tpu_torch.tools.dryrun import _manufactured_bcs, _space, loopback_solve

PARAMS = dict(k1=1.3, beta=0.8, mu=1.1)
MESHES = {"slabs": (4,), "pencils": (2, 2)}
# the blocked Qp operator's tolerance against the whole grid's and the JAX
# package's (the band contractions sum in another order than the whole
# factors'), and the blocked Qp solves' against the single-device solve
OP_TOL, SOLVE_TOL = 1e-13, 1e-12
# (element, cells, degree): the lattice per grid axis is degree * cells + 1,
# slowest axis first; padded on both meshes unless noted
QP = {
    "q2-quad": ("quad", (7, 5), 2),          # 11 x 15: padded on both meshes
    "q3-quad-divisible": ("quad", (5, 5), 3),  # 16 x 16: divisible on both
    "q3-quad": ("quad", (6, 4), 3),          # 13 x 19
    "q2-hex": ("hex", (3, 4, 5), 2),         # 11 x 9 x 7
}
# Q2 lattices are odd: they divide evenly on meshes of their own, case ->
# ((element, cells, degree), mesh)
DIVISIBLE = {"q2-quad-slabs3": (("quad", (7, 7), 2), (3,)),      # 15 x 15 on 3 slabs
             "q2-hex-pencils35": (("hex", (2, 7, 7), 2), (3, 5))}  # 15 x 15 x 5 on 3 x 5 pencils
# (element, cells): P2 lattices 2 * cells + 1
# (cells chosen so that slabs and pencils both have a block at an odd offset)
P2 = {"tri": ("triangle", (8, 8)), "tri-wide": ("triangle", (11, 8)), "tet": ("tet", (4, 4, 4)),
      "tet-flat": ("tet", (5, 3, 4))}
FS_Q2 = {"ksp_type": "gmres", "pc_type": "fieldsplit", "ksp_rtol": 1e-10}
QP_SOLVES = {
    "direct": {"ksp_type": "preonly", "pc_type": "lu"},
    "fieldsplit": FS_Q2,
    "jacobi": {"ksp_type": "gmres", "pc_type": "jacobi", "ksp_rtol": 1e-10},
}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _padding(shape, mesh_shape):
    return tuple([(-n) % s for n, s in zip(shape, mesh_shape)] + [0] * (len(shape) - len(mesh_shape)))


def _pad(x: torch.Tensor, padding) -> torch.Tensor:
    return F.pad(x, [v for p in reversed(padding) for v in (0, p)]) if any(padding) else x


def _random(shape, padding, seed: int) -> torch.Tensor:
    """Stacked random fields on the lattice, zero on the phantoms."""
    x = np.random.default_rng(seed).standard_normal((2,) + tuple(shape))
    return _pad(torch.as_tensor(x), padding)


def _qp_cases():
    for key, (element, cells, degree) in QP.items():
        for name, mesh_shape in MESHES.items():
            yield pytest.param(element, cells, degree, mesh_shape, id=f"{key}-{name}")
    for key, ((element, cells, degree), mesh_shape) in DIVISIBLE.items():
        yield pytest.param(element, cells, degree, mesh_shape, id=key)


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("grid,mesh_shape", [((12, 9), (4,)), ((8, 10), (2, 2)), ((9, 8, 7), (3, 2)),
                                             ((6, 9, 5), (2,))])
def test_boxes_are_the_lattice_slices(grid, mesh_shape, w):
    """``_Blocks.boxes``: every block extended by w planes a side along the
    split axes, from its neighbours (edge and corner rows through the
    earlier axes' planes) and zeros past the lattice's edges: the slice of
    the zero-extended lattice around the block."""
    x = torch.as_tensor(np.random.default_rng(w).standard_normal((2,) + grid))
    L = LoopbackBlocks(mesh_shape)
    ext = F.pad(x, [v for a in reversed(range(len(grid))) for v in ((w, w) if a < len(mesh_shape) else (0, 0))])
    for c, box in L.boxes(L.cut(x, lead=1), w).items():
        sl = block_slices(grid, mesh_shape, c)
        want = ext[(slice(None),) + tuple(slice(s.start, s.stop + 2 * w) if a < len(mesh_shape) else s
                                          for a, s in enumerate(sl))]
        assert torch.equal(box, want)


@pytest.mark.parametrize("element,cells,degree,mesh_shape", list(_qp_cases()))
def test_blocked_qp_operator(element, cells, degree, mesh_shape):
    """The Qp matvec, lift and boundary-masked mass on blocks, joined: within
    1e-13 relative of the whole padded lattice's (phantom rows included),
    the matvec also of the JAX package's padded operator."""
    mesh = StructuredMesh(cells=cells, element=element)
    whole = TensorDPPOperator(mesh, DPPParameters(**PARAMS), degree, device="cpu")
    pad = _padding(whole.phys_shape, mesh_shape)
    op = TensorDPPOperator(mesh, DPPParameters(**PARAMS), degree, pad, device="cpu")
    x = _random(whole.phys_shape, pad, degree)
    L = LoopbackBlocks(mesh_shape)
    xs = L.cut(x, lead=1)
    for mode in ("matvec", "lift"):
        got = L.join(op.apply_blocks(xs, L, mode))
        want = torch.stack(op.matvec(x[0], x[1]) if mode == "matvec" else op.lifted_rhs(x[0], x[1]))
        assert _rel(got, want) <= OP_TOL
    bdry = op._bdry
    got = L.join(op.mass_blocks({c: v[0] for c, v in xs.items()}, L), lead=0)
    assert _rel(got, op._M(torch.where(bdry, 0.0, x[0]), op._grid_mats)) <= OP_TOL
    jm = jmesh.StructuredMesh(cells=cells, element=element)
    jop = jtf.TensorDPPOperator(jm, JParams(**PARAMS), degree, pad)
    jy = np.stack([np.asarray(a) for a in jop.matvec(jnp.asarray(x[0].numpy()), jnp.asarray(x[1].numpy()))])
    assert _rel(L.join(op.apply_blocks(xs, L, "matvec")), jy) <= OP_TOL


@pytest.mark.parametrize("mesh_shape", list(MESHES.values()), ids=list(MESHES))
@pytest.mark.parametrize("solve", list(QP_SOLVES))
@pytest.mark.parametrize("element,n,degree", [("quad", 7, 2), ("quad", 5, 3), ("hex", 3, 2)])
def test_blocked_qp_solves(element, n, degree, solve, mesh_shape):
    """The Qp direct, fieldsplit and Jacobi solves with every part on the
    loopback blocks of the padded lattice (``tools/dryrun.py::
    loopback_solve``): the single-device solve's count, the fields within
    1e-12 relative."""
    W = _space(element, n, degree, "cpu")
    options = QP_SOLVES[solve]
    z, its, _, _ = loopback_solve(W, DPPParameters(), _manufactured_bcs(W), mesh_shape, options)
    single = solve_dpp(W, DPPParameters(), _manufactured_bcs(W), solver_parameters=options)
    assert its == single.iteration_number
    assert _rel(z, torch.stack(single.solution.data)) <= SOLVE_TOL


@pytest.mark.parametrize("mesh_shape", list(MESHES.values()), ids=list(MESHES))
@pytest.mark.parametrize("pc", ["jacobi", "none"])
@pytest.mark.parametrize("element,n", [("triangle", 8), ("tet", 4)])
def test_blocked_p2_solves(element, n, pc, mesh_shape):
    """The P2 GMRES solves with the operator, the lift and Jacobi on the
    loopback blocks of the padded lattice: the single-device solve's count,
    the fields within 1e-12 relative (the phantom rows lengthen the
    Krylov loop's sums, so the bits may differ)."""
    W = _space(element, n, 2, "cpu")
    options = {"ksp_type": "gmres", "pc_type": pc, "ksp_rtol": 1e-8}
    z, its, _, _ = loopback_solve(W, DPPParameters(), _manufactured_bcs(W), mesh_shape, options)
    single = solve_dpp(W, DPPParameters(), _manufactured_bcs(W), solver_parameters=options)
    assert its == single.iteration_number
    assert _rel(z, torch.stack(single.solution.data)) <= SOLVE_TOL


@pytest.mark.parametrize("element,n,degree,solve", [("quad", 7, 2, "fieldsplit"), ("hex", 3, 2, "direct"),
                                                    ("triangle", 8, 2, "jacobi")])
def test_loopback_solve_builds_its_parts_once(element, n, degree, solve):
    """``loopback_solve`` keeps one blocks object a mesh: a second solve
    builds no block data (bands, stencils, transforms, the parts' tensor
    functions) and returns the first solve's bits."""
    from perphil_tpu_torch.tools.dryrun import joined_blocks

    W = _space(element, n, degree, "cpu")
    options = QP_SOLVES[solve]
    first = loopback_solve(W, DPPParameters(), _manufactured_bcs(W), (2, 2), options)
    memo = dict(joined_blocks((2, 2), W.mesh.dim).memo)
    assert any(k[0] == "operator" for k in memo)  # the solve ran on these blocks
    second = loopback_solve(W, DPPParameters(), _manufactured_bcs(W), (2, 2), options)
    after = joined_blocks((2, 2), W.mesh.dim).memo
    assert after.keys() == memo.keys() and all(after[k] is v for k, v in memo.items())
    assert torch.equal(first[0], second[0]) and first[1] == second[1]


@pytest.mark.parametrize("mesh_shape", list(MESHES.values()) + [(3,), (1, 1)], ids=list(MESHES) + ["slabs3", "ones"])
@pytest.mark.parametrize("key", list(P2))
def test_blocked_p2_operator_bit_for_bit(key, mesh_shape):
    """The P2 matvec and lift on blocks, joined, equal the whole padded
    lattice's bit for bit: each block reads the whole lattice's weight
    fields (the parities of its global indices), some of them from an odd
    global offset."""
    element, cells = P2[key]
    mesh = StructuredMesh(cells=cells, element=element)
    shape = P2SimplexDPPOperator(mesh, DPPParameters(**PARAMS), device="cpu").dof_shape
    pad = _padding(shape, mesh_shape)
    op = P2SimplexDPPOperator(mesh, DPPParameters(**PARAMS), pad if any(pad) else (), device="cpu")
    x = _random(shape, pad, len(cells))
    L = LoopbackBlocks(mesh_shape)
    offsets = [o for c in L.coords for o in L.offsets(op.dof_shape, c)]
    if mesh_shape in MESHES.values():
        assert any(o % 2 for o in offsets), offsets
    xs = L.cut(x, lead=1)
    assert torch.equal(L.join(op.apply_blocks(xs, L, "matvec")), torch.stack(op.matvec(x[0], x[1])))
    assert torch.equal(L.join(op.apply_blocks(xs, L, "lift")), torch.stack(op.lifted_rhs(x[0], x[1])))


@pytest.mark.parametrize("element,n,degree,mesh_shape,axis", [
    ("quad", 2, 3, (4,), 0),      # a 7-node lattice on 4 slabs: blocks of 2 planes, Q3 reads 3
    ("hex", 1, 3, (2, 2), 0),     # 4 nodes an axis on 2 x 2 pencils: blocks of 2 planes
    ("triangle", 1, 2, (4,), 0),  # P2 on 3 nodes: blocks of 1 plane, P2 reads 2
])
def test_thin_block_raises(element, n, degree, mesh_shape, axis):
    """A block thinner than the halo its operator reads raises
    ``ValueError`` naming the grid, the mesh and the smallest N that
    divides evenly, where the JAX package's partitioner would gather."""
    W = _space(element, n, degree, "cpu")
    parts = _linear_parts(W, DPPParameters(), _freeze({"ksp_type": "gmres", "pc_type": "jacobi"}),
                          _padding(W.spaces[0].dof_mesh.node_shape, mesh_shape))
    L = LoopbackBlocks(mesh_shape)
    x = L.cut(torch.zeros((2,) + parts.op.dof_shape), lead=1)
    with pytest.raises(ValueError, match=r"grid \(.*\) on mesh \(.*\).*thinner.*N=\d+") as err:
        parts.op.apply_blocks(x, L, "matvec")
    assert f"grid axis {axis}" in str(err.value)


def test_thin_block_names_the_smallest_divisible_n():
    """The smallest N: Q3 on 4 slabs needs 3N + 1 divisible by 4 with blocks
    of 3 planes (N=5, 16 nodes); Q2's odd lattice never divides by 4, so
    the message names the smallest N whose padded blocks hold 2 planes
    (N=2: 5 nodes padded to 8)."""
    from perphil_tpu_torch.parallel.halo import check_halo_width

    with pytest.raises(ValueError, match="divides evenly into blocks of 3 planes is N=5 "):
        check_halo_width((7, 7), (4,), 3)
    with pytest.raises(ValueError, match="no N divides evenly; the smallest whose padded blocks hold 2 planes is N=2 "):
        check_halo_width((4, 4), (4,), 2)


THIN = {  # the thin meshes of test_thin_block_raises: (element, n, degree, mesh_shape)
    "q3-slabs": ("quad", 2, 3, (4,)),
    "q3-hex-pencils": ("hex", 1, 3, (2, 2)),
    "p2-slabs": ("triangle", 1, 2, (4,)),
}
THIN_SOLVES = {
    "jacobi": {"ksp_type": "gmres", "pc_type": "jacobi", "ksp_rtol": 1e-10},
    "direct": {"ksp_type": "preonly", "pc_type": "lu"},
    "fieldsplit": FS_Q2,
}


def test_halo_fits_is_the_check():
    """``halo_fits`` holds exactly where ``check_halo_width`` passes: every
    block along every split axis at least ``w`` planes."""
    from perphil_tpu_torch.parallel.halo import check_halo_width, halo_fits

    for grid, mesh_shape, w in [((7, 7), (4,), 3), ((8, 8), (4,), 2), ((16, 16), (4,), 3), ((4, 4, 4), (2, 2), 3),
                                ((4, 4, 4), (2, 2), 2), ((5, 8), (1, 4), 2), ((3, 3), (4,), 2)]:
        fits = halo_fits(grid, mesh_shape, w)
        assert fits == all(g // m >= w for g, m in zip(grid, mesh_shape))
        if fits:
            check_halo_width(grid, mesh_shape, w)
        else:
            with pytest.raises(ValueError):
                check_halo_width(grid, mesh_shape, w)


THIN_CASES = [(key, solve) for key in THIN for solve in THIN_SOLVES if THIN[key][0] != "triangle" or solve == "jacobi"]


@pytest.mark.parametrize("key,solve", THIN_CASES, ids=[f"{k}-{s}" for k, s in THIN_CASES])
def test_thin_blocks_solve_gathered(key, solve):
    """The thin meshes of ``test_thin_block_raises`` through the solver's
    parts on the loopback blocks (``loopback_solve``): the whole grid's
    count, the fields within 1e-12, and every part (the matvec, the lift,
    the preconditioner or direct solve) one all-gather an application and
    no plane exchange, as the JAX package's partitioner gathers them. (P2
    takes GMRES with Jacobi: its preonly + lu is refused sharded.)"""
    element, n, degree, mesh_shape = THIN[key]
    options = THIN_SOLVES[solve]
    W = _space(element, n, degree, "cpu")
    z, its, _, parts = loopback_solve(W, DPPParameters(), _manufactured_bcs(W), mesh_shape, options)
    single = solve_dpp(W, DPPParameters(), _manufactured_bcs(W), solver_parameters=options)
    assert its == single.iteration_number
    assert _rel(z, torch.stack(single.solution.data)) <= SOLVE_TOL
    v = torch.ones((2,) + _linear_shape(W, mesh_shape), dtype=torch.float64)
    for name in ("matvec", "lift", "pc"):
        COLLECTIVES.clear()
        parts[name](v)
        assert {k: c for k, c in COLLECTIVES.items() if c} == {"all_gather": 1}, (name, dict(COLLECTIVES))


def _linear_shape(W, mesh_shape):
    """The padded lattice a loopback solve of ``W`` on ``mesh_shape`` runs on."""
    dof = W.spaces[0].dof_mesh.node_shape
    return tuple(n + p for n, p in zip(dof, _padding(dof, mesh_shape)))


WORLD_OF_ONE = {
    "q1-direct": ("quad", 8, 1, sp.LINEAR_SOLVER_PARAMS),
    "q1-direct-hex": ("hex", 5, 1, sp.TPU_DIRECT_PARAMS),
    "plain-gmres": ("quad", 8, 1, sp.PLAIN_GMRES_PARAMS),
    "ss-gmres": ("quad", 8, 1, {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS, "ksp_rtol": 1e-8}),
    "q2-fieldsplit": ("quad", 6, 2, FS_Q2),
}


@pytest.mark.parametrize("key", list(WORLD_OF_ONE))
def test_world_of_one_is_the_single_device_solve(key):
    """On a one-rank mesh ``sharded_solve_dpp`` returns ``solve_dpp``'s
    solution, count and residual bit for bit and issues no collective
    (``linear_on_one_rank_whole``); the blocked route stays callable there
    and lands the same count, its fields within 1e-12."""
    element, n, degree, options = WORLD_OF_ONE[key]
    W = _space(element, n, degree, "cpu")
    bcs = _manufactured_bcs(W)
    dm = device_mesh([1, 1], ("z", "y") if element == "hex" else ("y", "x"), device="cpu")
    single = solve_dpp(W, DPPParameters(), bcs, solver_parameters=options)
    COLLECTIVES.clear()
    got = sharded_solve_dpp(W, DPPParameters(), bcs, dm, solver_parameters=options)
    assert not any(COLLECTIVES.values()), dict(COLLECTIVES)
    assert got.iteration_number == single.iteration_number and got.residual_error == single.residual_error
    assert all(torch.equal(a, b) for a, b in zip(got.solution.data, single.solution.data))
    assert mesh_padding(W.spaces[0].dof_mesh.node_shape, dm) == (0,) * W.mesh.dim
    blocked = blocked_solve_dpp(W, DPPParameters(), bcs, dm, solver_parameters=options)
    assert blocked.iteration_number == single.iteration_number
    assert all(_rel(a, b) <= 1e-12 for a, b in zip(blocked.solution.data, single.solution.data))


@pytest.mark.parametrize("element,solve", [("triangle", "matvec"), ("triangle", "jacobi-1e-8"), ("quad", "direct"),
                                           ("quad", "fieldsplit-1e-8")])
def test_degree_p_walls_rows_run_on_the_cpu(element, solve, tmp_path, monkeypatch):
    """``tools/degree_p_walls.py`` on the CPU at N=4, against a renamed
    copy of this tree loaded beside it (``--against``): both packages
    dispatch the same operators a warm call, the same on a second count,
    and the timed row is finite in both with the solve's count."""
    import sys
    from pathlib import Path

    from perphil_tpu_torch.tools import degree_p_walls as walls

    monkeypatch.setattr(sys, "path", list(sys.path))
    walls.load_against(str(Path(walls.__file__).resolve().parents[2]), str(tmp_path))
    cpu, pkgs = torch.device("cpu"), [walls.HERE, walls.AGAINST]
    counts = [walls.count_ops(pkg, element, 4, 2, solve, cpu) for pkg in pkgs + pkgs]
    assert counts[0]["ops"] > 0 and all(c["ops"] == counts[0]["ops"] for c in counts)
    row = walls.time_row(pkgs, element, 4, 2, solve, 2, cpu)
    assert all(row["finite"].values()) and set(row["its"].values()) == {counts[0]["its"]}
    assert all(len(v) == 2 and min(v) > 0 for v in row["ms"].values()) and row["paired_ratio"][walls.AGAINST] > 0
    if solve != "matvec":
        W, bcs, params = walls.problem(walls.HERE, element, 4, 2, cpu)
        assert row["its"][walls.HERE] == solve_dpp(W, params, bcs,
                                                   solver_parameters=walls.options(solve)).iteration_number
