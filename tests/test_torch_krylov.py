"""The port's Krylov slice on the CPU against the JAX package.

- ``solve_dpp`` with ``PLAIN_GMRES_PARAMS`` lands the published PETSc counts
  and with ``GMRES_JACOBI_PARAMS`` the JAX package's counts, with solutions
  and residuals held to the JAX ``solve_dpp`` on the same boundary data;
- the twins of the fused GMRES roles (K5 ``fused_gmres_ef64``, K4
  ``fused_gmres_df``) against JAX's ``krylov.gmres_ef64`` / ``krylov.gmres``
  on the same ``b`` and ``x0``;
- ``krylov.gmres``'s exits, ``preonly`` with a preconditioner, ``cg``;
- the fused GMRES envelope against the launcher's plan (and that it admits
  all the JAX gate admits), and the route of each preset.

On the CPU every kernel wrapper runs its plain twin; the kernels themselves
are held to the twins on the card (``tests/test_torch_kernels.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.solvers.parameters as jsp
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops import krylov as jkrylov
from perphil_tpu.ops.assembly import DirichletBC as JBC, DPPOperator as JOp
from perphil_tpu.ops.pallas_gmres import fused_gmres_supported as jax_fused_gmres_supported
from perphil_tpu.solvers import solve_dpp as jsolve_dpp
from perphil_tpu.utils import manufactured_solutions as jms

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.ops.fused_gmres import (
    K4,
    K5,
    K6,
    K7,
    K8,
    FusedGMRESSolver,
    fused_gmres_df,
    fused_gmres_ef64,
    fused_gmres_supported,
    launch_geometry,
)
from perphil_tpu_torch.ops.ilu import build_field_system, build_monolithic_system, schedule_shape
from perphil_tpu_torch.ops.krylov import gmres, gmres_ef64, tree_sum
from perphil_tpu_torch.solvers import solve_dpp
from perphil_tpu_torch.solvers.solver import _freeze, _krylov_kind


def _jax_mesh(element, cells):
    return jmesh.StructuredMesh(cells=cells, element=element)


def _manufactured(element, cells):
    """Boundary grids of the manufactured solution, from the JAX package."""
    mesh = _jax_mesh(element, cells)
    ex = jms.exact_expressions if mesh.dim == 2 else jms.exact_expressions_3d
    _, p1, _, p2 = ex(mesh, JParams())
    coords = [jnp.asarray(c) for c in mesh.coordinates()]
    return np.asarray(p1(*coords)), np.asarray(p2(*coords))


def _jax_solve(element, cells, g1, g2, params):
    _, jV = jspaces_of(_jax_mesh(element, cells))
    W = jmixed(jV)
    bcs = [JBC(W.sub(0), jnp.asarray(g1)), JBC(W.sub(1), jnp.asarray(g2))]
    return jsolve_dpp(W, JParams(), bcs, solver_parameters=params)


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def test_tree_sum_is_the_halving_tree():
    p = torch.tensor(np.random.default_rng(0).standard_normal((3, 11)))
    expect = []
    for row in p.tolist():
        q = row + [0.0] * 5  # pad 11 -> 16, then halve
        while len(q) > 1:
            q = [a + b for a, b in zip(q[: len(q) // 2], q[len(q) // 2:])]
        expect.append(q[0])
    assert tree_sum(p, dim=1).tolist() == expect
    assert tree_sum(p.T.contiguous(), dim=0).tolist() == expect
    # padding further with zeros changes nothing (the kernel pads to its
    # thread count)
    assert tree_sum(torch.cat([p, p.new_zeros(3, 21)], dim=1), dim=1).tolist() == expect


# published: notebooks/results-conforming-2d/petsc_profiling/petsc_perf_breakdown.csv
# and notebooks/results-conforming-3d/petsc_profiling/petsc_perf_breakdown_3d.csv
PUBLISHED_PLAIN = [("quad", (4, 4), 10), ("quad", (8, 8), 40), ("quad", (16, 16), 292), ("tet", (4, 4, 4), 27)]


@pytest.mark.parametrize(
    "element,cells,expected", PUBLISHED_PLAIN, ids=[f"{e}{c[0]}" for e, c, _ in PUBLISHED_PLAIN]
)
def test_plain_gmres_lands_published_counts(element, cells, expected):
    g1, g2 = _manufactured(element, cells)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=sp.PLAIN_GMRES_PARAMS)
    assert sol.iteration_number == expected


# (element, cells, preset, count, solution tolerance). Unpreconditioned
# GMRES stops in a stagnation tail: two f64 reduction orders (the port's
# halving trees, XLA's dots) give the same count but solutions that differ
# up to ~3e-9 relative at N=8 and reported residuals that differ up to ~20%
# relative (both below tol). Jacobi solves are well conditioned: there the
# solutions agree to ~1e-14 and the residuals to ~1e-9.
JAX_CASES = [
    ("quad", (4, 4), "PLAIN_GMRES_PARAMS", 10, 1e-10),
    ("quad", (8, 8), "PLAIN_GMRES_PARAMS", 40, 1e-8),
    ("tet", (4, 4, 4), "PLAIN_GMRES_PARAMS", 27, 1e-10),
    ("quad", (4, 4), "GMRES_JACOBI_PARAMS", 9, 1e-10),
    ("quad", (8, 8), "GMRES_JACOBI_PARAMS", 16, 1e-10),
    ("quad", (16, 16), "GMRES_JACOBI_PARAMS", 33, 1e-10),
    ("tet", (4, 4, 4), "GMRES_JACOBI_PARAMS", 13, 1e-10),
]


@pytest.mark.parametrize(
    "element,cells,preset,count,tol", JAX_CASES,
    ids=[f"{e}{c[0]}-{p.split('_')[1].lower()}" for e, c, p, _, _ in JAX_CASES],
)
def test_krylov_solve_matches_jax(element, cells, preset, count, tol):
    g1, g2 = _manufactured(element, cells)
    ref = _jax_solve(element, cells, g1, g2, getattr(jsp, preset))
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=getattr(sp, preset))
    assert sol.iteration_number == int(ref.iteration_number) == count
    for a, b in zip(sol.solution.data, ref.solution.data):
        assert a.dtype == torch.float64
        assert _rel(a.numpy(), b) <= tol
    jres = float(ref.residual_error)
    if preset == "GMRES_JACOBI_PARAMS":
        assert abs(sol.residual_error - jres) <= 1e-6 * jres
    else:
        # both stopped on the PETSc test ||r|| <= rtol ||r0|| (atol is far below)
        op = DPPOperator(state.W, state.params)
        b1, b2 = op.lifted_rhs(*state.grids)
        bdry = op._mask_arrays[0]
        x0 = [torch.where(bdry, g, 0.0) for g in state.grids]
        r0 = math.sqrt(sum(float((r * r).sum()) for r in op.residual(*x0, b1, b2)))
        tol_abs = sp.PLAIN_GMRES_PARAMS["ksp_rtol"] * r0
        assert 0.0 < sol.residual_error <= tol_abs and 0.0 < jres <= tol_abs * (1 + 1e-9)


# the same b and x0 through the twins and the JAX Krylov functions; well
# conditioned enough at rtol 1e-12 that the two f64 orders agree to ~1e-13
TWIN_MESHES = [("quad", (8, 8)), ("hex", (3, 4, 3)), ("tet", (4, 3, 3))]
TWIN_ROLES = ["ef64", "df-none", "df-jacobi"]


@pytest.mark.parametrize("role", TWIN_ROLES)
@pytest.mark.parametrize("element,cells", TWIN_MESHES, ids=[f"{e}{c[0]}" for e, c in TWIN_MESHES])
def test_fused_gmres_twins_match_jax(element, cells, role):
    params = {"k1": 1.2, "beta": 0.9}
    mesh = _jax_mesh(element, cells)
    _, jV = jspaces_of(mesh)
    jop = JOp(jmixed(jV), JParams(**params))
    rng = np.random.default_rng(3)
    b, x0 = (rng.standard_normal((2,) + mesh.node_shape) for _ in range(2))
    state = from_numpy_state(params, cells, element, b[0], b[1], device="cpu")
    op = DPPOperator(state.W, state.params)
    kw = dict(rtol=1e-12, atol=1e-14, max_it=2000)
    bt, x0t = torch.tensor(b), torch.tensor(x0)
    if role == "ef64":
        ref = jkrylov.gmres_ef64(jop.stacked_matvec(), jnp.asarray(b), x0=jnp.asarray(x0), **kw)
        got = fused_gmres_ef64(op, bt, x0t, **kw)
    else:
        pc = role.split("-")[1]
        dinv = (1.0 / jop.diagonal()).reshape((2,) + mesh.node_shape)
        ref = jkrylov.gmres(
            jop.stacked_matvec(), jnp.asarray(b), x0=jnp.asarray(x0),
            M_inv=(lambda r: dinv * r) if pc == "jacobi" else None, **kw,
        )
        got = fused_gmres_df(op, bt, x0t, pc_type=pc, **kw)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    assert _rel(got.x.numpy(), ref.x) <= 1e-12


def _small_op():
    state = from_numpy_state({}, (5, 4), "quad", np.zeros((5, 6)), np.zeros((5, 6)), device="cpu")
    return state, DPPOperator(state.W, state.params)


@pytest.mark.parametrize("case", ["zero-rhs", "max-it", "non-finite"])
def test_gmres_exits_match_jax(case):
    """The early exits: an already-converged start, the iteration cap and a
    non-finite residual (which must stop, not loop)."""
    state, op = _small_op()
    _, jV = jspaces_of(_jax_mesh("quad", (5, 4)))
    jop = JOp(jmixed(jV), JParams())
    b = np.random.default_rng(1).standard_normal((2, 5, 6))
    kw = dict(rtol=1e-10, atol=1e-50, max_it=1000)
    if case == "zero-rhs":
        b[:] = 0.0
    elif case == "max-it":
        kw["max_it"] = 7
    else:
        b[0, 2, 3] = np.nan
    ref = jkrylov.gmres(jop.stacked_matvec(), jnp.asarray(b), **kw)
    got = gmres(op.stacked_matvec(), torch.tensor(b), **kw)
    assert got.iterations == int(ref.iterations)
    assert got.converged == bool(ref.converged)
    assert math.isfinite(got.residual_norm) == bool(np.isfinite(ref.residual_norm))
    if case == "max-it":
        assert _rel(got.x.numpy(), ref.x) <= 1e-12
    elif case == "zero-rhs":
        assert not got.x.any()
    # the twin of K5 is gmres without a preconditioner
    ef = gmres_ef64(op.stacked_matvec(), torch.tensor(b), **kw)
    assert ef.iterations == got.iterations and ef.converged == got.converged


OTHER_PATHS = [
    ("quad", (8, 8), {**sp.GMRES_JACOBI_PARAMS, "ksp_type": "cg"}, 17),
    ("tet", (4, 4, 4), {**sp.GMRES_JACOBI_PARAMS, "ksp_type": "cg"}, 14),
    ("quad", (8, 8), {"ksp_type": "preonly", "pc_type": "jacobi"}, 1),
    ("tet", (4, 4, 4), {"ksp_type": "preonly", "pc_type": "none"}, 1),
    ("quad", (8, 8), {**sp.GMRES_PARAMS, "pc_type": "lu"}, 1),
]


@pytest.mark.parametrize(
    "element,cells,params,count", OTHER_PATHS,
    ids=["cg-jacobi-quad8", "cg-jacobi-tet4", "preonly-jacobi", "preonly-none", "gmres-lu"],
)
def test_other_krylov_paths_match_jax(element, cells, params, count):
    g1, g2 = _manufactured(element, cells)
    ref = _jax_solve(element, cells, g1, g2, params)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=params)
    assert sol.iteration_number == int(ref.iteration_number) == count
    for a, b in zip(sol.solution.data, ref.solution.data):
        assert _rel(a.numpy(), b) <= 1e-12
    if params["ksp_type"] == "preonly":
        assert sol.residual_error == 0.0 == float(ref.residual_error)
    elif params["ksp_type"] == "cg":
        assert abs(sol.residual_error - float(ref.residual_error)) <= 1e-9 * float(ref.residual_error)


# The port's envelope is what the launcher can place: at most 32 leaves a
# thread on 16 blocks of 512 threads (262,144 values: 2D N=361 in, 362 out;
# hex/tet nx=49 in, 50 out), and the fieldsplit roles' slices (5 x 8 bytes a
# value a block owns) and K6's line buffers within the launch budget; no
# 128-lane rows or 20 MiB budget (the TPU's Mosaic/VMEM rule, which the JAX
# gate keeps). Out by the slices: K6 on a (40, 520) quad grid (33 lines of 519
# a block), at 2D N=256 and tet nx=40; K8 at 2D N=361 and nx=49.
# (element, cells, inside for pc none/jacobi, ilu, fieldsplit_ilu,
# fieldsplit_lu, the JAX gate's answers in the same order or None)
ENVELOPE = [
    ("quad", (125, 125), (True, True, True, True), (True, True, True, True)),
    ("quad", (126, 126), (True, True, True, True), (False, False, False, False)),
    ("tet", (28, 28, 28), (True, True, True, True), (True, False, False, False)),
    ("tet", (32, 32, 32), (True, True, True, True), (False, False, False, False)),
    ("triangle", (40, 300), (True, True, True, True), (True, False, False, False)),
    ("quad", (40, 520), (True, True, True, False), (False, False, False, False)),
    ("hex", (16, 16, 16), (True, True, True, True), (True, False, False, False)),
    ("tet", (9, 9, 9), (True, True, True, True), (True, True, True, True)),
    ("tet", (10, 10, 10), (True, True, True, True), (True, False, False, True)),
    ("tet", (14, 14, 14), (True, True, True, True), (True, False, False, True)),
    ("tet", (15, 15, 15), (True, True, True, True), (True, False, False, False)),
    # the published sizes the TPU's gate sent to the host loop
    ("quad", (128, 128), (True, True, True, True), None),
    ("quad", (256, 256), (True, True, True, False), None),
    ("tet", (40, 40, 40), (True, True, True, False), None),
    # the last size in and the first out
    ("quad", (361, 361), (True, True, False, False), None),
    ("quad", (362, 362), (False, False, False, False), None),
    ("hex", (49, 49, 49), (True, True, False, False), None),
    ("hex", (50, 50, 50), (False, False, False, False), None),
    ("tet", (49, 49, 49), (True, True, False, False), None),
    ("tet", (50, 50, 50), (False, False, False, False), None),
]
_COLUMN = {"none": 0, "jacobi": 0, "ilu": 1, "fieldsplit_ilu": 2, "fieldsplit_lu": 3}


@pytest.mark.parametrize("pc", ["none", "jacobi", "ilu", "fieldsplit_ilu", "fieldsplit_lu"])
@pytest.mark.parametrize(
    "element,cells,inside,jax_inside", ENVELOPE, ids=[f"{e}{c[0]}x{c[1]}" for e, c, *_ in ENVELOPE]
)
def test_envelope_agrees_with_jax_gate(monkeypatch, element, cells, inside, jax_inside, pc):
    """The gate is the launcher's plan (the table above, worked out from the
    leaves a thread and the slices' bytes; the card's tests hold the plan to
    what the launcher reports), and admits everything the JAX gate admits
    (the JAX package keeps its TPU rule, so the port's envelope is a
    superset of it)."""
    shape = tuple(c + 1 for c in reversed(cells))
    state = from_numpy_state({}, cells, element, np.zeros(shape), np.zeros(shape), device="cpu")
    op = DPPOperator(state.W, state.params)
    expected = inside[_COLUMN[pc]]
    assert fused_gmres_supported(op, pc) == expected
    if pc in ("none", "jacobi"):  # bounded by the leaves a thread alone
        try:
            placed = launch_geometry(2 * math.prod(shape)).leaves <= 32
        except ValueError:
            placed = False
        assert placed == expected
    if jax_inside is not None:
        monkeypatch.setenv("PERPHIL_TPU_FUSED_GMRES", "force")  # judge the gate off-TPU
        mesh = _jax_mesh(element, cells)
        _, jV = jspaces_of(mesh)
        jax_says = jax_fused_gmres_supported(JOp(jmixed(jV), JParams()), pc)
        assert jax_says == jax_inside[_COLUMN[pc]]
        assert expected or not jax_says


SCHEDULES = [("quad", (8, 5)), ("triangle", (16, 16)), ("hex", (3, 5, 4)), ("tet", (3, 3, 3)), ("quad", (1, 1))]


@pytest.mark.parametrize("nfields", [1, 2])
@pytest.mark.parametrize("element,cells", SCHEDULES, ids=[f"{e}{c[0]}x{c[1]}" for e, c in SCHEDULES])
def test_schedule_shape_is_the_built_systems(element, cells, nfields):
    """The gate's ILU schedule from the shape is the one the factor is built on."""
    shape = tuple(c + 1 for c in reversed(cells))
    state = from_numpy_state({}, cells, element, np.zeros(shape), np.zeros(shape), device="cpu")
    p = state.params
    sys = build_monolithic_system(state.mesh, p) if nfields == 2 else build_field_system(state.mesh, p.k1, p.beta, p.mu)
    built = (int((sys.deltas < 0).sum()), int((sys.deltas > 0).sum()), len(sys.levels),
             max(len(lv) for lv in sys.levels))
    assert schedule_shape(shape, nfields) == built


SS = {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}
SSI = {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_ILU_PARAMS}
ROUTES = [
    ("quad", (8, 8), sp.PLAIN_GMRES_PARAMS, K5),  # 162 DoF
    ("tet", (4, 4, 4), sp.PLAIN_GMRES_PARAMS, K5),  # 250 DoF
    ("quad", (16, 16), sp.PLAIN_GMRES_PARAMS, K4),  # 578 DoF > 512
    ("quad", (4, 4), sp.GMRES_JACOBI_PARAMS, K4),
    ("quad", (64, 64), sp.GMRES_JACOBI_PARAMS, K4),
    ("tet", (16, 16, 16), sp.PLAIN_GMRES_PARAMS, K4),
    ("quad", (128, 128), sp.PLAIN_GMRES_PARAMS, K4),  # 8 leaves a thread
    ("quad", (362, 362), sp.PLAIN_GMRES_PARAMS, "gmres"),  # beyond the envelope
    ("quad", (8, 8), {**sp.PLAIN_GMRES_PARAMS, "ksp_gmres_restart": 40}, "gmres"),
    ("quad", (8, 8), {**sp.GMRES_PARAMS, "pc_type": "lu"}, "gmres"),
    ("quad", (8, 8), {**sp.GMRES_JACOBI_PARAMS, "ksp_type": "cg"}, "cg"),
    ("quad", (16, 16), sp.GMRES_ILU_PARAMS, K7),
    ("tet", (9, 9, 9), sp.GMRES_ILU_PARAMS, K7),
    ("tet", (10, 10, 10), sp.GMRES_ILU_PARAMS, K7),
    ("quad", (128, 128), sp.GMRES_ILU_PARAMS, K7),
    ("quad", (256, 256), sp.GMRES_ILU_PARAMS, K7),  # 32 leaves a thread
    ("quad", (8, 8), {**sp.GMRES_ILU_PARAMS, "pc_factor_levels": 1}, "gmres"),  # raises there
    ("quad", (16, 16), SS, K6),
    ("tet", (14, 14, 14), SS, K6),
    ("quad", (256, 256), SS, "gmres"),  # the slices and line buffers beyond the budget
    ("tet", (32, 32, 32), SS, K6),
    ("quad", (16, 16), {**SS, "pc_fieldsplit_type": "additive"}, "gmres"),
    ("quad", (16, 16), SSI, K8),
    ("quad", (16, 16), {**SSI, "fieldsplit_1_ksp_rtol": 1e-6}, "gmres"),  # not the kernel's inner tolerance
    # K8 literal takes the blocks' own max_it and restart too; the pcg mode their tolerances only
    ("quad", (16, 16), {**SSI, "fieldsplit_0_ksp_gmres_restart": 20}, "gmres"),
    ("quad", (16, 16), {**SSI, "fieldsplit_1_ksp_max_it": 100}, "gmres"),
    ("quad", (16, 16), {**SSI, "fieldsplit_inner_ksp": "pcg"}, K8),
    ("quad", (16, 16), {**SSI, "fieldsplit_inner_ksp": "pcg", "fieldsplit_0_ksp_gmres_restart": 20}, K8),
    ("quad", (16, 16), {**SSI, "fieldsplit_inner_ksp": "pcg", "fieldsplit_1_ksp_rtol": 1e-6}, "gmres"),
    ("quad", (128, 128), SSI, K8),
    ("quad", (361, 361), SSI, "gmres"),  # the slices beyond the budget
    ("tet", (40, 40, 40), sp.PLAIN_GMRES_PARAMS, K4),
    ("quad", (16, 16), {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_PARAMS}, "gmres"),  # no fused role
]


@pytest.mark.parametrize(
    "element,cells,params,kind", ROUTES, ids=[f"r{i}-{r[3]}" for i, r in enumerate(ROUTES)]
)
def test_route_of_each_preset(element, cells, params, kind):
    shape = tuple(c + 1 for c in reversed(cells))
    state = from_numpy_state({}, cells, element, np.zeros(shape), np.zeros(shape), device="cpu")
    assert _krylov_kind(DPPOperator(state.W, state.params), dict(_freeze(params))) == kind


def test_cpu_krylov_solves_launch_no_kernel():
    g1, g2 = _manufactured("quad", (8, 8))
    state = from_numpy_state({}, (8, 8), "quad", g1, g2, device="cpu")
    before = dict(_cuda.KERNEL_LAUNCHES)
    for preset in (sp.PLAIN_GMRES_PARAMS, sp.GMRES_JACOBI_PARAMS):
        sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=preset)
        assert all(d.device.type == "cpu" for d in sol.solution.data)
    assert dict(_cuda.KERNEL_LAUNCHES) == before


def test_fused_gmres_rejects_what_it_does_not_take():
    big = from_numpy_state({}, (362, 362), "quad", np.zeros((363, 363)), np.zeros((363, 363)), device="cpu")
    with pytest.raises(ValueError, match="envelope"):
        FusedGMRESSolver(DPPOperator(big.W, big.params))
    state, op = _small_op()
    with pytest.raises(ValueError, match="K5"):
        FusedGMRESSolver(op, "jacobi", K5)
    with pytest.raises(ValueError, match="restart"):
        FusedGMRESSolver(op, restart=40)
    with pytest.raises(ValueError, match="envelope"):
        FusedGMRESSolver(DPPOperator(big.W, big.params), "ilu")
    assert FusedGMRESSolver(op, "ilu").role == K7  # ILU runs in the envelope
    with pytest.raises(ValueError, match="pc_type"):
        FusedGMRESSolver(op, "sor")
    solver = FusedGMRESSolver(op)
    with pytest.raises(ValueError, match="solver built for"):
        solver(torch.zeros((2, 5, 6), device="meta"))
