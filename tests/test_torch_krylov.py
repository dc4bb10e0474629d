"""The port's Krylov slice on the CPU against the JAX package.

- ``solve_dpp`` with ``PLAIN_GMRES_PARAMS`` lands the published PETSc counts
  and with ``GMRES_JACOBI_PARAMS`` the JAX package's counts, with solutions
  and residuals held to the JAX ``solve_dpp`` on the same boundary data;
- the twins of the fused GMRES roles (K5 ``fused_gmres_ef64``, K4
  ``fused_gmres_df``) against JAX's ``krylov.gmres_ef64`` / ``krylov.gmres``
  on the same ``b`` and ``x0``;
- ``krylov.gmres``'s exits, ``preonly`` with a preconditioner, ``cg``;
- the fused GMRES envelope against the JAX gate, and the route of each
  preset.

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
)
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


# the JAX gate's edges: 2D rows of 128 lanes (126^2 nodes in, 127^2 out), 3D
# lane-packed planes (29^3 in, 33^3 out), narrow 2D grids with both fields
# side by side in lanes (301 rows in, 521 out). ILU and fieldsplit are not
# lane-packed: the two fields stacked, and the ILU factor planes in the
# budget (tet nx=9 in, 10 out; fieldsplit LU nx=14 in, 15 out).
# (element, cells, inside for pc none/jacobi, ilu/fieldsplit_ilu, fieldsplit_lu)
ENVELOPE = [
    ("quad", (125, 125), True, True, True), ("quad", (126, 126), False, False, False),
    ("tet", (28, 28, 28), True, False, False), ("tet", (32, 32, 32), False, False, False),
    ("triangle", (40, 300), True, False, False), ("quad", (40, 520), False, False, False),
    ("hex", (16, 16, 16), True, False, False),
    ("tet", (9, 9, 9), True, True, True), ("tet", (10, 10, 10), True, False, True),
    ("tet", (14, 14, 14), True, False, True), ("tet", (15, 15, 15), True, False, False),
]


@pytest.mark.parametrize("pc", ["none", "jacobi", "ilu", "fieldsplit_ilu", "fieldsplit_lu"])
@pytest.mark.parametrize(
    "element,cells,lane_packed,ilu,fieldsplit_lu", ENVELOPE,
    ids=[f"{e}{c[0]}x{c[1]}" for e, c, *_ in ENVELOPE],
)
def test_envelope_agrees_with_jax_gate(monkeypatch, element, cells, lane_packed, ilu, fieldsplit_lu, pc):
    monkeypatch.setenv("PERPHIL_TPU_FUSED_GMRES", "force")  # judge the gate off-TPU
    mesh = _jax_mesh(element, cells)
    _, jV = jspaces_of(mesh)
    jop = JOp(jmixed(jV), JParams())
    zero = np.zeros(mesh.node_shape)
    state = from_numpy_state({}, cells, element, zero, zero, device="cpu")
    op = DPPOperator(state.W, state.params)
    inside = {"none": lane_packed, "jacobi": lane_packed, "ilu": ilu, "fieldsplit_ilu": ilu,
              "fieldsplit_lu": fieldsplit_lu}[pc]
    assert jax_fused_gmres_supported(jop, pc) == fused_gmres_supported(op, pc) == inside


SS = {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}
SSI = {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_ILU_PARAMS}
ROUTES = [
    ("quad", (8, 8), sp.PLAIN_GMRES_PARAMS, K5),  # 162 DoF
    ("tet", (4, 4, 4), sp.PLAIN_GMRES_PARAMS, K5),  # 250 DoF
    ("quad", (16, 16), sp.PLAIN_GMRES_PARAMS, K4),  # 578 DoF > 512
    ("quad", (4, 4), sp.GMRES_JACOBI_PARAMS, K4),
    ("quad", (64, 64), sp.GMRES_JACOBI_PARAMS, K4),
    ("tet", (16, 16, 16), sp.PLAIN_GMRES_PARAMS, K4),
    ("quad", (128, 128), sp.PLAIN_GMRES_PARAMS, "gmres"),  # beyond the envelope
    ("quad", (8, 8), {**sp.PLAIN_GMRES_PARAMS, "ksp_gmres_restart": 40}, "gmres"),
    ("quad", (8, 8), {**sp.GMRES_PARAMS, "pc_type": "lu"}, "gmres"),
    ("quad", (8, 8), {**sp.GMRES_JACOBI_PARAMS, "ksp_type": "cg"}, "cg"),
    ("quad", (16, 16), sp.GMRES_ILU_PARAMS, K7),
    ("tet", (9, 9, 9), sp.GMRES_ILU_PARAMS, K7),
    ("tet", (10, 10, 10), sp.GMRES_ILU_PARAMS, "gmres"),  # ILU planes over the budget
    ("quad", (128, 128), sp.GMRES_ILU_PARAMS, "gmres"),
    ("quad", (8, 8), {**sp.GMRES_ILU_PARAMS, "pc_factor_levels": 1}, "gmres"),  # raises there
    ("quad", (16, 16), SS, K6),
    ("tet", (14, 14, 14), SS, K6),
    ("quad", (256, 256), SS, "gmres"),
    ("quad", (16, 16), {**SS, "pc_fieldsplit_type": "additive"}, "gmres"),
    ("quad", (16, 16), SSI, K8),
    ("quad", (16, 16), {**SSI, "fieldsplit_1_ksp_rtol": 1e-6}, "gmres"),  # not the kernel's inner tolerance
    ("quad", (128, 128), SSI, "gmres"),
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
    big = from_numpy_state({}, (128, 128), "quad", np.zeros((129, 129)), np.zeros((129, 129)), device="cpu")
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
