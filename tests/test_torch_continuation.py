"""The chunked continuation on the CPU: ``_x0_continuation`` (PETSc's
KSPSetInitialGuessNonzero analogue) in ``solvers/solver.py`` and the
chunked drivers of ``experiments/profiling.py``, held to the whole solves
and to the JAX package's drivers at 2D N=16:

- the plain GMRES driver stops at ``ksp_max_it`` (25 with chunks of 10);
  with restart-aligned chunks (90 = 3 cycles) it lands the whole solve's
  292 with fields within 1e-12 (the continuation recomputes the residual
  of its iterate, so the fields part by rounding: 5.9e-14 here);
- the ngs driver (chunks of 50) lands 194, bit for bit the whole solve's
  iterate, and within 1e-10 of the JAX package's chunked driver;
- the builders give the five-argument continuation on the gmres/cg routes
  (the host loops and the fused roles' twins) and the ngs Picard (quad and
  lexicographic), from a given iterate with ``rtol = 0``; elsewhere a
  five-argument call raises, as it does in the JAX package.
"""

import math

import numpy as np
import pytest
import torch

import perphil_tpu.experiments.profiling as jprof
import perphil_tpu.solvers.solver as jsolver
from perphil_tpu.forms.spaces import create_function_spaces as jspaces
from perphil_tpu.forms.spaces import mixed_space as jmixed
from perphil_tpu.mesh.structured import create_mesh as jmesh
from perphil_tpu.models.dpp.parameters import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC
from perphil_tpu.ops.assembly import bc_values_per_field as jbc_values
from perphil_tpu.solvers import parameters as jsp
from perphil_tpu.utils.manufactured_solutions import exact_expressions as jexact

from perphil_tpu_torch.experiments.profiling import build_chunked_ngs_solver, build_chunked_plain_solver
from perphil_tpu_torch.forms.spaces import create_function_spaces, mixed_space
from perphil_tpu_torch.mesh.structured import create_mesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator, bc_values_per_field
from perphil_tpu_torch.solvers import parameters as sp
from perphil_tpu_torch.solvers import solve_dpp, solve_dpp_nonlinear
from perphil_tpu_torch.solvers.solver import _build_linear_solver, _build_nonlinear_solver, _freeze
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions


def _problem(n, quad=True):
    mesh = create_mesh(n, n, quadrilateral=quad)
    _, V = create_function_spaces(mesh, device="cpu")
    W = mixed_space(V)
    params = DPPParameters()
    _, p1e, _, p2e = exact_expressions(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    return W, params, bcs, bc_values_per_field(W, bcs)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def n16():
    return _problem(16)


def test_chunked_plain_solver_respects_max_it(n16):
    """PETSc stops at ksp_max_it: the last chunk is clamped (25, not 30)."""
    W, params, _, (g1, g2) = n16
    solver = build_chunked_plain_solver(W, params, {**sp.PLAIN_GMRES_PARAMS, "ksp_max_it": 25}, chunk=10)
    assert solver(g1, g2)[2] == 25


def test_chunked_plain_solver_matches_the_whole_solve(n16):
    W, params, _, (g1, g2) = n16
    z1, z2, its, _ = _build_linear_solver(W, params, _freeze(sp.PLAIN_GMRES_PARAMS))(g1, g2)
    c1, c2, total, rnorm = build_chunked_plain_solver(W, params, sp.PLAIN_GMRES_PARAMS, chunk=90)(g1, g2)
    assert its == total == 292
    assert max(_rel(c1, z1), _rel(c2, z2)) <= 1e-12
    assert 0.0 < float(rnorm) <= 1e-8 * _r0(W, params, g1, g2)


def _r0(W, params, g1, g2):
    op = DPPOperator(W, params)
    bdry = op._mask_arrays[0]
    b1, b2 = op.lifted_rhs(g1, g2)
    r1, r2 = op.residual(torch.where(bdry, g1, 0.0), torch.where(bdry, g2, 0.0), b1, b2)
    return math.sqrt(float((r1 * r1).sum() + (r2 * r2).sum()))


def test_chunked_ngs_solver_is_the_whole_solve_and_the_jax_drivers(n16):
    W, params, _, (g1, g2) = n16
    z1, z2, its, fn = _build_nonlinear_solver(W, params, _freeze(sp.PICARD_LU_SOLVER_PARAMS))(g1, g2)
    c1, c2, total, cfn = build_chunked_ngs_solver(W, params, sp.PICARD_LU_SOLVER_PARAMS, chunk=50)(g1, g2)
    assert its == total == 194
    assert torch.equal(c1, z1) and torch.equal(c2, z2) and float(cfn) == float(fn)

    mesh = jmesh(16, 16)
    jW = jmixed(jspaces(mesh)[1])
    jp = JParams()
    _, p1e, _, p2e = jexact(mesh, jp)
    jg1, jg2 = jbc_values(jW, [JBC(jW.sub(0), p1e), JBC(jW.sub(1), p2e)])
    jsolver._build_nonlinear_solver.cache_clear()
    r1, r2, jtotal, _ = jprof.build_chunked_ngs_solver(jW, jp, jsp.PICARD_LU_SOLVER_PARAMS, chunk=50)(jg1, jg2)
    jsolver._build_nonlinear_solver.cache_clear()
    assert int(jtotal) == 194
    for a, b in ((c1, r1), (c2, r2)):
        assert _rel(a, torch.tensor(np.asarray(b))) <= 1e-10


CONTINUATION_LINEAR = [
    sp.PLAIN_GMRES_PARAMS,  # K5's size: the continuation runs K4's twin
    sp.GMRES_ILU_PARAMS,
    {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS},
    {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_PARAMS},  # the host loop with inner GMRES
    {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-8},
]


@pytest.mark.parametrize("opts", CONTINUATION_LINEAR, ids=["plain", "ilu", "ss", "ss-host", "cg"])
def test_linear_continuation_from_an_iterate(opts):
    """From the whole solve's iterate after a few steps, the continuation
    reaches ``atol_abs`` (rtol 0) and returns the whole solve's solution."""
    W, params, _, (g1, g2) = _problem(4)
    whole = _build_linear_solver(W, params, _freeze(opts))
    z1, z2, its, rnorm = whole(g1, g2)
    part = _build_linear_solver(W, params, _freeze({**opts, "ksp_max_it": 2}))(g1, g2)
    cont = _build_linear_solver(W, params, _freeze({**opts, "_x0_continuation": True}))
    atol = float(rnorm) * 1e-2
    x1, x2, cits, crnorm = cont(g1, g2, part[0], part[1], atol)
    assert cits >= 1 and float(crnorm) <= atol
    assert max(_rel(x1, z1), _rel(x2, z2)) <= 1e-6


@pytest.mark.parametrize("quad", [True, False], ids=["quad-colored", "tri-lexicographic"])
def test_ngs_continuation_from_an_iterate(quad):
    W, params, _, (g1, g2) = _problem(4, quad)
    opts = sp.PICARD_LU_SOLVER_PARAMS
    z1, z2, its, fn = _build_nonlinear_solver(W, params, _freeze(opts))(g1, g2)
    x1, x2, k, _ = _build_nonlinear_solver(W, params, _freeze({**opts, "snes_max_it": 5}))(g1, g2)
    cont = _build_nonlinear_solver(W, params, _freeze({**opts, "_x0_continuation": True}))
    y1, y2, rest, cfn = cont(g1, g2, x1, x2, float(fn))
    assert k == 5 and k + rest == its and float(cfn) <= float(fn)
    assert torch.equal(y1, z1) and torch.equal(y2, z2)


def test_continuation_is_refused_elsewhere():
    """The other routes build their two-argument solve, as the JAX
    package's do, so a five-argument call raises; the entry points, which
    call with two, raise on the option."""
    W, params, bcs, (g1, g2) = _problem(4)
    for opts in (
        sp.LINEAR_SOLVER_PARAMS,
        {**sp.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm"},
    ):
        solver = _build_linear_solver(W, params, _freeze({**opts, "_x0_continuation": True}))
        with pytest.raises(TypeError):
            solver(g1, g2, g1, g2, 1e-8)
    block_gs = {"snes_type": "block_gs", **sp.FIELDSPLIT_LU_PARAMS, "_x0_continuation": True}
    with pytest.raises(TypeError):
        _build_nonlinear_solver(W, params, _freeze(block_gs))(g1, g2, g1, g2, 1e-8)
    with pytest.raises(TypeError):
        solve_dpp(W, params, bcs, {**sp.PLAIN_GMRES_PARAMS, "_x0_continuation": True})
    with pytest.raises(TypeError):
        solve_dpp_nonlinear(W, params, bcs, {**sp.PICARD_LU_SOLVER_PARAMS, "_x0_continuation": True})
