"""The port's fieldsplit preconditioning (slice 3) on the CPU against the JAX
package.

- ``FieldOperator`` (the fieldsplit blocks) against JAX's;
- through ``solve_dpp``, SS-GMRES (K6 twin), SS-GMRES+ILU (K8 twin) and
  ``FIELDSPLIT_GMRES_PARAMS`` (host loop) land 4 iterations;
- K8's inner modes (``fieldsplit_inner_ksp``): the literal GMRES + ILU
  blocks against the JAX package's native route, the TPU kernel's PCG
  blocks against a copy of that PCG; the option and ``partri_group`` in the
  solver caches' key;
- the host route's functions (``_monolithic_pc`` with fieldsplit,
  ``_block_solver``, ``_exact_field_solver``, the coupling), called directly
  with the outer ``krylov.gmres``, against JAX's same route;
- the K6 and K8 twins' solutions against JAX's ``solve_dpp``;
- additive fieldsplit and ``preonly`` + fieldsplit.

The JAX ILU runs in float64 (``PERPHIL_TPU_ILU_DTYPE``, not in its solver
cache key, hence the ``cache_clear``).
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
from perphil_tpu.ops.assembly import DirichletBC as JBC, DPPOperator as JOp, FieldOperator as JFieldOp
from perphil_tpu.solvers import solve_dpp as jsolve_dpp
from perphil_tpu.solvers import solver as jsolver
from perphil_tpu.utils import manufactured_solutions as jms

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.ops.assembly import DPPOperator, FieldOperator, coupling_apply
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain
from perphil_tpu_torch.ops.fused_gmres import K6, K8, FusedGMRESSolver, _tree_dot
from perphil_tpu_torch.ops.krylov import gmres
from perphil_tpu_torch.solvers import solve_dpp
from perphil_tpu_torch.solvers.solver import (
    _block_solver,
    _build_linear_solver,
    _exact_field_solver,
    _freeze,
    _krylov_kind,
    _monolithic_pc,
)

PARAMS = {"k1": 1.2, "beta": 0.9}
KW = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}


@pytest.fixture
def jax_f64_ilu(monkeypatch):
    """The JAX package's exact-parity ILU mode (float64 applies)."""
    monkeypatch.setenv("PERPHIL_TPU_ILU_DTYPE", "float64")
    jsolver._build_linear_solver.cache_clear()
    yield
    jsolver._build_linear_solver.cache_clear()


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(element, cells, params=PARAMS, g1=None, g2=None):
    """(JAX mesh, JAX space, port state) of one system."""
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    _, jV = jspaces_of(mesh)
    zero = np.zeros(mesh.node_shape)
    state = from_numpy_state(params, cells, element, zero if g1 is None else g1, zero if g2 is None else g2, device="cpu")
    return mesh, jV, state


FIELD_MESHES = [("quad", (6, 5)), ("triangle", (6, 5)), ("hex", (4, 3, 5)), ("tet", (3, 4, 3))]


@pytest.mark.parametrize("element,cells", FIELD_MESHES, ids=[e for e, _ in FIELD_MESHES])
def test_field_operator_matches_jax(element, cells):
    mesh, jV, state = _pair(element, cells)
    p = state.params
    rng = np.random.default_rng(11)
    z, g, f = (rng.standard_normal(mesh.node_shape) for _ in range(3))
    for k in (p.k1, p.k2):
        jop = JFieldOp(jV, k, p.beta, p.mu)
        op = FieldOperator(state.W.sub(0), k, p.beta, p.mu)
        assert np.array_equal(op.stencil, np.asarray(jop.stencil))
        pairs = [
            (op.matvec(torch.tensor(z)), jop.matvec(jnp.asarray(z))),
            (op.mass_apply(torch.tensor(z)), jop.mass_apply(jnp.asarray(z))),
            (op.lifted_rhs(torch.tensor(g)), jop.lifted_rhs(jnp.asarray(g))),
            (op.lifted_rhs(torch.tensor(g), torch.tensor(f)), jop.lifted_rhs(jnp.asarray(g), jnp.asarray(f))),
        ]
        for got, ref in pairs:
            assert _rel(got.numpy(), ref) <= 1e-14


def _manufactured(element, cells):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    ex = jms.exact_expressions if mesh.dim == 2 else jms.exact_expressions_3d
    _, p1, _, p2 = ex(mesh, JParams())
    coords = [jnp.asarray(c) for c in mesh.coordinates()]
    return np.asarray(p1(*coords)), np.asarray(p2(*coords))


def _newton_rhs(op, grids):
    b1, b2 = op.lifted_rhs(*grids)
    bdry = op._mask_arrays[0]
    return torch.stack(op.residual(*(torch.where(bdry, g, 0.0) for g in grids), b1, b2))


SS = {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}
SSI = {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_ILU_PARAMS}
FG = {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_PARAMS}
JSS = {**jsp.GMRES_PARAMS, **jsp.FIELDSPLIT_LU_PARAMS}
JSSI = {**jsp.GMRES_PARAMS, **jsp.FIELDSPLIT_GMRES_ILU_PARAMS}
JFG = {**jsp.GMRES_PARAMS, **jsp.FIELDSPLIT_GMRES_PARAMS}
# preset, its route, the fused role's preconditioner (None: the host loop)
PRESETS = {
    "ss-gmres": (SS, K6, "fieldsplit_lu"),
    "ss-gmres-ilu": (SSI, K8, "fieldsplit_ilu"),
    "fieldsplit-gmres": (FG, "gmres", None),
}
MESHES = [("quad", (4, 4)), ("quad", (8, 8)), ("tet", (4, 4, 4))]


@pytest.mark.parametrize("element,cells", MESHES, ids=[f"{e}{c[0]}" for e, c in MESHES])
@pytest.mark.parametrize("preset", PRESETS)
def test_fieldsplit_presets_land_4(preset, element, cells):
    """The reference's "4 at every N" (petsc_perf_breakdown.csv). The solve
    stops on the preconditioned residual, ``<= rtol ||P r0||``; that bounds
    the true residual only up to cond(PA): measured up to 1.5e-7 ||r0||."""
    params, kind, fused_pc = PRESETS[preset]
    g1, g2 = _manufactured(element, cells)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    op = DPPOperator(state.W, state.params)
    flat = dict(_freeze(params))
    assert _krylov_kind(op, flat) == kind
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=params)
    assert sol.iteration_number == 4
    r0 = _newton_rhs(op, state.grids)
    pc = _monolithic_pc(op, flat) if fused_pc is None else FusedGMRESSolver(op, fused_pc).plain_pc()
    assert 0.0 < sol.residual_error <= KW["rtol"] * float(pc(r0).norm())
    res = torch.stack(op.residual(*sol.solution.data, *op.lifted_rhs(*state.grids)))
    assert float(res.norm()) <= 1e-6 * float(r0.norm())


HOST_CASES = [
    ("ss", ("quad", (4, 4))), ("ss", ("quad", (8, 8))), ("ss", ("tet", (4, 4, 4))),
    ("fg", ("quad", (4, 4))),
    ("additive", ("quad", (8, 8))), ("additive", ("tet", (4, 4, 4))),
]
HOST_PARAMS = {
    "ss": (SS, JSS), "ssi": (SSI, JSSI), "fg": (FG, JFG),
    "additive": ({**SS, "pc_fieldsplit_type": "additive"}, {**JSS, "pc_fieldsplit_type": "additive"}),
}


@pytest.mark.parametrize("case,mesh", HOST_CASES, ids=[f"{c}-{m[0]}{m[1][0]}" for c, m in HOST_CASES])
def test_host_route_matches_jax(jax_f64_ilu, case, mesh):
    """``_monolithic_pc`` with fieldsplit and the outer ``krylov.gmres``,
    called directly in both packages on the same right-hand side: the same
    count; preconditioner applications and solutions within 1e-10 (reduction
    orders differ: halving trees here, XLA's dots there)."""
    params, jparams = HOST_PARAMS[case]
    element, cells = mesh
    g1, g2 = _manufactured(element, cells)
    jm, jV, state = _pair(element, cells, {}, g1, g2)
    op, jop = DPPOperator(state.W, state.params), JOp(jmixed(jV), JParams())
    pc = _monolithic_pc(op, dict(_freeze(params)))
    jpc = jsolver._monolithic_pc(jop, dict(jsolver._freeze(jparams)))
    v = np.random.default_rng(2).standard_normal((2,) + jm.node_shape)
    assert _rel(pc(torch.tensor(v)).numpy(), jpc(jnp.asarray(v))) <= 1e-10
    r = _newton_rhs(op, state.grids)
    got = gmres(op.stacked_matvec(), r, M_inv=pc, **KW)
    ref = jkrylov.gmres(jop.stacked_matvec(), jnp.asarray(r.numpy()), M_inv=jpc, **KW)
    assert got.iterations == int(ref.iterations)
    assert _rel(got.x.numpy(), ref.x) <= 1e-10


@pytest.mark.parametrize("element,cells", [("quad", (5, 4)), ("tet", (3, 4, 3))], ids=["quad", "tet"])
def test_block_functions_match_jax(jax_f64_ilu, element, cells):
    """The exact block solve (f64 fast-diag on quads, PCG to 1e-13 on tets),
    the coupling and the block solvers, one application each."""
    mesh, jV, state = _pair(element, cells)
    p = state.params
    rng = np.random.default_rng(3)
    b = rng.standard_normal(mesh.node_shape)
    jfop = JFieldOp(jV, p.k2, p.beta, p.mu)
    fop = FieldOperator(state.W.sub(1), p.k2, p.beta, p.mu)
    pairs = [
        (_exact_field_solver(fop), jsolver._exact_field_solver(jfop), 1e-12),
        (coupling_apply(state.mesh, p, state.W.device), jsolver._coupling_apply(mesh, JParams(**PARAMS)), 1e-14),
    ]
    for sub, tol in (
        ({"ksp_type": "preonly", "pc_type": "ilu"}, 1e-12),
        ({"ksp_type": "preonly", "pc_type": "jacobi"}, 1e-15),
        ({"ksp_type": "gmres", "pc_type": "ilu", "ksp_rtol": 1e-8, "ksp_atol": 1e-12}, 1e-10),
        ({"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-10}, 1e-10),
        ({"ksp_type": "gmres", "pc_type": "none", "ksp_rtol": 1e-10}, 1e-10),
    ):
        pairs.append((_block_solver(fop, sub), jsolver._block_solver(jfop, sub), tol))
    for got, ref, tol in pairs:
        assert _rel(got(torch.tensor(b)).numpy(), ref(jnp.asarray(b))) <= tol


def _jax_solve(element, cells, g1, g2, params):
    _, jV = jspaces_of(jmesh.StructuredMesh(cells=cells, element=element))
    W = jmixed(jV)
    bcs = [JBC(W.sub(0), jnp.asarray(g1)), JBC(W.sub(1), jnp.asarray(g2))]
    return jsolve_dpp(W, JParams(), bcs, solver_parameters=params)


# K6's inner PCG stops at 1e-13 where JAX's blocks solve exactly: measured
# <= 4.8e-16 apart. K8's literal blocks are JAX's own inner GMRES + ILU to
# 1e-8, its dots halving trees where JAX's are XLA's: measured <= 4.7e-16
# apart at quad N=4/8 and tet nx=4.
TWIN_CASES = [
    ("ss", "quad", (4, 4), 1e-12), ("ss", "quad", (8, 8), 1e-12), ("ss", "tet", (4, 4, 4), 1e-12),
    ("ssi", "quad", (4, 4), 1e-12), ("ssi", "quad", (8, 8), 1e-12), ("ssi", "tet", (4, 4, 4), 1e-12),
]


@pytest.mark.parametrize("case,element,cells,tol", TWIN_CASES, ids=[f"{c[0]}-{c[1]}{c[2][0]}" for c in TWIN_CASES])
def test_fused_twins_match_jax(jax_f64_ilu, case, element, cells, tol):
    params, jparams = HOST_PARAMS[case]
    g1, g2 = _manufactured(element, cells)
    ref = _jax_solve(element, cells, g1, g2, jparams)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=params)
    assert sol.iteration_number == int(ref.iteration_number) == 4
    for a, b in zip(sol.solution.data, ref.solution.data):
        assert _rel(a.numpy(), b) <= tol


def _tpu_pcg_block(solver: FusedGMRESSolver, f: int, rhs: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's inner PCG (``pallas_gmres.py:1416-1474``) as the
    K8 twin ran it before its literal mode, written out here."""
    A, M = solver.field_ops[f].matvec, solver.field_ilu[f].plain_grid
    rn0 = float(torch.sqrt(_tree_dot(rhs, rhs)))
    tol = max(rn0 * 1e-8, 1e-12)
    z = M(rhs)
    rz = _tree_dot(z, rhs)
    x, r, p = torch.zeros_like(rhs), rhs, z
    done, its = not rn0 > tol, 0
    while not done and its < 50000:
        Ap = A(p)
        alpha = rz / _tree_dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _tree_dot(z, r)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rn = float(torch.sqrt(_tree_dot(r, r)))
        its += 1
        done = not rn > tol or not math.isfinite(rn)
    solver.inner_iterations += its
    solver.inner_solves += 1
    return x


@pytest.mark.parametrize("element,cells", [("quad", (8, 8)), ("tet", (4, 4, 4))], ids=["quad8", "tet4"])
def test_k8_pcg_mode_keeps_the_tpu_blocks(element, cells):
    """``fieldsplit_inner_ksp: pcg`` routes to K8 and its twin is the outer
    ``krylov.gmres`` with the TPU kernel's PCG blocks bit for bit, inner
    counts included; the literal mode's differs, its inner counts its own."""
    g1, g2 = _manufactured(element, cells)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    op = DPPOperator(state.W, state.params)
    assert _krylov_kind(op, dict(_freeze({**SSI, "fieldsplit_inner_ksp": "pcg"}))) == K8
    r = _newton_rhs(op, state.grids)
    kw = dict(rtol=1e-8, atol=1e-12, max_it=50000)
    pcg = FusedGMRESSolver(op, "fieldsplit_ilu", **kw, inner_ksp="pcg")
    got = pcg.plain(r)
    ref = FusedGMRESSolver(op, "fieldsplit_ilu", inner_ksp="pcg")  # its blocks' operators and factors

    def fieldsplit(v):
        y1 = _tpu_pcg_block(ref, 0, v[0])
        return torch.stack([y1, _tpu_pcg_block(ref, 1, v[1] - ref.coupling(y1))])

    def mv(z):
        return torch.stack(fused_dpp_apply_plain(z[0], z[1], *pcg.stencils, mode="matvec"))

    want = gmres(mv, r, **kw, restart=30, M_inv=fieldsplit)
    assert got.iterations == want.iterations == 4
    assert got.residual_norm == want.residual_norm and torch.equal(got.x, want.x)
    assert (pcg.inner_iterations, pcg.inner_solves) == (ref.inner_iterations, ref.inner_solves)
    lit = FusedGMRESSolver(op, "fieldsplit_ilu", **kw)
    assert lit.inner_tols() == (1e-8, 1e-12, 50000, 30) and pcg.inner_tols() == (1e-8, 1e-12, 50000, 0)
    assert not torch.equal(lit.plain(r).x, got.x)
    assert lit.inner_solves == pcg.inner_solves and lit.inner_iterations != pcg.inner_iterations


def test_inner_ksp_and_partri_group_options():
    """Both options are validated and part of the solver caches' key: each
    value builds its own solver; beyond K8's envelope, or with block options
    other than the kernel's, the host route runs the blocks' own solves."""
    state = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    W, p = state.W, state.params
    for bad in ({"fieldsplit_inner_ksp": "cg"}, {"partri_group": -1}, {"partri_group": 2.5},
                {"partri_group": True}, {"partri_group": "8"}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            solve_dpp(W, p, state.bcs, solver_parameters={**SSI, "trisolve_backend": "partri", **bad})
    builds = {
        _build_linear_solver(W, p, _freeze({**SSI, **extra}))
        for extra in ({}, {"fieldsplit_inner_ksp": "literal"}, {"fieldsplit_inner_ksp": "pcg"},
                      {"partri_group": 0}, {"partri_group": 2})
    }
    assert len(builds) == 5
    assert _build_linear_solver(W, p, _freeze({**SSI, "fieldsplit_inner_ksp": "pcg"})) in builds
    op = DPPOperator(W, p)
    restart = {**SSI, "fieldsplit_0_ksp_gmres_restart": 20}
    assert _krylov_kind(op, dict(_freeze(restart))) == "gmres"  # not the kernel's blocks
    assert _krylov_kind(op, dict(_freeze({**restart, "fieldsplit_inner_ksp": "pcg"}))) == K8


@pytest.mark.parametrize(
    "sub", [jsp.FIELDSPLIT_LU_PARAMS, jsp.FIELDSPLIT_GMRES_PARAMS], ids=["lu-blocks", "gmres-blocks"]
)
def test_preonly_fieldsplit_matches_jax(sub):
    """One application of the fieldsplit preconditioner to the lifted RHS."""
    g1, g2 = _manufactured("quad", (8, 8))
    params = {**sub, "ksp_type": "preonly"}
    ref = _jax_solve("quad", (8, 8), g1, g2, params)
    state = from_numpy_state({}, (8, 8), "quad", g1, g2, device="cpu")
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=params)
    assert (sol.iteration_number, sol.residual_error) == (1, 0.0)
    for a, b in zip(sol.solution.data, ref.solution.data):
        assert _rel(a.numpy(), b) <= 1e-10
    assert math.isfinite(float(sol.solution.data[0].sum()))


def test_unsupported_fieldsplit_options_raise():
    state = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    for params, match in (
        ({**SS, "pc_fieldsplit_type": "schur"}, "pc_fieldsplit_type"),
        ({**SS, "fieldsplit_0_ksp_type": "bicg"}, "block ksp_type"),
        ({**SS, "fieldsplit_1_pc_type": "sor"}, "block pc_type"),
    ):
        with pytest.raises(ValueError, match=match):
            solve_dpp(state.W, state.params, state.bcs, solver_parameters=params)
