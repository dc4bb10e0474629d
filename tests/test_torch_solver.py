"""The port's main path end to end: ``solve_dpp`` with the direct presets
against the reference's golden errors and against the JAX package's
``solve_dpp`` on the same systems, the error norms, the Krylov option paths
that now run, and the option paths that are not ported yet."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.solvers.parameters as jsp
from perphil_tpu.forms import Function as JFunction
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC
from perphil_tpu.solvers import solve_dpp as jsolve_dpp
from perphil_tpu.utils import manufactured_solutions as jms
from perphil_tpu.utils.postprocessing import h1_seminorm_error as jh1, l2_error as jl2

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.forms import Function, create_function_spaces, mixed_space
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.mesh import create_cube_mesh, create_mesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator
from perphil_tpu_torch.ops.fused_direct import fused_simplicial_direct_supported
from perphil_tpu_torch.solvers import solve_dpp, solve_dpp_nonlinear
from perphil_tpu_torch.solvers.solver import _build_linear_solver, _freeze
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions, exact_expressions_3d
from perphil_tpu_torch.utils.postprocessing import h1_seminorm_error, l2_error

# reference: notebooks/results-conforming-2d/convergence.csv (MUMPS rows),
# as pinned by tests/test_parity_regression.py
_L2_REFERENCE = {
    4: (1965.7375371673206, 196572.59548715068, 30018.89318007683),
    16: (154.91204152557083, 15491.16888191997, 9247.8237859725),
}


@pytest.mark.parametrize("N", [4, 16])
def test_direct_solve_errors_match_reference(N):
    mesh = create_mesh(N, N)
    _, V = create_function_spaces(mesh, device="cpu")
    W = mixed_space(V)
    params = DPPParameters()
    _, p1e, _, p2e = exact_expressions(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    sol = solve_dpp(W, params, bcs, solver_parameters=sp.LINEAR_SOLVER_PARAMS)
    assert sol.iteration_number == 1
    assert sol.residual_error == 0.0
    p1h, p2h = sol.solution.split()
    e1, e2, e1h = _L2_REFERENCE[N]
    assert abs(l2_error(p1h, p1e) - e1) / e1 < 1e-10
    assert abs(l2_error(p2h, p2e) - e2) / e2 < 1e-10
    assert abs(h1_seminorm_error(p1h, p1e) - e1h) / e1h < 1e-10


def _jax_solution(element, cells, g1, g2, params):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    _, jV = jspaces_of(mesh)
    W = jmixed(jV)
    bcs = [JBC(W.sub(0), jnp.asarray(g1)), JBC(W.sub(1), jnp.asarray(g2))]
    return jsolve_dpp(W, JParams(**params), bcs, solver_parameters=jsp.LINEAR_SOLVER_PARAMS)


def _manufactured_grids(element, cells):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    ex = jms.exact_expressions if mesh.dim == 2 else jms.exact_expressions_3d
    _, p1, _, p2 = ex(mesh, JParams())
    coords = [jnp.asarray(c) for c in mesh.coordinates()]
    return np.asarray(p1(*coords)), np.asarray(p2(*coords))


SYSTEMS = [
    ("hex", (6, 6, 6), "LINEAR_SOLVER_PARAMS"),
    ("hex", (6, 6, 6), "TPU_DIRECT_PARAMS"),
    ("tet", (4, 4, 4), "LINEAR_SOLVER_PARAMS"),
    ("triangle", (128, 128), "LINEAR_SOLVER_PARAMS"),  # K3 on 8 blocks (its twin, cg, on the CPU)
    ("triangle", (151, 151), "LINEAR_SOLVER_PARAMS"),  # past the K3 gate: cg with K1
    ("quad", (128, 128), "TPU_DIRECT_PARAMS"),  # beyond the K2 gate: mixed + K1
]


@pytest.mark.parametrize(
    "element,cells,preset", SYSTEMS, ids=[f"{e}{c[0]}-{p.split('_')[0]}" for e, c, p in SYSTEMS]
)
def test_solve_matches_jax(element, cells, preset):
    g1, g2 = _manufactured_grids(element, cells)
    ref = _jax_solution(element, cells, g1, g2, {})
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=getattr(sp, preset))
    assert (sol.iteration_number, sol.residual_error) == (1, 0.0)
    for a, b in zip(sol.solution.data, ref.solution.data):
        b = np.asarray(b)
        assert a.dtype == torch.float64 and a.device == state.W.device
        assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()


def test_large_simplicial_route_is_cg():
    """tri N=151 is the first triangle mesh the K3 gate leaves to cg (the
    largest up to which K3 was measured faster than cg is N=150; the
    launcher's plan places up to N=241)."""
    for n, fused in ((150, True), (151, False)):
        zero = np.zeros((n + 1, n + 1))
        state = from_numpy_state({}, (n, n), "triangle", zero, zero, device="cpu")
        assert fused_simplicial_direct_supported(DPPOperator(state.W, state.params)) == fused


NORM_CASES = [("quad", (8, 8), 14), ("triangle", (4, 4), 4), ("tet", (2, 2, 2), 2)]


@pytest.mark.parametrize("element,cells,degree", NORM_CASES, ids=[c[0] for c in NORM_CASES])
def test_error_norms_match_jax(element, cells, degree):
    """The same discrete field through both packages' L2/H1 error norms.
    The simplicial cases use low quadrature degrees: the JAX norms evaluate
    one quadrature point per eager dispatch."""
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    u = np.random.default_rng(5).standard_normal(mesh.node_shape)
    state = from_numpy_state({"k1": 2.0}, cells, element, u, u, device="cpu")
    _, jV = jspaces_of(mesh)
    ex_j = (jms.exact_expressions if mesh.dim == 2 else jms.exact_expressions_3d)(mesh, JParams(k1=2.0))
    ex_t = (exact_expressions if mesh.dim == 2 else exact_expressions_3d)(state.mesh, state.params)
    ft = Function(state.W.sub(0), torch.as_tensor(u))
    fj = JFunction(jV, jnp.asarray(u))
    for pt, pj in ((ex_t[1], ex_j[1]), (ex_t[3], ex_j[3])):
        ref = jl2(fj, pj, degree)
        assert abs(l2_error(ft, pt, degree) - ref) <= 1e-12 * ref
        ref = jh1(fj, pj, degree)
        assert abs(h1_seminorm_error(ft, pt, degree) - ref) <= 1e-12 * ref
    ref = jl2(fj, JFunction(jV, jnp.asarray(2 * u)), degree)
    assert abs(l2_error(ft, Function(state.W.sub(0), torch.as_tensor(2 * u)), degree) - ref) <= 1e-12 * ref


def test_cpu_solve_launches_no_kernel_and_caches():
    mesh = create_cube_mesh(3, 3, 3)
    _, V = create_function_spaces(mesh, device="cpu")
    W = mixed_space(V)
    params = DPPParameters()
    _, p1e, _, p2e = exact_expressions_3d(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    before = dict(_cuda.KERNEL_LAUNCHES)
    sol = solve_dpp(W, params, bcs, solver_parameters=sp.LINEAR_SOLVER_PARAMS)
    assert dict(_cuda.KERNEL_LAUNCHES) == before
    assert all(d.device.type == "cpu" for d in sol.solution.data)
    key = (W, params, _freeze(sp.LINEAR_SOLVER_PARAMS))
    assert _build_linear_solver(*key) is _build_linear_solver(*key)


NOT_PORTED = [
    ({**sp.PLAIN_GMRES_PARAMS, "_x0_continuation": True}, "slice 10"),
    ({**sp.GMRES_ILU_PARAMS, "_x0_continuation": True}, "slice 10"),
    ({**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS, "_x0_continuation": True}, "slice 10"),
    ({**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_ILU_PARAMS, "_x0_continuation": True}, "slice 10"),
]


@pytest.mark.parametrize("params,where", NOT_PORTED, ids=[f"np{i}" for i in range(len(NOT_PORTED))])
def test_unported_options_raise(params, where):
    state = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    with pytest.raises(NotImplementedError, match=where):
        solve_dpp(state.W, state.params, state.bcs, solver_parameters=params)


# formerly in NOT_PORTED: the Krylov slice and the preconditioning slices run
# them (quad N=4, manufactured solution; counts as in
# tests/test_torch_krylov.py, test_torch_ilu.py and test_torch_fieldsplit.py;
# the ordering-parity ILU's, preonly + ilu + rcm running GMRES at the default
# rtol as the JAX package routes it, as in test_torch_parity_ilu.py, which
# holds them and the fields to the JAX package's solve)
PORTED = [
    (sp.PLAIN_GMRES_PARAMS, 10),
    (sp.GMRES_JACOBI_PARAMS, 9),
    ({"ksp_type": "preonly", "pc_type": "jacobi"}, 1),
    (sp.GMRES_ILU_PARAMS, 5),
    ({**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_ILU_PARAMS}, 4),
    ({**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}, 4),
    ({"ksp_type": "preonly", "pc_type": "fieldsplit"}, 1),
    ({"ksp_type": "preonly", "pc_type": "ilu"}, 1),
    ({**sp.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm"}, 5),
    ({"ksp_type": "preonly", "pc_type": "ilu", "pc_factor_mat_ordering_type": "rcm"}, 3),
]


@pytest.mark.parametrize(
    "params,its", PORTED,
    ids=["plain-gmres", "gmres-jacobi", "preonly-jacobi", "gmres-ilu", "ss-gmres-ilu", "ss-gmres",
         "preonly-fieldsplit", "preonly-ilu", "gmres-ilu-rcm", "preonly-ilu-rcm"],
)
def test_krylov_options_run(params, its):
    mesh = create_mesh(4, 4)
    _, V = create_function_spaces(mesh, device="cpu")
    W = mixed_space(V)
    p = DPPParameters()
    _, p1e, _, p2e = exact_expressions(mesh, p)
    sol = solve_dpp(W, p, [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)], solver_parameters=params)
    assert sol.iteration_number == its
    assert all(bool(torch.isfinite(d).all()) for d in sol.solution.data)


def test_unported_entry_points_raise():
    state = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 10"):
        solve_dpp_nonlinear(state.W, state.params, state.bcs, {**sp.PICARD_LU_SOLVER_PARAMS, "_x0_continuation": True})
    tri = from_numpy_state({}, (4, 4), "triangle", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    with pytest.raises(ValueError, match="quad/hex"):
        solve_dpp(tri.W, tri.params, tri.bcs, solver_parameters=sp.TPU_DIRECT_PARAMS)
