"""The port's structured ILU(0) (slice 4) on the CPU against the JAX package.

- the structured systems and the ILU(0) factor, bit for bit;
- ``StructuredILU0.apply_flat`` on both trisolve backends (the wavefront
  sweeps and the parallel-prefix partri) against the JAX float64 apply on
  the same backend, within a tolerance (the same function summed in other
  orders);
- ``solve_dpp`` with ``GMRES_ILU_PARAMS`` through the K7 twin: the
  published 2D counts, the JAX count in 3D, solutions against the JAX
  float64 route; the host route's count on both backends; ``preonly`` +
  ILU on both backends; the options that raise.

The JAX ILU runs in float64 (``PERPHIL_TPU_ILU_DTYPE``) on its default
partri backend or, for the wavefront cases, ``PERPHIL_TPU_TRISOLVE=wavefront``;
its solver cache keys on neither, hence the ``cache_clear``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.ops.ilu as jilu
import perphil_tpu.solvers.parameters as jsp
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC, DPPOperator as JOp, FieldOperator as JFieldOp
from perphil_tpu.solvers import solve_dpp as jsolve_dpp
from perphil_tpu.solvers import solver as jsolver
from perphil_tpu.utils import manufactured_solutions as jms

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.ops import ilu
from perphil_tpu_torch.ops.assembly import DPPOperator, FieldOperator
from perphil_tpu_torch.ops.fused_gmres import K7, FusedGMRESSolver
from perphil_tpu_torch.ops.krylov import gmres
from perphil_tpu_torch.solvers import solve_dpp
from perphil_tpu_torch.solvers.solver import _freeze, _krylov_kind, _monolithic_pc

PARAMS = {"k1": 1.2, "beta": 0.9}


@pytest.fixture
def jax_f64_ilu(monkeypatch):
    """The JAX package's exact-parity ILU mode (float64 applies)."""
    monkeypatch.setenv("PERPHIL_TPU_ILU_DTYPE", "float64")
    jsolver._build_linear_solver.cache_clear()
    yield
    jsolver._build_linear_solver.cache_clear()


@pytest.fixture(params=["partri", "wavefront"])
def trisolve(request, jax_f64_ilu, monkeypatch):
    """One trisolve backend for both packages: the JAX package's default
    (partri) or its wavefront sweeps; the port's ``trisolve_backend``."""
    if request.param == "wavefront":
        monkeypatch.setenv("PERPHIL_TPU_TRISOLVE", "wavefront")
    else:
        monkeypatch.delenv("PERPHIL_TPU_TRISOLVE", raising=False)
    jsolver._build_linear_solver.cache_clear()
    return request.param


def _systems(element, cells, kind):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    state = from_numpy_state(PARAMS, cells, element, np.zeros(mesh.node_shape), np.zeros(mesh.node_shape), device="cpu")
    jp = JParams(**PARAMS)
    if kind == "monolithic":
        return jilu.build_monolithic_system(mesh, jp), ilu.build_monolithic_system(state.mesh, state.params)
    return (
        jilu.build_field_system(mesh, jp.k2, jp.beta, jp.mu),
        ilu.build_field_system(state.mesh, state.params.k2, state.params.beta, state.params.mu),
    )


MESHES = [("quad", (4, 4)), ("quad", (16, 16)), ("tet", (4, 4, 4))]


@pytest.mark.parametrize("kind", ["monolithic", "field"])
@pytest.mark.parametrize("element,cells", MESHES, ids=[f"{e}{c[0]}" for e, c in MESHES])
def test_system_and_factor_match_jax(element, cells, kind):
    ref, got = _systems(element, cells, kind)
    for name in ("vals", "valid", "deltas", "blocks", "geoms"):
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name
    assert len(got.levels) == len(ref.levels)
    assert all(np.array_equal(a, b) for a, b in zip(got.levels, ref.levels))
    assert got.center_index == ref.center_index
    fac = ilu.ilu0_factorize(got)
    # bit-equal to the JAX package's level-vectorised numpy factorisation
    assert np.array_equal(fac, jilu._ilu0_factorize_numpy(ref, *jilu._factorization_tables(ref)))
    # its C++ path, where it loads, is built with -march=native: contracted
    # FMAs leave it a rounding apart (up to 4.4e-16 of entries ~3.2 at 2D N=16)
    ref_fac = np.asarray(jilu.ilu0_factorize(ref))
    assert np.abs(fac - ref_fac).max() <= 1e-15 * np.abs(ref_fac).max()


@pytest.mark.parametrize("kind", ["monolithic", "field"])
@pytest.mark.parametrize("element,cells", MESHES, ids=[f"{e}{c[0]}" for e, c in MESHES])
def test_apply_flat_matches_jax(trisolve, element, cells, kind):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    _, jV = jspaces_of(mesh)
    state = from_numpy_state(PARAMS, cells, element, np.zeros(mesh.node_shape), np.zeros(mesh.node_shape), device="cpu")
    p = state.params
    if kind == "monolithic":
        jref = jilu.StructuredILU0.for_monolithic(JOp(jmixed(jV), JParams(**PARAMS)))
        got = ilu.ILU_BACKENDS[trisolve].for_monolithic(state.mesh, p, "cpu")
    else:
        jref = jilu.StructuredILU0.for_field(JFieldOp(jV, p.k1, p.beta, p.mu))
        got = ilu.ILU_BACKENDS[trisolve].for_field(FieldOperator(state.W.sub(0), p.k1, p.beta, p.mu))
    assert (jref.partri is not None) == (trisolve == "partri") == (got.trisolve_backend == "partri")
    r = np.random.default_rng(7).standard_normal(got.nrows)
    ref = np.asarray(jref.apply_flat(jnp.asarray(r)))
    z = got.apply_flat(torch.tensor(r)).numpy()
    # the same factor, summed in other orders (the JAX wavefront's gathers,
    # the JAX partri's einsums): rounded apart
    assert np.abs(z - ref).max() <= 1e-12 * np.abs(ref).max()
    grid = torch.tensor(r).reshape((2 if kind == "monolithic" else 1, *mesh.node_shape))
    assert np.array_equal(got.apply_grid(grid).reshape(-1).numpy(), z)


def _manufactured(element, cells):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    ex = jms.exact_expressions if mesh.dim == 2 else jms.exact_expressions_3d
    _, p1, _, p2 = ex(mesh, JParams())
    coords = [jnp.asarray(c) for c in mesh.coordinates()]
    return np.asarray(p1(*coords)), np.asarray(p2(*coords))


def _jax_solve(element, cells, g1, g2, params):
    _, jV = jspaces_of(jmesh.StructuredMesh(cells=cells, element=element))
    W = jmixed(jV)
    bcs = [JBC(W.sub(0), jnp.asarray(g1)), JBC(W.sub(1), jnp.asarray(g2))]
    return jsolve_dpp(W, JParams(), bcs, solver_parameters=params)


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


# published: notebooks/results-conforming-2d/petsc_profiling/petsc_perf_breakdown.csv
# (GMRES + ILU PC); 3D: the natural-order structured ILU's own count (the
# published 3D row comes from the RCM ordering-parity ILU, ROADMAP slice 6)
GMRES_ILU = [("quad", (4, 4), 5), ("quad", (8, 8), 7), ("quad", (16, 16), 11),
             ("quad", (32, 32), 20), ("tet", (4, 4, 4), 4)]


@pytest.mark.parametrize("element,cells,count", GMRES_ILU, ids=[f"{e}{c[0]}" for e, c, _ in GMRES_ILU])
def test_gmres_ilu_counts(element, cells, count):
    g1, g2 = _manufactured(element, cells)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    assert _krylov_kind(DPPOperator(state.W, state.params), dict(_freeze(sp.GMRES_ILU_PARAMS))) == K7
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=sp.GMRES_ILU_PARAMS)
    assert sol.iteration_number == count
    assert all(bool(torch.isfinite(d).all()) for d in sol.solution.data)


@pytest.mark.parametrize("element,cells,count", [("quad", (4, 4), 5), ("quad", (8, 8), 7), ("tet", (4, 4, 4), 4)],
                         ids=["quad4", "quad8", "tet4"])
def test_gmres_ilu_matches_jax(jax_f64_ilu, element, cells, count):
    """Both sides run GMRES with an f64 ILU on the same system: the same
    count, solutions within 1e-10 (the trisolves sum in two orders)."""
    g1, g2 = _manufactured(element, cells)
    ref = _jax_solve(element, cells, g1, g2, jsp.GMRES_ILU_PARAMS)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=sp.GMRES_ILU_PARAMS)
    assert sol.iteration_number == int(ref.iteration_number) == count
    for a, b in zip(sol.solution.data, ref.solution.data):
        assert _rel(a.numpy(), b) <= 1e-10
    assert abs(sol.residual_error - float(ref.residual_error)) <= 1e-6 * float(ref.residual_error)


@pytest.mark.parametrize("trisolve", ["partri", "wavefront"])
def test_host_route_count_equals_k7_twin(trisolve):
    """``_monolithic_pc`` (ilu, on either trisolve backend) with the host
    ``krylov.gmres``, called directly, against the K7 twin (its wavefront
    sweep) on the solver's own right-hand side."""
    g1, g2 = _manufactured("quad", (16, 16))
    state = from_numpy_state({}, (16, 16), "quad", g1, g2, device="cpu")
    op = DPPOperator(state.W, state.params)
    b1, b2 = op.lifted_rhs(*state.grids)
    bdry = op._mask_arrays[0]
    r = torch.stack(op.residual(*(torch.where(bdry, g, 0.0) for g in state.grids), b1, b2))
    kw = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    flat = dict(_freeze({**sp.GMRES_ILU_PARAMS, "trisolve_backend": trisolve}))
    host = gmres(op.stacked_matvec(), r, M_inv=_monolithic_pc(op, flat), **kw)
    twin = FusedGMRESSolver(op, "ilu", **kw).plain(r)
    assert host.iterations == twin.iterations == 11
    assert _rel(host.x.numpy(), twin.x.numpy()) <= 1e-12


@pytest.mark.parametrize("element,cells", [("quad", (8, 8)), ("tet", (4, 4, 4))], ids=["quad8", "tet4"])
def test_preonly_ilu_matches_jax(trisolve, element, cells):
    params = {"ksp_type": "preonly", "pc_type": "ilu"}
    g1, g2 = _manufactured(element, cells)
    ref = _jax_solve(element, cells, g1, g2, params)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters={**params, "trisolve_backend": trisolve})
    assert (sol.iteration_number, sol.residual_error) == (1, 0.0)
    for a, b in zip(sol.solution.data, ref.solution.data):
        assert _rel(a.numpy(), b) <= 1e-12


@pytest.mark.parametrize("element,cells,its", [("quad", (8, 8), 7), ("tet", (4, 4, 4), 6)], ids=["quad8", "tet4"])
def test_rcm_ilu_matches_jax(element, cells, its):
    """Formerly a raise: the ordering-parity ILU (slice 6) against the JAX
    package's solve, counts equal, fields within 1e-10 (tests in
    test_torch_parity_ilu.py hold its pieces)."""
    params = {**sp.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm"}
    g1, g2 = _manufactured(element, cells)
    ref = _jax_solve(element, cells, g1, g2, params)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    sol = solve_dpp(state.W, state.params, state.bcs, solver_parameters=params)
    assert sol.iteration_number == ref.iteration_number == its
    for a, b in zip(sol.solution.data, ref.solution.data):
        assert _rel(a.numpy(), np.asarray(b).reshape(a.shape)) <= 1e-10


@pytest.mark.parametrize(
    "params,exc,match",
    [
        ({**sp.GMRES_ILU_PARAMS, "pc_factor_levels": 1}, NotImplementedError, "ILU\\(0\\)"),
        ({"ksp_type": "preonly", "pc_type": "ilu", "pc_factor_levels": 2}, NotImplementedError, "ILU\\(0\\)"),
    ],
    ids=["levels-1", "preonly-levels-2"],
)
def test_unported_ilu_options_raise(params, exc, match):
    state = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    with pytest.raises(exc, match=match):
        solve_dpp(state.W, state.params, state.bcs, solver_parameters=params)


def test_ilu_rejects_what_it_does_not_take():
    state = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    pc = ilu.StructuredILU0.for_monolithic(state.mesh, state.params, "cpu")
    with pytest.raises(ValueError, match="built for"):
        pc.apply_flat(torch.zeros(pc.nrows, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pc.launch(torch.zeros(pc.nrows, dtype=torch.float64))


@pytest.mark.parametrize("kind", ["monolithic", "field"])
@pytest.mark.parametrize("element,cells", MESHES, ids=[f"{e}{c[0]}" for e, c in MESHES])
def test_packed_factor_is_the_factor_by_level(element, cells, kind):
    """The kernels read each side of the factor packed by level: level lv's
    block starts at items * level_ptr[lv] and holds [q][r], q the side's
    offsets in stored order (the upper side: then the diagonal), r the
    level's rows. Entry for entry it is ``factors``."""
    _, sys = _systems(element, cells, kind)
    pc = ilu.StructuredILU0(sys, "cpu")
    ptr, rows, F = pc.level_ptr.numpy(), pc.level_rows.numpy(), pc.factors.numpy()
    assert pc.max_level_rows == int(np.diff(ptr).max()) and ptr[-1] == pc.nrows
    for name, offs in (("packed_lower", pc.lower), ("packed_upper", pc.upper + (pc.center,))):
        packed = getattr(pc, name).numpy()
        assert packed.size == len(offs) * pc.nrows
        for lv in range(pc.num_levels):
            beg, end = int(ptr[lv]), int(ptr[lv + 1])
            block = packed[len(offs) * beg : len(offs) * end].reshape(len(offs), end - beg)
            assert np.array_equal(block, F[list(offs)][:, rows[beg:end]])
