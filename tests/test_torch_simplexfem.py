"""The port's P2 spaces on simplex meshes (``ops/simplexfem.py``) on the CPU,
held to the JAX package on the same inputs (numpy from a seed):

- the element matrices, class stencils, quadrature tables and the host CSR
  (``assemble_p2_monolithic``) equal the JAX package's entry for entry;
- the P2 matvec, lift and Jacobi diagonal against the assembled CSR and the
  JAX operator in 2D and 3D: <= 1e-12 relative;
- ``solve_dpp`` with preonly + lu (the host ``splu`` stage) at tri N=4/8
  and tet nx=2, and GMRES + jacobi at tri N=4, against the JAX package
  (equal counts, fields <= 1e-10, the P2 error norms <= 1e-12); GMRES +
  jacobi (rtol 1e-12) against the direct solve at tri N=4/8 (errors
  <= 1e-8) and tet nx=2 (fields <= 1e-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.ops.simplexfem as jsf
import perphil_tpu.utils.quadrature as jquad
from perphil_tpu.forms.spaces import FunctionSpace as JFunctionSpace, mixed_space as jmixed
from perphil_tpu.mesh.structured import create_cube_mesh as jcube, create_mesh as jcreate
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC
from perphil_tpu.solvers import solve_dpp as jsolve_dpp
from perphil_tpu.utils import manufactured_solutions as jms
from perphil_tpu.utils.postprocessing import h1_seminorm_error as jh1, l2_error as jl2

import perphil_tpu_torch.ops.simplexfem as sf
import perphil_tpu_torch.utils.quadrature as quad
from perphil_tpu_torch.forms.spaces import FunctionSpace, mixed_space
from perphil_tpu_torch.mesh import create_cube_mesh, create_mesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC
from perphil_tpu_torch.ops.element import cell_subcells
from perphil_tpu_torch.solvers import solve_dpp
from perphil_tpu_torch.solvers.parameters import LINEAR_SOLVER_PARAMS
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions
from perphil_tpu_torch.utils.postprocessing import h1_seminorm_error, l2_error

PARAMS = DPPParameters()
GMRES_JACOBI = {"ksp_type": "gmres", "pc_type": "jacobi", "ksp_rtol": 1e-12, "ksp_max_it": 5000}
MESHES = {"tri": ((4, 3), create_mesh, jcreate, {"quadrilateral": False}),
          "tet": ((3, 2, 2), create_cube_mesh, jcube, {})}


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _meshes(name):
    cells, make, jmake, kw = MESHES[name]
    return make(*cells, **kw), jmake(*cells, **kw)


@pytest.mark.parametrize("name", list(MESHES))
def test_tables_equal_jax(name):
    mesh, jm = _meshes(name)
    for verts, _, _ in cell_subcells(mesh.element, mesh.h):
        for a, b in zip(sf.p2_simplex_matrices(verts, mesh.h)[1:], jsf.p2_simplex_matrices(verts, jm.h)[1:]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(sf.p2_class_stencils(mesh), jsf.p2_class_stencils(jm)):
        np.testing.assert_array_equal(a, b)
    assert quad.cell_quadrature_p2(mesh, 6) == tuple(
        quad.QPoint(**{k: getattr(q, k) for k in quad.QPoint.__dataclass_fields__})
        for q in jquad.cell_quadrature_p2(jm, 6)
    )
    A, jA = sf.assemble_p2_monolithic(mesh, PARAMS), jsf.assemble_p2_monolithic(jm, JParams())
    assert abs(A - jA).max() == 0.0 and A.nnz == jA.nnz
    assert sf.p2_dof_mesh(mesh).node_shape == FunctionSpace(mesh, degree=2, device="cpu").dof_shape


@pytest.mark.parametrize("name", list(MESHES))
def test_matvec_matches_csr_and_jax(name):
    mesh, jm = _meshes(name)
    op = sf.P2SimplexDPPOperator(mesh, PARAMS, device="cpu")
    jop = jsf.P2SimplexDPPOperator(jm, JParams())
    shape = op.dof_shape
    assert shape == jop.dof_shape
    x = np.random.default_rng(0).standard_normal((2,) + shape)
    y = torch.stack(op.matvec(*torch.from_numpy(x))).numpy()
    jy = np.stack([np.asarray(v) for v in jop.matvec(jnp.asarray(x[0]), jnp.asarray(x[1]))])
    A = sf.assemble_p2_monolithic(mesh, PARAMS)
    assert rel(y, jy) <= 1e-12
    assert rel(y.ravel(), A @ x.ravel()) <= 1e-12
    b = torch.stack(op.lifted_rhs(*torch.from_numpy(x))).numpy()
    jb = np.stack([np.asarray(v) for v in jop.lifted_rhs(jnp.asarray(x[0]), jnp.asarray(x[1]))])
    assert rel(b, jb) <= 1e-12
    assert rel(op.diagonal_stacked().numpy().ravel(), A.diagonal()) <= 1e-12
    assert rel(op.diagonal_stacked(), np.asarray(jop.diagonal_stacked())) <= 1e-12


@pytest.mark.parametrize("N", [4, 8])
def test_p2_tri_direct_and_gmres_match_jax(N):
    """P2 on triangles: the host splu stage against the JAX package's, GMRES
    + jacobi against the JAX package's at N=4 (its GMRES compiles per mesh),
    and the two solves' errors against each other."""
    mesh, jm = create_mesh(N, N, quadrilateral=False), jcreate(N, N, quadrilateral=False)
    W, jW = mixed_space(FunctionSpace(mesh, degree=2, device="cpu")), jmixed(JFunctionSpace(jm, degree=2))
    _, p1, _, p2 = exact_expressions(mesh, PARAMS)
    _, jp1, _, jp2 = jms.exact_expressions(jm, JParams())
    bcs, jbcs = [DirichletBC(W.sub(0), p1), DirichletBC(W.sub(1), p2)], [JBC(jW.sub(0), jp1), JBC(jW.sub(1), jp2)]
    errs = []
    for opts in (LINEAR_SOLVER_PARAMS, GMRES_JACOBI):
        sol = solve_dpp(W, PARAMS, bcs, solver_parameters=opts)
        assert sol.solution.data[0].device == torch.device("cpu")
        p1h = sol.solution.sub(0)
        e = (l2_error(p1h, p1), h1_seminorm_error(p1h, p1))
        if opts is LINEAR_SOLVER_PARAMS or N == 4:
            jsol = jsolve_dpp(jW, JParams(), jbcs, solver_parameters=opts)
            assert sol.iteration_number == jsol.iteration_number
            for a, b in zip(sol.solution.data, jsol.solution.data):
                assert rel(a, b) <= 1e-10
            jp1h = jsol.solution.sub(0)
            for g, w in zip(e, (jl2(jp1h, jp1), jh1(jp1h, jp1))):
                assert abs(g - w) / w <= 1e-12
        errs.append(e)
    assert sol.iteration_number > 1
    for a, b in zip(*errs):
        assert abs(a - b) / b <= 1e-8


def test_p2_3d_matches_jax():
    """P2 on tets: the direct solve against the JAX package's, GMRES +
    jacobi against the direct solve."""
    mesh, jm = create_cube_mesh(2, 2, 2), jcube(2, 2, 2)
    W, jW = mixed_space(FunctionSpace(mesh, degree=2, device="cpu")), jmixed(JFunctionSpace(jm, degree=2))
    g = np.random.default_rng(1).standard_normal((2,) + W.spaces[0].dof_shape)
    bcs = [DirichletBC(W.sub(i), torch.from_numpy(g[i])) for i in (0, 1)]
    sol = solve_dpp(W, PARAMS, bcs, solver_parameters=LINEAR_SOLVER_PARAMS)
    jsol = jsolve_dpp(jW, JParams(), [JBC(jW.sub(i), jnp.asarray(g[i])) for i in (0, 1)],
                      solver_parameters=LINEAR_SOLVER_PARAMS)
    gm = solve_dpp(W, PARAMS, bcs, solver_parameters=GMRES_JACOBI)
    assert gm.iteration_number > 1
    for a, b, c in zip(sol.solution.data, jsol.solution.data, gm.solution.data):
        assert rel(a, b) <= 1e-10 and rel(c, a) <= 1e-8


def test_p2_option_paths():
    mesh = create_mesh(3, 3, quadrilateral=False)
    W = mixed_space(FunctionSpace(mesh, degree=2, device="cpu"))
    with pytest.raises(ValueError, match="none/jacobi/preonly"):
        solve_dpp(W, PARAMS, [], solver_parameters={"ksp_type": "gmres", "pc_type": "ilu"})
    with pytest.raises(ValueError, match="pc_type=lu"):
        solve_dpp(W, PARAMS, [], solver_parameters={"ksp_type": "preonly", "pc_type": "jacobi"})
    with pytest.raises(ValueError, match="simplex meshes"):
        sf.P2SimplexDPPOperator(create_mesh(3, 3), PARAMS, device="cpu")
    with pytest.raises(NotImplementedError, match="slice 9"):
        sf.P2SimplexDPPOperator(mesh, PARAMS, padding=(1, 0), device="cpu")
