"""The port's degree-p tensor-product spaces (``ops/tensorfem.py``) on the
CPU, held to the JAX package on the same inputs (numpy from a seed) and to
the published Qp rows:

- the 1D matrices and eigenbases equal the JAX package's;
- the Qp matvec at p = 1, 2, 3 against the JAX ``TensorDPPOperator`` and the
  dense Kronecker matrix: <= 1e-12 relative; the degree-1 operator against
  the port's ``DPPOperator``: <= 1e-12;
- ``TensorFastDiagDPP``: relative residual <= 1e-11, and against the JAX
  solve <= 1e-11;
- ``errornorm_p`` (l2, h1s, a Function-valued exact) against the JAX
  function: <= 1e-12 relative;
- ``solve_dpp`` at degree 2 with preonly + lu, GMRES + jacobi and GMRES +
  fieldsplit against the JAX package (equal counts, fields <= 1e-10), and
  Q2/Q3 at N=4 against ``convergence_qp.csv`` and the JAX package (<= 1e-12;
  the JAX package reproduces the CSV exactly on the CPU).
"""

import csv
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.ops.tensorfem as jtf
from perphil_tpu.forms.spaces import FunctionSpace as JFunctionSpace, mixed_space as jmixed
from perphil_tpu.forms.spaces import Function as JFunction
from perphil_tpu.mesh.structured import create_cube_mesh as jcube, create_mesh as jcreate
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC
from perphil_tpu.solvers import solve_dpp as jsolve_dpp, solve_dpp_nonlinear as jsolve_dpp_nonlinear
from perphil_tpu.utils import manufactured_solutions as jms
from perphil_tpu.utils.postprocessing import h1_seminorm_error as jh1, l2_error as jl2

import perphil_tpu_torch.ops.tensorfem as tf
from perphil_tpu_torch.forms.spaces import Function, FunctionSpace, create_function_spaces, mixed_space
from perphil_tpu_torch.mesh import create_cube_mesh, create_mesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator
from perphil_tpu_torch.solvers import solve_dpp, solve_dpp_nonlinear
from perphil_tpu_torch.solvers.parameters import KSP_PREONLY_PARAMS, LINEAR_SOLVER_PARAMS, PICARD_LU_SOLVER_PARAMS
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions, exact_expressions_3d
from perphil_tpu_torch.utils.postprocessing import h1_seminorm_error, l2_error

CPU = torch.device("cpu")
PARAMS = DPPParameters()
QP_CSV = Path(__file__).resolve().parent.parent / "notebooks/results-conforming-2d/convergence_qp.csv"


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _meshes(dim, n):
    if dim == 2:
        return create_mesh(n, n), jcreate(n, n)
    return create_cube_mesh(n, n, n, hexahedral=True), jcube(n, n, n, hexahedral=True)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_1d_matrices_equal_jax(p):
    for a, b in zip(tf.lagrange_ref_matrices(p), jtf.lagrange_ref_matrices(p)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tf.assemble_1d(p, 3, 1 / 3), jtf.assemble_1d(p, 3, 1 / 3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tf.interior_eig_1d(p, 3, 1 / 3), jtf.interior_eig_1d(p, 3, 1 / 3)):
        np.testing.assert_array_equal(a, b)


def _dense(op, p, N, h):
    """The dense Kronecker-assembled monolithic matrix with symmetric BC
    elimination (2D, y the outer factor)."""
    Kx, Mx = tf.assemble_1d(p, N, h)
    K2 = np.kron(Kx, Mx) + np.kron(Mx, Kx)
    M2 = np.kron(Mx, Mx)
    pr = PARAMS
    A = np.block([
        [(pr.k1 / pr.mu) * K2 + (pr.beta / pr.mu) * M2, -(pr.beta / pr.mu) * M2],
        [-(pr.beta / pr.mu) * M2, (pr.k2 / pr.mu) * K2 + (pr.beta / pr.mu) * M2],
    ])
    bd = np.concatenate([op.boundary_mask.ravel()] * 2)
    A[bd] = 0.0
    A[:, bd] = 0.0
    A[np.where(bd)[0], np.where(bd)[0]] = 1.0
    return A


@pytest.mark.parametrize("p", [1, 2, 3])
def test_matvec_matches_jax_and_dense_kron(p):
    N = 3
    mesh, jm = _meshes(2, N)
    op = tf.TensorDPPOperator(mesh, PARAMS, p, device="cpu")
    jop = jtf.TensorDPPOperator(jm, JParams(), degree=p)
    shape = op.dof_shape
    assert shape == jop.dof_shape
    np.testing.assert_array_equal(op.boundary_mask, np.asarray(jop.boundary_mask))
    x = np.random.default_rng(0).standard_normal((2,) + shape)
    y = torch.stack(op.matvec(*torch.from_numpy(x))).numpy()
    jy = np.stack([np.asarray(v) for v in jop.matvec(jnp.asarray(x[0]), jnp.asarray(x[1]))])
    assert rel(y, jy) <= 1e-12
    assert rel(y.ravel(), _dense(op, p, N, mesh.h[0]) @ x.ravel()) <= 1e-12
    b = torch.stack(op.lifted_rhs(*torch.from_numpy(x))).numpy()
    jb = np.stack([np.asarray(v) for v in jop.lifted_rhs(jnp.asarray(x[0]), jnp.asarray(x[1]))])
    assert rel(b, jb) <= 1e-12
    d = op.diagonal_stacked().numpy()
    assert rel(d.ravel(), np.diag(_dense(op, p, N, mesh.h[0]))) <= 1e-12


def test_hex_q2_matvec_matches_jax():
    mesh, jm = _meshes(3, 2)
    op = tf.TensorDPPOperator(mesh, PARAMS, 2, device="cpu")
    jop = jtf.TensorDPPOperator(jm, JParams(), degree=2)
    x = np.random.default_rng(1).standard_normal((2,) + op.dof_shape)
    y = torch.stack(op.matvec(*torch.from_numpy(x))).numpy()
    jy = np.stack([np.asarray(v) for v in jop.matvec(jnp.asarray(x[0]), jnp.asarray(x[1]))])
    assert rel(y, jy) <= 1e-12


def test_degree1_matches_stencil_operator():
    mesh = create_mesh(5, 5)
    _, V = create_function_spaces(mesh, device="cpu")
    z = torch.from_numpy(np.random.default_rng(2).standard_normal((2,) + mesh.node_shape))
    ys = DPPOperator(mixed_space(V), PARAMS).matvec(z[0], z[1])
    yt = tf.TensorDPPOperator(mesh, PARAMS, 1, device="cpu").matvec(z[0], z[1])
    for a, b in zip(yt, ys):
        assert rel(a, b) <= 1e-12


@pytest.mark.parametrize("dim,p", [(2, 1), (2, 2), (2, 3), (3, 2)])
def test_fast_diag_solve(dim, p):
    mesh, jm = _meshes(dim, 4 if dim == 2 else 2)
    op = tf.TensorDPPOperator(mesh, PARAMS, p, device="cpu")
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((2,) + op.dof_shape))
    b1, b2 = op.lifted_rhs(g[0], g[1])
    z1, z2 = tf.TensorFastDiagDPP(mesh, PARAMS, p, device="cpu").solve(b1, b2)
    r = torch.stack(op.residual(z1, z2, b1, b2))
    assert float(r.norm() / torch.stack([b1, b2]).norm()) <= 1e-11
    bd = torch.as_tensor(op.boundary_mask)
    assert torch.equal(z1[bd], g[0][bd])
    jz = jtf.TensorFastDiagDPP(jm, JParams(), degree=p).solve(jnp.asarray(b1.numpy()), jnp.asarray(b2.numpy()))
    for a, b in zip((z1, z2), jz):
        assert rel(a, b) <= 1e-11


def _lattice(mesh, p):
    xs = [np.linspace(0.0, 1.0, p * c + 1) for c in mesh.cells]
    grids = np.meshgrid(*reversed(xs), indexing="ij")
    return tuple(reversed(grids))


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("kind", ["l2", "h1s"])
def test_errornorm_p_matches_jax(p, kind):
    mesh, jm = _meshes(2, 4)
    _, p1, _, _ = exact_expressions(mesh, PARAMS)
    _, jp1, _, _ = jms.exact_expressions(jm, JParams())
    X, Y = _lattice(mesh, p)
    u = np.sin(3.0 * X) * np.cos(2.0 * Y) + 40.0 * X * Y  # not the exact solution: a nonzero error
    got = tf.errornorm_p(torch.from_numpy(u), p1, mesh, p, kind)
    want = jtf.errornorm_p(jnp.asarray(u), jp1, jm, p, kind)
    assert abs(got - want) / want <= 1e-12
    # a Function-valued exact: the norm of the difference field
    V, jV = FunctionSpace(mesh, degree=p, device="cpu"), JFunctionSpace(jm, degree=p)
    f, g = Function(V, torch.from_numpy(u)), Function(V, torch.from_numpy(1.001 * u))
    jf, jg = JFunction(jV, jnp.asarray(u)), JFunction(jV, jnp.asarray(1.001 * u))
    norm, jnorm = (l2_error, jl2) if kind == "l2" else (h1_seminorm_error, jh1)
    assert abs(norm(f, g) - jnorm(jf, jg)) / jnorm(jf, jg) <= 1e-12
    assert norm(f, f) == 0.0
    with pytest.raises(TypeError):
        norm(f, Function(FunctionSpace(create_mesh(2, 2), degree=p, device="cpu")))


def _q2_problem(N, p, quad_solver):
    mesh, jm = create_mesh(N, N), jcreate(N, N)
    W, jW = mixed_space(FunctionSpace(mesh, degree=p, device="cpu")), jmixed(JFunctionSpace(jm, degree=p))
    _, p1, _, p2 = exact_expressions(mesh, PARAMS)
    _, jp1, _, jp2 = jms.exact_expressions(jm, JParams())
    sol = solve_dpp(W, PARAMS, [DirichletBC(W.sub(0), p1), DirichletBC(W.sub(1), p2)],
                    solver_parameters=quad_solver)
    jsol = jsolve_dpp(jW, JParams(), [JBC(jW.sub(0), jp1), JBC(jW.sub(1), jp2)], solver_parameters=quad_solver)
    return sol, jsol, (p1, p2), (jp1, jp2)


Q2_SOLVERS = {
    "preonly-lu": LINEAR_SOLVER_PARAMS,
    "gmres-jacobi": {"ksp_type": "gmres", "ksp_rtol": 1e-10, "ksp_max_it": 5000, "pc_type": "jacobi"},
    "gmres-fieldsplit": {"ksp_type": "gmres", "ksp_rtol": 1e-8, "pc_type": "fieldsplit",
                         "pc_fieldsplit_type": "multiplicative"},
}


@pytest.mark.parametrize("name", list(Q2_SOLVERS))
def test_q2_solve_dpp_matches_jax(name):
    sol, jsol, _, _ = _q2_problem(4, 2, Q2_SOLVERS[name])
    assert sol.iteration_number == jsol.iteration_number
    assert sol.iteration_number == {"preonly-lu": 1, "gmres-fieldsplit": 4}.get(name, sol.iteration_number)
    assert sol.solution.data[0].shape == (9, 9) and sol.solution.data[0].device == CPU
    for a, b in zip(sol.solution.data, jsol.solution.data):
        assert rel(a, b) <= 1e-10


def _published_qp():
    with QP_CSV.open() as f:
        return {(int(r["degree"]), int(r["N"])): (float(r["e1_L2"]), float(r["e1_H1s"])) for r in csv.DictReader(f)}


@pytest.mark.parametrize("p", [2, 3])
def test_qp_rows_match_published_and_jax(p):
    """Q2/Q3 at N=4 with the direct solve: (e1_L2, e1_H1s) against
    ``convergence_qp.csv`` and the JAX package (which meets the CSV
    exactly) within 1e-12."""
    sol, jsol, (p1, _), (jp1, _) = _q2_problem(4, p, LINEAR_SOLVER_PARAMS)
    p1h, jp1h = sol.solution.split()[0], jsol.solution.split()[0]
    got = (l2_error(p1h, p1), h1_seminorm_error(p1h, p1))
    want = (jl2(jp1h, jp1), jh1(jp1h, jp1))
    for g, w, pub in zip(got, want, _published_qp()[(p, 4)]):
        assert abs(g - w) / w <= 1e-12 and abs(g - pub) / pub <= 1e-12


def test_q2_hex_direct_matches_jax():
    mesh, jm = _meshes(3, 2)
    W, jW = mixed_space(FunctionSpace(mesh, degree=2, device="cpu")), jmixed(JFunctionSpace(jm, degree=2))
    _, p1, _, p2 = exact_expressions_3d(mesh, PARAMS)
    _, jp1, _, jp2 = jms.exact_expressions_3d(jm, JParams())
    sol = solve_dpp(W, PARAMS, [DirichletBC(W.sub(0), p1), DirichletBC(W.sub(1), p2)],
                    solver_parameters=LINEAR_SOLVER_PARAMS)
    jsol = jsolve_dpp(jW, JParams(), [JBC(jW.sub(0), jp1), JBC(jW.sub(1), jp2)],
                      solver_parameters=LINEAR_SOLVER_PARAMS)
    for a, b in zip(sol.solution.data, jsol.solution.data):
        assert rel(a, b) <= 1e-11
    assert abs(l2_error(sol.solution.sub(0), p1) - jl2(jsol.solution.sub(0), jp1)) <= 1e-12 * jl2(
        jsol.solution.sub(0), jp1)


def test_degree_p_option_paths():
    """ILU is refused, ksponly runs the degree-p linear solve (iteration 1,
    the true residual), the Picard solves refuse degree p, and the
    sharding's padding grows the lattice (a bad tuple is refused)."""
    mesh = create_mesh(4, 4)
    W = mixed_space(FunctionSpace(mesh, degree=2, device="cpu"))
    _, p1, _, p2 = exact_expressions(mesh, PARAMS)
    bcs = [DirichletBC(W.sub(0), p1), DirichletBC(W.sub(1), p2)]
    with pytest.raises(ValueError, match="pc_type=ilu has no degree-2"):
        solve_dpp(W, PARAMS, bcs, solver_parameters={"ksp_type": "gmres", "pc_type": "ilu"})
    ksponly = {"snes_type": "ksponly", **Q2_SOLVERS["gmres-fieldsplit"]}
    sol = solve_dpp_nonlinear(W, PARAMS, bcs, solver_parameters=ksponly)
    jW = jmixed(JFunctionSpace(jcreate(4, 4), degree=2))
    _, jp1, _, jp2 = jms.exact_expressions(jW.mesh, JParams())
    jsol = jsolve_dpp_nonlinear(jW, JParams(), [JBC(jW.sub(0), jp1), JBC(jW.sub(1), jp2)], solver_parameters=ksponly)
    assert sol.iteration_number == jsol.iteration_number == 1
    # the true residual after the solve: cancellation in b - A x
    assert abs(sol.residual_error - jsol.residual_error) <= 1e-6 * jsol.residual_error
    for a, b in zip(sol.solution.data, jsol.solution.data):
        assert rel(a, b) <= 1e-10
    with pytest.raises(ValueError, match="pc_type=lu only"):
        solve_dpp_nonlinear(W, PARAMS, bcs, solver_parameters=KSP_PREONLY_PARAMS)
    with pytest.raises(ValueError, match="ksponly"):
        solve_dpp_nonlinear(W, PARAMS, bcs, solver_parameters=PICARD_LU_SOLVER_PARAMS)
    assert tf.TensorDPPOperator(mesh, PARAMS, 2, padding=(1, 0), device="cpu").dof_shape == (10, 9)
    with pytest.raises(ValueError, match="nonneg ints"):
        tf.TensorDPPOperator(mesh, PARAMS, 2, padding=(1,), device="cpu")
