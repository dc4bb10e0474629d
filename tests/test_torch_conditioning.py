"""The port's conditioning analysis (slice 7) on the CPU: ``tests/test_conditioning.py``
case for case against the port and the published CSVs, and the port held to
the JAX package on the same inputs:

- the CSR materialisations, entry for entry; ``FullMassOperator``'s matvec
  and diagonal; ``lanczos_extreme`` on the same matrix and ``v0``;
- κ in both modes against ``conditioning.csv`` (2D N=4..32, 1e-8) and
  ``conditioning_3d.csv`` (hex N=4/8, 1e-10); at 2D N=64, where k = 100
  Lanczos steps leave the monolithic and macro κ ~4e-6 short of the CSV,
  against the JAX package's Lanczos κ (1e-9).

Sparse mode runs Lanczos on the spaces' device (``device="cpu"`` here; the
card in ``chip_smoke.py``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import perphil_tpu.mesh.structured as jmesh
from perphil_tpu.experiments.iterative_bench import estimate_condition_numbers as jestimate
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops import assembly as jasm
from perphil_tpu.ops.lanczos import lanczos_extreme as jlanczos

from perphil_tpu_torch.experiments.iterative_bench import default_model_params, estimate_condition_numbers
from perphil_tpu_torch.forms import FieldBilinearForm, create_function_spaces, dpp_form, mixed_space
from perphil_tpu_torch.forms.spaces import FunctionSpace
from perphil_tpu_torch.mesh import create_cube_mesh, create_mesh
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops import assembly
from perphil_tpu_torch.ops.lanczos import lanczos_extreme, spd_extremal_eigenvalues
from perphil_tpu_torch.solvers.conditioning import (
    MatrixData,
    calculate_condition_number,
    csr_matvec,
    get_matrix_data_from_form,
)

CPU = torch.device("cpu")
RESULTS = Path(__file__).resolve().parent.parent / "notebooks"
KEYS = ("monolithic", "macro", "micro")


def _published(path: str):
    """{N: (monolithic, macro, micro)} from a published conditioning CSV."""
    rows = np.loadtxt(RESULTS / path, delimiter=",", skiprows=1, ndmin=2)
    return {int(r[0]): tuple(r[2:5]) for r in rows}


COND_2D = _published("results-conforming-2d/conditioning/conditioning.csv")
COND_3D = _published("results-conforming-3d/conditioning/conditioning_3d.csv")


def _space(mesh):
    _, V = create_function_spaces(mesh, device="cpu")
    return mixed_space(V)


def _jspace(element, cells):
    _, V = jspaces_of(jmesh.StructuredMesh(cells=cells, element=element))
    return jmixed(V)


def _check(conds, published, tol):
    for key, ref in zip(KEYS, published):
        assert abs(conds[key] - ref) / ref < tol, key


# -- tests/test_conditioning.py, case for case -------------------------------------


def test_dense_vs_sparse_on_handbuilt_spd():
    A = sp.csr_matrix(np.array([[4.0, 1.0], [1.0, 3.0]]))
    dense = calculate_condition_number(A, num_singular_values=None, use_sparse=False)
    ev = np.linalg.eigvalsh(A.toarray())
    assert abs(dense - ev[-1] / ev[0]) < 1e-12
    # n = 2: any Krylov size takes the dense route
    assert calculate_condition_number(A, 1, use_sparse=True, device="cpu") == dense


def test_matrix_data_structure():
    W = _space(create_mesh(2, 2))
    a, _ = dpp_form(W, DPPParameters())
    md = get_matrix_data_from_form(a, [])
    assert isinstance(md, MatrixData)
    assert md.number_of_dofs == W.dim() == 18
    assert md.is_symmetric
    assert md.number_of_nonzero_entries > 0
    assert md.sparse_csr_data.shape == (18, 18)
    field = get_matrix_data_from_form(FieldBilinearForm(W.sub(0), 1.0, 1.0, 1.0))
    assert field.number_of_dofs == 9 and field.is_symmetric


@pytest.mark.parametrize("use_sparse", [False, True], ids=["dense-svd", "lanczos"])
@pytest.mark.parametrize("N", [4, 8, 16, 32])
def test_condition_numbers_match_reference_2d(N, use_sparse):
    conds = estimate_condition_numbers(
        _space(create_mesh(N, N)), num_of_factors=50 if use_sparse else None, use_sparse=use_sparse
    )
    _check(conds, COND_2D[N], 1e-8)


@pytest.mark.parametrize("use_sparse", [False, True], ids=["dense-svd", "lanczos"])
@pytest.mark.parametrize("N", [4, 6, 8])
def test_condition_numbers_match_reference_3d_hex(N, use_sparse):
    W = _space(create_cube_mesh(N, N, N, hexahedral=True))
    conds = estimate_condition_numbers(W, num_of_factors=50 if use_sparse else None, use_sparse=use_sparse)
    _check(conds, COND_3D[N], 1e-10)


def test_lanczos_at_n64_matches_jax():
    """k = 100 steps from the same v0: the port's κ within 1e-9 of the JAX
    package's; both ~4.3e-6 short of the CSV in the monolithic and macro
    blocks (the route's own convergence), the micro block converged."""
    got = estimate_condition_numbers(_space(create_mesh(64, 64)), num_of_factors=50, use_sparse=True)
    ref = jestimate(_jspace("quad", (64, 64)), num_of_factors=50, use_sparse=True)
    for key, published in zip(KEYS, COND_2D[64]):
        assert abs(got[key] - ref[key]) / ref[key] < 1e-9, key
        assert abs(got[key] - published) / published < 1e-5, key


def test_sparse_conditioning_simplicial_matches_dense():
    """The inverse Lanczos through the tri/tet direct routes (K3's twin,
    ``cg``) agrees with the dense SVD."""
    W = _space(create_mesh(8, 8, quadrilateral=False))
    dense = estimate_condition_numbers(W, num_of_factors=None, use_sparse=False)
    sparse = estimate_condition_numbers(W, num_of_factors=50, use_sparse=True)
    for key in KEYS:
        assert abs(sparse[key] - dense[key]) / dense[key] < 1e-6


def test_sparse_mode_without_inverse_matches_dense():
    """Without ``inv_apply`` the smallest eigenvalue comes from the host
    shift-invert ``eigsh``, not the (interior) smallest Ritz value."""
    A, _, _ = assembly.materialize_monolithic_csr(_space(create_mesh(16, 16)), DPPParameters())
    dense = calculate_condition_number(A, None, use_sparse=False)
    sparse = calculate_condition_number(A, 5, use_sparse=True, device="cpu")
    assert abs(sparse - dense) / dense < 1e-6


def test_csr_materialization_rejects_degree_p():
    """Degree-2 spaces build on every element (Q2 on the refined lattice,
    P2 on the once-refined one); the CSR stays Q1-only, as in the JAX
    package."""
    for mesh in (create_mesh(4, 4), create_mesh(4, 4, quadrilateral=False),
                 create_cube_mesh(2, 2, 2, hexahedral=True), create_cube_mesh(2, 2, 2)):
        W2 = mixed_space(FunctionSpace(mesh, degree=2, device="cpu"))
        assert W2.spaces[0].dof_shape == tuple(2 * c + 1 for c in reversed(mesh.cells))
        with pytest.raises(NotImplementedError, match="Q1"):
            assembly.materialize_monolithic_csr(W2, DPPParameters())


# -- the port against the JAX package on the same inputs ----------------------------

MESHES = [("quad", (4, 5)), ("triangle", (4, 4)), ("hex", (3, 3, 2)), ("tet", (3, 3, 3))]
IDS = [e for e, _ in MESHES]


@pytest.mark.parametrize("element,cells", MESHES, ids=IDS)
def test_csr_equals_jax(element, cells):
    W = _space(StructuredMesh(cells=cells, element=element))
    jW = _jspace(element, cells)
    p = default_model_params()
    A, n0, n1 = assembly.materialize_monolithic_csr(W, p)
    jA, jn0, jn1 = jasm.materialize_monolithic_csr(jW, JParams(**vars(p)))
    assert (n0, n1) == (jn0, jn1)
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(A, name), getattr(jA, name)), name
    F = assembly.materialize_field_csr(assembly.FieldOperator(W.sub(1), p.k2, p.beta, p.mu))
    jF = jasm.materialize_field_csr(jasm.FieldOperator(jW.sub(1), p.k2, p.beta, p.mu))
    assert (F != jF).nnz == 0 and np.array_equal(F.indices, jF.indices)


@pytest.mark.parametrize("element,cells", MESHES, ids=IDS)
def test_full_mass_operator_matches_jax(element, cells):
    mesh = StructuredMesh(cells=cells, element=element)
    u = np.random.default_rng(5).standard_normal(mesh.node_shape)
    op = assembly.FullMassOperator(mesh, device="cpu")
    jop = jasm.FullMassOperator(jmesh.StructuredMesh(cells=cells, element=element))
    y, jy = op.matvec(torch.tensor(u)).numpy(), np.asarray(jop.matvec(jnp.asarray(u)))
    assert np.abs(y - jy).max() <= 1e-14 * np.abs(jy).max()
    d, jd = op.diagonal(), np.asarray(jop.diagonal())
    assert d.device == CPU and np.abs(d.numpy() - jd).max() <= 1e-14 * np.abs(jd).max()


@pytest.mark.parametrize("num_iters", [20, 100])
def test_lanczos_extreme_matches_jax(num_iters):
    """The same CSR matrix (2D N=8 monolithic, 162 rows), the same seed:
    Ritz values within 1e-10 relative; with the fast-diag inverse the
    extremes are the matrix's eigenvalues."""
    W = _space(create_mesh(8, 8))
    A, n0, _ = assembly.materialize_monolithic_csr(W, default_model_params())
    data, cols = jnp.asarray(A.data), jnp.asarray(A.indices)
    rows = jnp.asarray(np.repeat(np.arange(A.shape[0]), np.diff(A.indptr)))

    def jmv(x):
        return jnp.zeros(A.shape[0], dtype=x.dtype).at[rows].add(data * x[cols])

    got = lanczos_extreme(csr_matvec(A, CPU), A.shape[0], num_iters, seed=3, device="cpu")
    ref = jlanczos(jmv, A.shape[0], num_iters, seed=3)
    for a, b in zip(got, ref):
        assert abs(a - b) <= 1e-10 * abs(b)
    ev = np.linalg.eigvalsh(A.toarray())
    assert ev[0] - 1e-9 <= got[1] <= got[0] <= ev[-1] + 1e-9
    if num_iters == 100:
        from perphil_tpu_torch.experiments.iterative_bench import _inverses

        inv_mono = _inverses(W, default_model_params(), n0)[0]
        lam_max, lam_min = spd_extremal_eigenvalues(csr_matvec(A, CPU), A.shape[0], inv_mono, device="cpu")
        assert abs(lam_max - ev[-1]) <= 1e-10 * ev[-1] and abs(lam_min - ev[0]) <= 1e-10 * ev[0]
