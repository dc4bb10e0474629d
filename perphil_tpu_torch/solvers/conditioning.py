"""Conditioning analysis of assembled DPP matrices.

Counterpart of ``perphil_tpu/solvers/conditioning.py`` (the reference's
``perphil/solvers/conditioning.py``): ``MatrixData``,
``assemble_bilinear_form``, ``get_matrix_data_from_form`` and
``calculate_condition_number``.

The matrices are host scipy CSR (``ops/assembly.py::materialize_*_csr``).
Dense mode is the reference's: the full SVD on the host (scipy ``svd``),
singular values filtered by ``zero_tol``. Sparse mode runs Lanczos on the
card (``ops/lanczos.py``) with the CSR matvec on tensors there (a gather and
an ``index_add_``): ``sigma_max`` from Lanczos on A, ``sigma_min`` from
Lanczos on the exact inverse ``inv_apply`` where one is given, else from the
host shift-invert ``eigsh``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import scipy.sparse as sp
import torch
from scipy.linalg import svd

from perphil_tpu_torch.config import DeviceLike, default_dtype, resolve_device
from perphil_tpu_torch.forms.dpp import DPPBilinearForm, FieldBilinearForm
from perphil_tpu_torch.ops.assembly import DirichletBC, materialize_field_csr, materialize_monolithic_csr
from perphil_tpu_torch.ops.lanczos import spd_extremal_eigenvalues

DEFAULT_CONDITION_NUMBER_TOLERANCE = 1e-7


@dataclass(frozen=True)
class MatrixData:
    """Assembled-matrix metadata (the reference's ``MatrixData``); the
    PETSc handle is the scipy CSR itself."""

    assembled_matrix: sp.csr_matrix
    is_symmetric: bool
    sparse_csr_data: sp.csr_matrix
    number_of_nonzero_entries: int
    number_of_dofs: int
    symmetry_tolerance: float


def assemble_bilinear_form(
    form: Union[DPPBilinearForm, FieldBilinearForm],
    boundary_conditions: Optional[Sequence[DirichletBC]] = None,
) -> sp.csr_matrix:
    """A form descriptor as CSR with symmetric BC elimination. Only
    whole-boundary Dirichlet conditions exist in this library, so
    ``boundary_conditions`` selects nothing: the elimination is always
    applied, as at every reference call site."""
    if isinstance(form, DPPBilinearForm):
        A, _, _ = materialize_monolithic_csr(form.W, form.params)
        return A
    return materialize_field_csr(form.operator())


def get_matrix_data_from_form(
    form: Union[DPPBilinearForm, FieldBilinearForm],
    boundary_conditions: Optional[Sequence[DirichletBC]] = None,
    symmetry_tolerance: float = 1e-8,
) -> MatrixData:
    """Assemble the form and describe the matrix."""
    A = assemble_bilinear_form(form, boundary_conditions)
    A.eliminate_zeros()
    diff = abs(A - A.T)
    is_symmetric = diff.max() <= symmetry_tolerance if diff.nnz else True
    nrows, ncols = A.shape
    if nrows != ncols:
        raise ValueError(f"the assembled matrix is {nrows} x {ncols}, not square")
    return MatrixData(
        assembled_matrix=A,
        is_symmetric=bool(is_symmetric),
        sparse_csr_data=A,
        number_of_nonzero_entries=int(A.nnz),
        number_of_dofs=int(nrows),
        symmetry_tolerance=symmetry_tolerance,
    )


def _dense_condition_number(M: np.ndarray, zero_tol: float) -> float:
    svals = np.asarray(svd(M, compute_uv=False, check_finite=False))
    svals = svals[svals > zero_tol]
    if svals.size == 0:
        return float("inf")
    return float(svals.max() / svals.min())


def csr_matvec(A: sp.csr_matrix, device: torch.device) -> Callable[[torch.Tensor], torch.Tensor]:
    """``x -> A x`` on flat f64 tensors on ``device``: each entry's product
    gathered, then summed into its row (``index_add_``)."""
    A = A.tocsr()
    nrows = A.shape[0]
    data = torch.as_tensor(A.data, dtype=default_dtype(), device=device)
    cols = torch.as_tensor(A.indices.astype(np.int64), device=device)
    rows = torch.as_tensor(np.repeat(np.arange(nrows), np.diff(A.indptr)), device=device)
    return lambda x: x.new_zeros(nrows).index_add_(0, rows, data * x[cols])


def calculate_condition_number(
    scipy_csr_sparse_matrix: sp.csr_matrix,
    num_singular_values: Optional[int],
    use_sparse: bool = False,
    zero_tol: float = DEFAULT_CONDITION_NUMBER_TOLERANCE,
    inv_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    device: DeviceLike = None,
) -> float:
    """The condition number from the extreme singular values.

    Dense mode (``use_sparse`` false, or ``num_singular_values`` None, <= 0
    or >= n - 1): the full SVD on the host with ``zero_tol`` filtering.
    Sparse mode: Lanczos on ``device`` (the card unless the CPU is asked
    for) with k = max(2 num_singular_values, 60); ``inv_apply``, an exact
    inverse on flat tensors there, gives sigma_min by inverse Lanczos;
    without it the smallest eigenvalue comes from the host shift-invert
    ``eigsh`` (a Ritz value of A alone can overestimate it by orders of
    magnitude), and from the dense SVD if that fails.
    """
    nrows, ncols = scipy_csr_sparse_matrix.shape
    nmin = min(nrows, ncols)
    if nmin == 0:
        return float("nan")
    if (
        (not use_sparse)
        or (num_singular_values is None)
        or (num_singular_values <= 0)
        or (int(num_singular_values) >= nmin - 1)
    ):
        return _dense_condition_number(scipy_csr_sparse_matrix.toarray(), zero_tol)

    A = scipy_csr_sparse_matrix.tocsr()
    dev = resolve_device(device)
    k = int(max(2 * num_singular_values, 60))
    lam_max, lam_min = spd_extremal_eigenvalues(csr_matvec(A, dev), nrows, inv_apply=inv_apply, num_iters=k, device=dev)
    lam_min = abs(lam_min)
    if inv_apply is None:
        from scipy.sparse.linalg import ArpackError, ArpackNoConvergence, eigsh

        try:
            w = eigsh(A, k=1, sigma=0.0, which="LM", return_eigenvectors=False, maxiter=20000, tol=1e-8)
            lam_min = float(abs(w[0]))
        except (ArpackError, ArpackNoConvergence, RuntimeError):
            return _dense_condition_number(A.toarray(), zero_tol)
    if lam_min <= zero_tol:
        return float("inf")
    return float(abs(lam_max) / lam_min)
