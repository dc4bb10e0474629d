"""The conditioning part of the benchmarking utilities.

Counterpart of ``default_model_params``, ``assemble_monolithic_matrix`` and
``estimate_condition_numbers`` in ``perphil_tpu/experiments/iterative_bench.py``
(the reference's ``perphil/experiments/iterative_bench.py``); the rest of
that module (the approaches, ``solve_on_mesh``, the error helpers) is ROADMAP
slice 10.

In sparse mode the exact inverses of sigma_min's inverse Lanczos run on
``W``'s device: the fast-diagonalisation solvers on quad/hex meshes, and on
tri/tet meshes the solvers' own exact routes (``_monolithic_direct``: K3 or
``cg`` with K1; ``_exact_field_solver``: ``cg`` with the lumped fast-diag
preconditioner).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import scipy.sparse as sp
import torch

from perphil_tpu_torch.forms.spaces import MixedFunctionSpace
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator, FieldOperator, materialize_monolithic_csr
from perphil_tpu_torch.ops.direct import FastDiagDPPSolver, FastDiagFieldSolver
from perphil_tpu_torch.solvers import conditioning
from perphil_tpu_torch.solvers.solver import _exact_field_solver, _monolithic_direct


def default_model_params() -> DPPParameters:
    """The reference's analysis parameters: k1 = beta = mu = 1, k2 = 1e-2."""
    return DPPParameters(k1=1.0, k2=1.0 / 1e2, beta=1.0, mu=1.0)


def assemble_monolithic_matrix(
    W: MixedFunctionSpace,
    params: Optional[DPPParameters] = None,
    bcs: Optional[List[DirichletBC]] = None,
) -> Tuple[sp.csr_matrix, int, int]:
    """The monolithic CSR and the two block sizes."""
    return materialize_monolithic_csr(W, params or default_model_params())


def _inverses(W: MixedFunctionSpace, params: DPPParameters, n0: int) -> Tuple[Callable, Callable, Callable]:
    """Exact inverse applications on flat tensors on ``W``'s device: the
    monolithic matrix's and its two diagonal blocks'."""
    mesh, shape = W.mesh, W.mesh.node_shape
    p = params
    if mesh.is_tensor_product:
        mono = FastDiagDPPSolver(mesh, p, device=W.device).solve
        B0 = FastDiagFieldSolver(mesh, p.k1, p.beta, p.mu, device=W.device).solve
        B1 = FastDiagFieldSolver(mesh, p.k2, p.beta, p.mu, device=W.device).solve
    else:
        mono = _monolithic_direct(DPPOperator(W, p))
        B0 = _exact_field_solver(FieldOperator(W.sub(0), p.k1, p.beta, p.mu))
        B1 = _exact_field_solver(FieldOperator(W.sub(1), p.k2, p.beta, p.mu))

    def inv_mono(x: torch.Tensor) -> torch.Tensor:
        z1, z2 = mono(x[:n0].reshape(shape), x[n0:].reshape(shape))
        return torch.cat([z1.reshape(-1), z2.reshape(-1)])

    return inv_mono, (lambda x: B0(x.reshape(shape)).reshape(-1)), (lambda x: B1(x.reshape(shape)).reshape(-1))


def estimate_condition_numbers(
    W: MixedFunctionSpace,
    params: Optional[DPPParameters] = None,
    bcs: Optional[List[DirichletBC]] = None,
    num_of_factors: Optional[int] = 50,
    use_sparse: bool = True,
) -> Dict[str, float]:
    """Condition numbers of the monolithic matrix and of its two diagonal
    blocks: ``{"monolithic", "macro", "micro"}``. Sparse mode runs Lanczos
    on ``W``'s device with the exact inverses there; dense mode is the host
    SVD."""
    params = params or default_model_params()
    csr, n0, n1 = assemble_monolithic_matrix(W, params=params, bcs=bcs)
    inv = _inverses(W, params, n0) if use_sparse else (None, None, None)
    blocks = (csr, csr[:n0, :n0].tocsr(), csr[n0 : n0 + n1, n0 : n0 + n1].tocsr())
    return {
        key: conditioning.calculate_condition_number(
            A, num_singular_values=num_of_factors, use_sparse=use_sparse, inv_apply=f, device=W.device
        )
        for key, A, f in zip(("monolithic", "macro", "micro"), blocks, inv)
    }
