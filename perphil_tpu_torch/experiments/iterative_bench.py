"""Benchmarking utilities for iterative and direct DPP solvers.

Counterpart of ``perphil_tpu/experiments/iterative_bench.py`` (the
reference's ``perphil/experiments/iterative_bench.py``): the solver
approaches and their option sets (``Approach``, ``params_for``,
``make_fieldsplit_params_with``), the mesh, space and BC helpers,
``solve_on_mesh``, ``l2_errors_against_reference``, and the conditioning
analysis (``assemble_monolithic_matrix``, ``estimate_condition_numbers``).
Spaces and solves live on ``device`` (default: the card).

In sparse mode the exact inverses of sigma_min's inverse Lanczos run on
``W``'s device: the fast-diagonalisation solvers on quad/hex meshes, and on
tri/tet meshes the solvers' own exact routes (``_monolithic_direct``: K3 or
``cg`` with K1; ``_exact_field_solver``: ``cg`` with the lumped fast-diag
preconditioner).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

import scipy.sparse as sp
import torch

from perphil_tpu_torch.config import DeviceLike
from perphil_tpu_torch.forms.spaces import (
    Function,
    FunctionSpace,
    MixedFunctionSpace,
    create_function_spaces,
    mixed_space,
)
from perphil_tpu_torch.mesh.structured import StructuredMesh, create_mesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator, FieldOperator, materialize_monolithic_csr
from perphil_tpu_torch.ops.direct import FastDiagDPPSolver, FastDiagFieldSolver
from perphil_tpu_torch.solvers import conditioning
from perphil_tpu_torch.solvers import parameters as solver_params
from perphil_tpu_torch.solvers.solver import (
    _exact_field_solver,
    _monolithic_direct,
    solve_dpp,
    solve_dpp_nonlinear,
)
from perphil_tpu_torch.utils.postprocessing import l2_error


class Approach(str, Enum):
    """The reference's solver approaches, with its labels letter for letter
    (so CSVs diff cleanly; "MUMPS" names the direct-solver role)."""

    PLAIN_GMRES = "GMRES"
    GMRES_ILU = "GMRES + ILU PC"
    SS_GMRES = "Scale-Splitting GMRES"
    SS_GMRES_ILU = "Scale-Splitting GMRES + ILU PC"
    PICARD_MUMPS = "Scaling-Splitting Picard with MUMPS"
    MONOLITHIC_MUMPS = "Monolithic LU with MUMPS"


@dataclass(frozen=True)
class SolveResult:
    """Solve metadata."""

    approach: Approach
    nx: int
    ny: int
    iteration_number: int
    residual_error: float
    fields: Optional[Tuple[Function, Function]] = None


def build_mesh(nx: int, ny: int, quadrilateral: bool = True) -> StructuredMesh:
    return create_mesh(nx, ny, quadrilateral=quadrilateral)


def build_spaces(
    mesh: StructuredMesh, device: DeviceLike = None
) -> Tuple[FunctionSpace, FunctionSpace, MixedFunctionSpace]:
    """(velocity, pressure, mixed) spaces on ``device``."""
    U, V = create_function_spaces(mesh, device=device)
    return U, V, mixed_space(V)


def default_bcs(W: MixedFunctionSpace) -> List[DirichletBC]:
    """Homogeneous Dirichlet BCs on both fields."""
    return [DirichletBC(W.sub(0), 0.0), DirichletBC(W.sub(1), 0.0)]


def default_model_params() -> DPPParameters:
    """The reference's analysis parameters: k1 = beta = mu = 1, k2 = 1e-2."""
    return DPPParameters(k1=1.0, k2=1.0 / 1e2, beta=1.0, mu=1.0)


def make_fieldsplit_params_with(block_pc: str = "lu") -> Dict:
    """The fieldsplit GMRES options with the blocks' preconditioner
    ``block_pc``."""
    base = dict(solver_params.FIELDSPLIT_LU_PARAMS)
    base["ksp_type"] = "gmres"
    if block_pc.lower() != "lu":
        base["fieldsplit_0_pc_type"] = block_pc
        base["fieldsplit_1_pc_type"] = block_pc
        base["fieldsplit_0_ksp_type"] = base.get("fieldsplit_0_ksp_type", "preonly")
        base["fieldsplit_1_ksp_type"] = base.get("fieldsplit_1_ksp_type", "preonly")
    return base


def params_for(approach: Approach) -> Dict:
    """The solver options of each approach."""
    if approach == Approach.PLAIN_GMRES:
        return solver_params.PLAIN_GMRES_PARAMS.copy()
    if approach == Approach.GMRES_ILU:
        return solver_params.GMRES_ILU_PARAMS.copy()
    if approach == Approach.SS_GMRES:
        return {**solver_params.GMRES_PARAMS, **solver_params.FIELDSPLIT_LU_PARAMS}
    if approach == Approach.SS_GMRES_ILU:
        return {**solver_params.GMRES_PARAMS, **solver_params.FIELDSPLIT_GMRES_ILU_PARAMS}
    if approach == Approach.MONOLITHIC_MUMPS:
        return solver_params.LINEAR_SOLVER_PARAMS.copy()
    if approach == Approach.PICARD_MUMPS:
        return solver_params.PICARD_LU_SOLVER_PARAMS.copy()
    raise ValueError(f"Unknown approach: {approach}")


def solve_on_mesh(
    W: MixedFunctionSpace,
    approach: Approach,
    params: Optional[DPPParameters] = None,
    bcs: Optional[List[DirichletBC]] = None,
) -> SolveResult:
    """Solve on ``W`` (and its device) with the approach's options."""
    params = params or default_model_params()
    bcs = bcs or default_bcs(W)
    sp_dict = params_for(approach)
    if approach == Approach.PICARD_MUMPS:
        sol = solve_dpp_nonlinear(W, params, bcs=bcs, solver_parameters=sp_dict)
    else:
        sol = solve_dpp(W, params, bcs=bcs, solver_parameters=sp_dict)
    return SolveResult(
        approach=approach,
        nx=-1,
        ny=-1,
        iteration_number=sol.iteration_number,
        residual_error=float(sol.residual_error),
        fields=tuple(sol.solution.split()),
    )


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


def l2_errors_against_reference(
    W: MixedFunctionSpace,
    fields: Tuple[Function, Function],
    ref_fields: Tuple[Function, Function],
) -> Tuple[float, float]:
    """Per-field L2 errors against a reference solution on the same space."""
    p1, p2 = fields
    r1, r2 = ref_fields
    return float(l2_error(p1, r1)), float(l2_error(p2, r2))
