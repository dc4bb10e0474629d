"""Linear DPP solves: the direct-solve main path.

Counterpart of ``perphil_tpu/solvers/solver.py`` for ``ksp_type: preonly``
with ``pc_type: lu`` (``LINEAR_SOLVER_PARAMS``, ``TPU_DIRECT_PARAMS``). The
routing is the JAX package's accelerator route, the same on every device;
the device only decides whether a kernel wrapper launches CUDA or runs its
plain twin:

  - quad/hex inside the fused envelope   -> K2 ``fused_direct_solve``
  - quad/hex beyond it                   -> ``MixedPrecisionDPPDirect``
                                            (f32 fast-diag, K1 residuals)
  - tri/tet inside the envelope          -> K3 ``fused_simplicial_direct_solve``
  - tri/tet beyond it                    -> ``cg`` to 1e-13 with the lumped
                                            fast-diag preconditioner (K1 matvec)

The RHS lift is K1 in lift mode. A preonly solve reports 1 iteration and
residual 0.0 (PETSc semantics). Every other option path raises
``NotImplementedError`` naming the ROADMAP slice that ports it.

Solvers are cached on ``(W, params, frozen options)``; ``W`` carries the
device. No builder reads the environment.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, Sequence, Tuple, Union

import torch

from perphil_tpu_torch.forms.spaces import Function, MixedFunctionSpace
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator, bc_values_per_field
from perphil_tpu_torch.ops.direct import LumpedDPPPreconditioner
from perphil_tpu_torch.ops.fused_direct import (
    fused_direct_solve,
    fused_direct_supported,
    fused_simplicial_direct_solve,
    fused_simplicial_direct_supported,
)
from perphil_tpu_torch.ops.krylov import cg
from perphil_tpu_torch.ops.mixed import MixedPrecisionDPPDirect
from perphil_tpu_torch.solvers.options import apply_prefix_overrides

_DIRECT_RTOL = 1e-13  # inner tolerance when "LU" is played by PCG
_DIRECT_MAX_IT = 2000

# pc_type -> the ROADMAP slice that ports it
_PC_SLICES = {
    "none": "slice 2 (Krylov)",
    "jacobi": "slice 2 (Krylov)",
    "fieldsplit": "slice 3 (fieldsplit)",
    "ilu": "slice 4 (ILU)",
}


@dataclass(frozen=True)
class Solution:
    """Result of a solve: the solution, the iteration count and the residual."""

    solution: Union[Function, Tuple[Function, Function]]
    iteration_number: int
    residual_error: float


def _flatten_options(sp: Dict, prefix: str = "") -> Dict[str, object]:
    """Flatten nested option dicts (``{"fieldsplit_0": {...}}``) into
    PETSc-style prefixed keys (``fieldsplit_0_ksp_type``)."""
    out: Dict[str, object] = {}
    for k, v in (sp or {}).items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_options(v, prefix=f"{key}_"))
        else:
            out[key] = v
    return out


def _freeze(sp: Dict) -> Tuple:
    return tuple(sorted(_flatten_options(sp).items()))


def _sub_options(flat: Dict[str, object], prefix: str) -> Dict[str, object]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in flat.items() if k.startswith(prefix)}


def _validate_mixed(W) -> None:
    if not hasattr(W, "num_sub_spaces") or W.num_sub_spaces() != 2:
        raise ValueError(f"Expected a 2-field MixedFunctionSpace, got {type(W)}")


def _monolithic_direct(op: DPPOperator) -> Callable:
    """Direct solve of the monolithic system, ``(b1, b2) -> (z1, z2)``."""
    mesh = op.mesh
    if mesh.is_tensor_product:
        if fused_direct_supported(op):
            return fused_direct_solve(op)
        return MixedPrecisionDPPDirect(mesh, op.params, device=op.W.device).solve
    if fused_simplicial_direct_supported(op):
        return fused_simplicial_direct_solve(op, rtol=_DIRECT_RTOL, max_it=_DIRECT_MAX_IT)
    # simplicial beyond the envelope: machine-tolerance PCG (the monolithic
    # matrix is SPD) with the block-diagonal lumped fast-diag preconditioner
    pc = LumpedDPPPreconditioner(mesh, op.params, device=op.W.device)
    mv = op.stacked_matvec()

    def solve(b1: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x, _, _ = cg(
            mv, torch.stack([b1, b2]), rtol=_DIRECT_RTOL, atol=0.0,
            max_it=_DIRECT_MAX_IT, M_inv=pc,
        )
        return x[0], x[1]

    return solve


@lru_cache(maxsize=64)
def _build_linear_solver(
    W: MixedFunctionSpace,
    params: DPPParameters,
    frozen_sp: Tuple,
) -> Callable:
    """Build a linear solve ``(g1, g2) -> (z1, z2, its, rnorm)`` for
    boundary-value grids g1, g2."""
    flat = dict(frozen_sp)
    ksp = str(flat.get("ksp_type", "gmres"))
    if ksp != "preonly":
        raise NotImplementedError(f"ksp_type={ksp!r} is ported in ROADMAP slice 2 (Krylov)")
    pc_type = str(flat.get("pc_type", "lu"))
    if pc_type not in ("lu", "cholesky"):
        where = _PC_SLICES.get(pc_type, "a later ROADMAP slice")
        raise NotImplementedError(f"pc_type={pc_type!r} is ported in ROADMAP {where}")
    if (
        str(flat.get("pc_factor_mat_solver_type", "")) == "fastdiag_mixed"
        and not W.mesh.is_tensor_product
    ):
        raise ValueError("fastdiag_mixed needs quad/hex cells")
    # on quad/hex meshes both direct presets take the mixed-precision route:
    # K2 in the envelope, f32 fast-diag + K1 refinement beyond it
    op = DPPOperator(W, params)
    direct = _monolithic_direct(op)

    def solve_preonly(g1: torch.Tensor, g2: torch.Tensor):
        b1, b2 = op.lifted_rhs(g1, g2)
        z1, z2 = direct(b1, b2)
        # preonly reports 1 iteration and residual 0.0 (PETSc semantics)
        return z1, z2, 1, 0.0

    return solve_preonly


def solve_dpp(
    W: MixedFunctionSpace,
    model_params: DPPParameters,
    bcs: Sequence[DirichletBC],
    solver_parameters: Dict = {},
    options_prefix: str = "dpp",
) -> Solution:
    """Solve the monolithic DPP linear system on ``W``'s device; returns a
    ``Solution`` with the iteration count and residual norm."""
    _validate_mixed(W)
    solver_parameters = apply_prefix_overrides(solver_parameters, options_prefix)
    g1, g2 = bc_values_per_field(W, bcs)
    solver = _build_linear_solver(W, model_params, _freeze(solver_parameters))
    z1, z2, its, rnorm = solver(g1, g2)
    return Solution(Function(W, (z1, z2)), int(its), float(rnorm))


def solve_dpp_nonlinear(
    W: MixedFunctionSpace,
    model_params: DPPParameters,
    bcs: Sequence[DirichletBC],
    solver_parameters: Dict = {},
    options_prefix: str = "dpp_nonlinear",
) -> Solution:
    """Picard-style nonlinear solve: not ported yet."""
    raise NotImplementedError("solve_dpp_nonlinear is ported in ROADMAP slice 5 (nonlinear Picard)")
