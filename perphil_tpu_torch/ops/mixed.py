"""Mixed-precision direct solver: f32 fast-diagonalization + f64 refinement.

Counterpart of ``perphil_tpu/ops/mixed.py::MixedPrecisionDPPDirect``, the
"MUMPS role" solver for tensor meshes beyond the fused envelope:

  1. the tensor fast-diagonalization solve runs in float32;
  2. residuals are computed in native float64 through K1
     (``ops/fused_apply.py``), where the TPU package used double-float;
  3. iterative refinement contracts the error by ~kappa(A) * eps_f32 per
     step, so a handful of steps reach ~1e-12 relative.

The stopping rule is the reference's (``mixed.py:243-248``): at most
``refinements`` steps, while the residual is above ``3e-13 ||b||`` and still
halves per step. Each step reads the residual norm back to the host.

With ``padding`` (the sharded path's phantom nodes at the high end of each
grid axis) the grids carry identity rows with zero data: the fast-diag solve
passes them through, and the residuals run K1's halo form, which takes the
boundary from the physical node grid.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from perphil_tpu_torch.config import DeviceLike
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import dpp_stencils, normalize_padding
from perphil_tpu_torch.ops.direct import FastDiagDPPSolver
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply, fused_dpp_apply_halo_planes


class MixedPrecisionDPPDirect(nn.Module):
    """Refined f32 direct solve of the BC-eliminated monolithic DPP system.

    ``solve`` takes and returns float64 grids (drop-in for
    ``FastDiagDPPSolver.solve``); the f32 solver's buffers live on
    ``device``.
    """

    def __init__(
        self,
        mesh: StructuredMesh,
        params: DPPParameters,
        refinements: int = 5,
        device: DeviceLike = None,
        padding: Tuple[int, ...] = (),
    ):
        super().__init__()
        self.mesh = mesh
        self.params = params
        self.refinements = refinements
        self.padding = normalize_padding(mesh, padding)
        self.fast32 = FastDiagDPPSolver(mesh, params, device=device, dtype=torch.float32)
        self.stencils = dpp_stencils(mesh, params)

    def _apply(self, z1: torch.Tensor, z2: torch.Tensor, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """K1 on the node grid, its halo form on a padded one."""
        if any(self.padding):
            y = fused_dpp_apply_halo_planes(z1, z2, (), *self.stencils, mode=mode, n_phys=self.mesh.node_shape)
            return y[0], y[1]
        return fused_dpp_apply(z1, z2, *self.stencils, mode=mode)

    def lifted_rhs(self, g1: torch.Tensor, g2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """f64 RHS with BC lifting (K1, lift mode)."""
        return self._apply(g1, g2, "lift")

    def solve(self, b1: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Solve A z = b to ~1e-12 relative accuracy; f64 in, f64 out."""
        x1, x2 = (x.double() for x in self.fast32.solve(b1.float(), b2.float()))
        bnorm = math.sqrt(float(torch.sum(b1 * b1) + torch.sum(b2 * b2)))
        tol = 3e-13 * max(bnorm, 1e-30)
        it, rnorm, prev = 0, bnorm, math.inf
        while it < self.refinements and rnorm > tol and rnorm < 0.5 * prev:
            y1, y2 = self._apply(x1, x2, "matvec")
            r1, r2 = b1 - y1, b2 - y2
            # scale the f32 correction solve to stay in f32 range
            s = torch.clamp(torch.maximum(r1.abs().max(), r2.abs().max()), min=1e-30)
            d1, d2 = self.fast32.solve((r1 / s).float(), (r2 / s).float())
            x1 = x1 + d1.double() * s
            x2 = x2 + d2.double() * s
            prev, rnorm = rnorm, math.sqrt(float(torch.sum(r1 * r1) + torch.sum(r2 * r2)))
            it += 1
        return x1, x2

    def assemble_and_solve(
        self, g1: torch.Tensor, g2: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full pipeline from boundary values: BC lift + solve."""
        return self.solve(*self.lifted_rhs(g1, g2))
