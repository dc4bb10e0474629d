"""Mixed-precision direct solver: f32 fast-diagonalization + f64 refinement.

Counterpart of ``perphil_tpu/ops/mixed.py::MixedPrecisionDPPDirect``, the
"MUMPS role" solver for tensor meshes beyond the fused envelope:

  1. the tensor fast-diagonalization solve runs in float32;
  2. residuals are computed in native float64 through K1's halo form
     (``ops/fused_apply.py``), where the TPU package used double-float;
  3. iterative refinement contracts the error by ~kappa(A) * eps_f32 per
     step, so a handful of steps reach ~1e-12 relative.

The stopping rule is the reference's (``mixed.py:243-248``): at most
``refinements`` steps, while the residual is above ``3e-13 ||b||`` and still
halves per step. Each step reads the residual norm back to the host.

The solve runs on the blocks of the (padded) node grid that a process
holds (``parallel/transpose.py``; :meth:`MixedPrecisionDPPDirect.solve` is
:meth:`~MixedPrecisionDPPDirect.solve_blocks` with the whole grid as one
block): the f32 fast-diag on blocks (``FastDiagDPPSolver.solve_blocks``,
all-to-all transposes between blocks), the f64 residual by K1's halo form
over exchanged planes, and ``||b||``, ``||r||`` and the scale ``s`` reduced
over every block, so that every rank takes the same branch of the
refinement loop. With ``padding`` (the sharded path's phantom nodes at the
high end of each grid axis) the grids carry identity rows with zero data:
the fast-diag passes them through and the halo form takes the boundary from
the physical node grid.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from perphil_tpu_torch.config import DeviceLike
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import dpp_stencils, normalize_padding
from perphil_tpu_torch.ops.direct import FastDiagDPPSolver
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply
from perphil_tpu_torch.parallel.transpose import LoopbackBlocks


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
        # the whole grid as one block, kept: the blocked fast-diag's
        # extended matrices and mode data are built once per set of blocks
        self.whole = LoopbackBlocks(())

    def lifted_rhs(self, g1: torch.Tensor, g2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """f64 RHS with BC lifting (K1, lift mode) on the unpadded node grid."""
        if any(self.padding):
            raise ValueError("lifted_rhs takes the unpadded node grid; a padded grid's lift is DPPOperator.lifted_rhs")
        return fused_dpp_apply(g1, g2, *self.stencils, mode="lift")

    def solve(self, b1: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Solve A z = b to ~1e-12 relative accuracy; f64 in, f64 out
        (:meth:`solve_blocks` with the whole, padded or unpadded, grid as
        one block)."""
        z = self.solve_blocks({(): torch.stack([b1, b2])}, self.whole)[()]
        return z[0], z[1]

    def solve_blocks(self, bs: Dict[Tuple[int, ...], torch.Tensor], blocks) -> Dict[Tuple[int, ...], torch.Tensor]:
        """:meth:`solve` on the stacked f64 blocks ``bs`` that ``blocks``
        holds of the padded grid (``parallel/transpose.py``): f64 in, f64
        out."""
        grid = tuple(n + p for n, p in zip(self.mesh.node_shape, self.padding))

        def fast(rs):
            return {c: v.double() for c, v in self.fast32.solve_blocks(
                {c: r.float() for c, r in rs.items()}, blocks, self.padding).items()}

        def norm(rs) -> float:
            return math.sqrt(float(blocks.total({c: torch.sum(r[0] * r[0]) + torch.sum(r[1] * r[1])
                                                 for c, r in rs.items()})))

        x = fast(bs)
        bnorm = norm(bs)
        tol = 3e-13 * max(bnorm, 1e-30)
        it, rnorm, prev = 0, bnorm, math.inf
        while it < self.refinements and rnorm > tol and rnorm < 0.5 * prev:
            y = blocks.halo_apply(self.stencils, x, "matvec", grid, self.mesh.node_shape)
            r = {c: bs[c] - y[c] for c in bs}
            s = torch.clamp(blocks.largest({c: v.abs().max() for c, v in r.items()}), min=1e-30)
            d = fast({c: v / s for c, v in r.items()})
            x = {c: x[c] + d[c] * s for c in x}
            prev, rnorm = rnorm, norm(r)
            it += 1
        return x

    def assemble_and_solve(
        self, g1: torch.Tensor, g2: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full pipeline from boundary values: BC lift + solve."""
        return self.solve(*self.lifted_rhs(g1, g2))
