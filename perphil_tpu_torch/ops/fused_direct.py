"""K2 and K3: whole direct solves in one kernel launch, on small meshes.

Counterpart of ``perphil_tpu/ops/pallas_direct.py``:

  - **K2** :func:`fused_direct_solve` (quad/hex): f32 tensor
    fast-diagonalization, then 5 fixed refinement steps with the f64
    residual; ``csrc/fused_direct.cu``.
  - **K3** :func:`fused_simplicial_direct_solve` (tri/tet): f64 PCG to
    ``rtol`` with the block-diagonal lumped fast-diag preconditioner;
    ``csrc/fused_pcg.cu``.

Each returns an ``nn.Module`` whose call ``(b1, b2) -> (z1, z2)`` launches
the kernel on CUDA tensors and runs the plain PyTorch twin (``.plain``) on
CPU tensors.

The envelope stands for the JAX gate ``_geometry(op).Rp <= 512``
(``pallas_direct.py:49-76``) without the packed layout: that layout stacks
both fields' planes of ``rows + 2`` halo'd rows into at most 512 rows
(``planes * (rows + 2) <= 256`` per field) and puts one row of ``cols + 2``
nodes in 128 lanes (``cols <= 126``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator, dpp_stencils
from perphil_tpu_torch.ops.direct import FastDiagDPPSolver, LumpedDPPPreconditioner
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain, pack_weights
from perphil_tpu_torch.ops.krylov import cg

K2 = "fused_direct_solve"
K3 = "fused_simplicial_direct_solve"

_MAX_ROW_NODES = 126
_MAX_HALO_ROWS = 256


def _within_envelope(node_shape: Tuple[int, ...]) -> bool:
    if len(node_shape) not in (2, 3) or min(node_shape) < 3:
        return False  # no interior
    planes, rows, cols = (1,) * (3 - len(node_shape)) + tuple(node_shape)
    return cols <= _MAX_ROW_NODES and planes * (rows + 2) <= _MAX_HALO_ROWS


def fused_direct_supported(op: DPPOperator) -> bool:
    """Whether K2 covers this operator: a small quad/hex mesh."""
    return op.mesh.is_tensor_product and _within_envelope(op.mesh.node_shape)


def fused_simplicial_direct_supported(op: DPPOperator) -> bool:
    """Whether K3 covers this operator: a small tri/tet mesh."""
    return not op.mesh.is_tensor_product and _within_envelope(op.mesh.node_shape)


def _stacked(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    if b1.shape != b2.shape or b1.dtype != torch.float64:
        raise ValueError("need two float64 grids of one shape")
    return torch.stack([b1, b2]).contiguous()


def _grid_args(node_shape: Tuple[int, ...]) -> Tuple[int, int, int, int]:
    nz, ny, nx = (1,) * (3 - len(node_shape)) + tuple(node_shape)
    return nz, ny, nx, len(node_shape)


def _check_device(module_device: torch.device, b: torch.Tensor) -> None:
    if b.device != module_device:
        raise ValueError(f"right-hand side on {b.device}, solver built for {module_device}")
    if b.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused solves run on cpu or cuda, got {b.device}")


def _check_launch_rhs(b: torch.Tensor, device: torch.device, node_shape: Tuple[int, ...]) -> None:
    _cuda.require_cuda_tensor(b, "b", torch.float64, device)
    if tuple(b.shape) != (2,) + node_shape:
        raise ValueError(f"b has shape {tuple(b.shape)}, expected {(2,) + node_shape}")


def _axis_ptrs(mats) -> Tuple[int, int, int]:
    """Pointers of the x, y, z eigenvector matrices (2D passes x as the
    unused z). The buffers are contiguous: they are built from numpy."""
    return mats[0].data_ptr(), mats[1].data_ptr(), mats[-1].data_ptr()


class FusedDirectSolver(nn.Module):
    """K2: the mixed-precision direct solve of a small quad/hex system.

    Buffers: the f32 fast-diag solver's per-axis eigenvectors and per-mode
    ``a11``, ``a22``, ``det``. Every f32 solve is scaled by the max of its
    right-hand side; boundary rows take the right-hand side exactly.
    """

    def __init__(self, op: DPPOperator, refinements: int = 5):
        super().__init__()
        if not fused_direct_supported(op):
            raise ValueError(f"mesh {op.mesh} is outside the fused direct envelope")
        self.node_shape = op.mesh.node_shape
        self.device = op.W.device
        self.refinements = refinements
        self.stencils = dpp_stencils(op.mesh, op.params)
        self.fast32 = FastDiagDPPSolver(op.mesh, op.params, device=self.device, dtype=torch.float32)

    def _correction(self, src: torch.Tensor) -> torch.Tensor:
        """``src`` on the boundary; ``s * fastdiag32(src / s)`` inside."""
        s = torch.clamp(src.abs().max(), min=1e-30)
        inner = self.fast32.inner
        u1, u2 = self.fast32.solve_interior(
            (src[0][inner] / s).float(), (src[1][inner] / s).float()
        )
        d = src.clone()
        d[0][inner] = u1.double() * s
        d[1][inner] = u2.double() * s
        return d

    def plain(self, b: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch twin of K2 on stacked ``(2, *node_shape)`` f64."""
        x = self._correction(b)
        for _ in range(self.refinements):
            r = b - torch.stack(fused_dpp_apply_plain(x[0], x[1], *self.stencils, mode="matvec"))
            x = x + self._correction(r)
        return x

    def launch(self, b: torch.Tensor) -> torch.Tensor:
        """Run K2 on stacked ``(2, *node_shape)`` f64 CUDA tensors."""
        _check_launch_rhs(b, self.device, self.node_shape)
        fd = self.fast32
        x = torch.empty_like(b)
        r = torch.empty_like(b)
        work = torch.empty(4 * fd.a11.numel(), dtype=torch.float32, device=b.device)
        w = pack_weights(*self.stencils)
        _cuda.launch(
            K2, "perphil_fused_direct", b.device,
            b.data_ptr(), x.data_ptr(), r.data_ptr(), work.data_ptr(), *_axis_ptrs(fd.mats),
            fd.a11.data_ptr(), fd.a22.data_ptr(), fd.det.data_ptr(), fd.a12,
            w.ctypes.data, *_grid_args(self.node_shape), self.refinements,
        )
        return x

    def forward(self, b1: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = _stacked(b1, b2)
        _check_device(self.device, b)
        x = self.plain(b) if b.device.type == "cpu" else self.launch(b)
        return x[0], x[1]


def fused_direct_solve(op: DPPOperator, refinements: int = 5) -> FusedDirectSolver:
    """K2 solver for ``op``: call it as ``solve(b1, b2) -> (z1, z2)``."""
    return FusedDirectSolver(op, refinements)


class FusedSimplicialSolver(nn.Module):
    """K3: f64 PCG to ``rtol`` (at most ``max_it`` iterations) on a small
    tri/tet system, preconditioned by the lumped fast-diag per field.

    Buffers: the preconditioner's per-axis lumped eigenvectors and the
    per-field mode scales ``sc`` (2, interior nodes).
    """

    def __init__(self, op: DPPOperator, rtol: float = 1e-13, max_it: int = 2000):
        super().__init__()
        if not fused_simplicial_direct_supported(op):
            raise ValueError(f"mesh {op.mesh} is outside the fused simplicial envelope")
        self.node_shape = op.mesh.node_shape
        self.device = op.W.device
        self.rtol = rtol
        self.max_it = max_it
        self.stencils = dpp_stencils(op.mesh, op.params)
        self.pc = LumpedDPPPreconditioner(op.mesh, op.params, device=self.device)
        self.register_buffer(
            "sc", torch.stack([self.pc.pc1.mode_scale.reshape(-1), self.pc.pc2.mode_scale.reshape(-1)])
        )

    def plain(self, b: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """Plain PyTorch twin of K3 on stacked f64 grids: (x, iterations)."""

        def mv(x):
            return torch.stack(fused_dpp_apply_plain(x[0], x[1], *self.stencils, mode="matvec"))

        x, its, _ = cg(mv, b, rtol=self.rtol, atol=0.0, max_it=self.max_it, M_inv=self.pc)
        return x, its

    def launch(self, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run K3 on stacked f64 CUDA tensors: (x, iterations as a 1-element
        int32 tensor on the device)."""
        _check_launch_rhs(b, self.device, self.node_shape)
        x = torch.empty_like(b)
        its = torch.empty(1, dtype=torch.int32, device=b.device)
        work = torch.empty(8 * b[0].numel() + 4 * self.sc.shape[1], dtype=torch.float64, device=b.device)
        w = pack_weights(*self.stencils)
        _cuda.launch(
            K3, "perphil_fused_pcg", b.device,
            b.data_ptr(), x.data_ptr(), its.data_ptr(), work.data_ptr(),
            *_axis_ptrs(self.pc.pc1.mats), self.sc.data_ptr(),
            w.ctypes.data, *_grid_args(self.node_shape), float(self.rtol), int(self.max_it),
        )
        return x, its

    def forward(self, b1: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = _stacked(b1, b2)
        _check_device(self.device, b)
        x = self.plain(b)[0] if b.device.type == "cpu" else self.launch(b)[0]
        return x[0], x[1]


def fused_simplicial_direct_solve(
    op: DPPOperator, rtol: float = 1e-13, max_it: int = 2000
) -> FusedSimplicialSolver:
    """K3 solver for ``op``: call it as ``solve(b1, b2) -> (z1, z2)``."""
    return FusedSimplicialSolver(op, rtol, max_it)
