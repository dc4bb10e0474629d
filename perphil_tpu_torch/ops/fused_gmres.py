"""K4 and K5: the whole restarted GMRES(m) solve in one kernel launch, on
small meshes.

Counterpart of ``perphil_tpu/ops/pallas_gmres.py`` for pc ``none`` and
``jacobi``:

  - **K4** :func:`fused_gmres_df`, the TPU's double-float cycle kernel;
  - **K5** :func:`fused_gmres_ef64`, the TPU's f64-faithful kernel for
    unpreconditioned systems of at most 512 DoF.

The TPU needs the two only because it has no f64. Here both roles run one
native-f64 kernel, ``csrc/fused_gmres.cu``, whose arithmetic is
:func:`perphil_tpu_torch.ops.krylov.gmres` with the plain matvec
(``fused_dpp_apply_plain``) bit for bit; a launch counts under the role's
TPU kernel name. Vectors are stacked ``(2, *node_shape)`` f64 tensors.

The envelope restates the JAX gate (``pallas_gmres.py:1155-1196``) on node
counts: the TPU's packed layout puts a row of ``cols + 2`` nodes in 128
lanes, lane-packs ``128 // (cols + 2)`` planes of a 3D grid side by side,
stacks the two fields (or, on narrow 2D grids, puts them side by side) and
needs the padded row count ``Rp`` to be at most 512, so that the
double-float basis fits its VMEM budget.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator, dpp_stencils
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain, pack_weights
from perphil_tpu_torch.ops.fused_direct import _check_device, _grid_args
from perphil_tpu_torch.ops.krylov import DEFAULT_DTOL, KrylovResult, gmres

K4 = "fused_gmres_df"
K5 = "fused_gmres_ef64"
PC_KINDS = {"none": 0, "jacobi": 1}
#: the kernel keeps the m + 1 <= 32 basis rows' coefficients in shared memory
MAX_RESTART = 31
#: systems the K5 role serves (pc none): at most this many DoF
EF64_MAX_DOF = 512

_LANES = 128
_MAX_PACKED_ROWS = 512


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _within_envelope(node_shape: Tuple[int, ...]) -> bool:
    if len(node_shape) == 2:
        planes, (rows, cols) = 1, node_shape
    elif len(node_shape) == 3:
        planes, rows, cols = node_shape
    else:
        return False
    if cols + 2 > _LANES:
        return False
    group = max(1, min(planes, _LANES // (cols + 2))) if len(node_shape) == 3 else 1
    nblocks = -(-planes // group)
    field_lanes = (
        len(node_shape) == 2 and 2 * (cols + 2) <= _LANES and _next_pow2(2 * (rows + 2)) >= 128
    )
    fields = 1 if field_lanes else 2
    return _next_pow2(fields * nblocks * (rows + 2)) <= _MAX_PACKED_ROWS


def fused_gmres_supported(op: DPPOperator, pc_type: str = "none") -> bool:
    """Whether K4/K5 cover this operator and preconditioner."""
    return pc_type in PC_KINDS and _within_envelope(tuple(op.mesh.node_shape))


class FusedGMRESSolver(nn.Module):
    """GMRES(``restart``) on ``A x = b`` from ``x0``, left-preconditioned
    by ``pc_type`` (``none`` or ``jacobi``), the whole solve in one launch.
    ``role`` is the TPU kernel a launch counts under (K4 or K5, pc none).

    Buffer: ``dinv``, the inverse diagonal of the BC-eliminated operator
    (``DPPOperator.diagonal``), for Jacobi.
    """

    def __init__(
        self,
        op: DPPOperator,
        pc_type: str = "none",
        role: str = K4,
        rtol: float = 1.0e-5,
        atol: float = 1.0e-50,
        max_it: int = 10000,
        restart: int = 30,
        dtol: float = DEFAULT_DTOL,
    ):
        super().__init__()
        if role not in (K4, K5) or (role == K5 and pc_type != "none"):
            raise ValueError(f"role {role!r} with pc_type={pc_type!r}: K5 runs pc none only")
        if not fused_gmres_supported(op, pc_type):
            raise ValueError(f"mesh {op.mesh} with pc_type={pc_type!r} is outside the fused GMRES envelope")
        if not 1 <= restart <= MAX_RESTART:
            raise ValueError(f"restart {restart} outside 1..{MAX_RESTART}")
        self.node_shape = tuple(op.mesh.node_shape)
        self.device = op.W.device
        self.pc_type, self.role = pc_type, role
        self.rtol, self.atol, self.dtol = float(rtol), float(atol), float(dtol)
        self.max_it, self.restart = int(max_it), int(restart)
        self.stencils = dpp_stencils(op.mesh, op.params)
        dinv = None
        if pc_type == "jacobi":
            dinv = (1.0 / op.diagonal()).reshape((2,) + self.node_shape).contiguous()
        self.register_buffer("dinv", dinv)

    def plain(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None) -> KrylovResult:
        """Plain PyTorch twin: ``krylov.gmres`` with the plain matvec."""

        def mv(z: torch.Tensor) -> torch.Tensor:
            return torch.stack(fused_dpp_apply_plain(z[0], z[1], *self.stencils, mode="matvec"))

        dinv = self.dinv
        pc = None if dinv is None else (lambda r: dinv * r)
        return gmres(
            mv, b, x0, rtol=self.rtol, atol=self.atol, max_it=self.max_it,
            restart=self.restart, M_inv=pc, dtol=self.dtol,
        )

    def launch(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None) -> KrylovResult:
        """Run the kernel on stacked ``(2, *node_shape)`` f64 CUDA tensors;
        reads the iteration count and residual norm back."""
        if x0 is None:
            x0 = torch.zeros_like(b)
        shape = (2,) + self.node_shape
        for name, t in (("b", b), ("x0", x0)):
            _cuda.require_cuda_tensor(t, name, torch.float64, self.device)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        x = torch.empty_like(b)
        basis = torch.empty((self.restart + 1) * b.numel(), dtype=torch.float64, device=b.device)
        result = torch.empty(3, dtype=torch.float64, device=b.device)
        w = pack_weights(*self.stencils)
        _cuda.launch(
            self.role, "perphil_fused_gmres", b.device,
            b.data_ptr(), x0.data_ptr(), None if self.dinv is None else self.dinv.data_ptr(),
            x.data_ptr(), basis.data_ptr(), result.data_ptr(), w.ctypes.data,
            *_grid_args(self.node_shape), PC_KINDS[self.pc_type],
            self.rtol, self.atol, self.dtol, self.max_it, self.restart,
        )
        its, rnorm, converged = result.tolist()
        return KrylovResult(x, int(its), rnorm, bool(converged))

    def forward(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None) -> KrylovResult:
        _check_device(self.device, b)
        return self.plain(b, x0) if b.device.type == "cpu" else self.launch(b, x0)


def fused_gmres_df(
    op: DPPOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    dtol: float = DEFAULT_DTOL,
    pc_type: str = "none",
) -> KrylovResult:
    """K4: GMRES with pc ``none`` or ``jacobi`` in one launch."""
    return FusedGMRESSolver(op, pc_type, K4, rtol, atol, max_it, restart, dtol)(b, x0)


def fused_gmres_ef64(
    op: DPPOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    dtol: float = DEFAULT_DTOL,
) -> KrylovResult:
    """K5: unpreconditioned GMRES in one launch (the JAX package's
    f64-faithful parity mode; here native f64, the same kernel as K4)."""
    return FusedGMRESSolver(op, "none", K5, rtol, atol, max_it, restart, dtol)(b, x0)
