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

Which meshes they can take is the launchers' own plan (:func:`direct_plan`,
``csrc/direct_smem.cuh``): one thread block whose shared memory holds the
solve's working set (quad N <= 65, hex nx <= 17, tri N <= 51, tet nx <= 14),
else a thread block cluster of 2-16 blocks that spread it (up to quad
N=257, hex nx=41, tri N=241, tet nx=39), within one budget a block
(:data:`SMEM_BUDGET`, the header's ``kDirectSmemBudget``). The TPU's gate
(``_geometry(op).Rp <= 512``: its packed VMEM layout of 512 rows and 128
lanes) does not bound the card. The solve route takes a kernel up to the
largest mesh up to which it was measured faster than the route that mesh
took before (:data:`JOIN_MAX_NODES`: quad N <= 120, hex nx <= 33, tri N <=
150, every tet mesh the plan places).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator, dpp_stencils
from perphil_tpu_torch.ops.direct import FastDiagDPPSolver, LumpedDPPPreconditioner
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain, packed_weights
from perphil_tpu_torch.ops.krylov import cg

K2 = "fused_direct_solve"
K3 = "fused_simplicial_direct_solve"

#: dynamic shared memory a launch may plan with, in bytes
SMEM_BUDGET = _cuda.header_constant("direct_smem.cuh", "kDirectSmemBudget")
#: threads of a block, at most
MAX_THREADS = _cuda.header_constant("direct_smem.cuh", "kDirectMaxThreads")
#: interior nodes of one field a thread owns, at most
MAX_PER = _cuda.header_constant("direct_smem.cuh", "kDirectMaxPer")
#: threads of K3's dense placement (its preconditioner one matrix a field)
DENSE_THREADS = _cuda.header_constant("direct_smem.cuh", "kDenseThreads")
#: blocks of a cluster placement, at most
MAX_CLUSTER = _cuda.header_constant("direct_smem.cuh", "kDirectMaxCluster")


@dataclass(frozen=True)
class DirectPlan:
    """Where a launch runs: ``blocks`` blocks (one, or a thread block
    cluster) of ``threads`` threads, each owning ``per`` interior nodes at
    most, with ``bytes`` of dynamic shared memory a block."""

    threads: int
    per: int
    bytes: int
    blocks: int = 1


def smem_bytes(kind: str, node_shape: Tuple[int, ...], mat_elems: int, threads: int) -> int:
    """The shared memory of a solve on ``threads`` threads
    (``direct_smem_bytes``): K3 holds p (2n f64), r, two transform buffers
    and the mode scales (2 nint f64 each) and its f64 eigenbases, or on the
    dense placement p, r, z and the two dense matrices (2 nint^2 f64); K2
    holds x (2n f64), two f32 transform buffers (2 nint each), a11/a22/det
    (nint f32 each) and its f32 eigenbases."""
    n = int(np.prod(node_shape))
    nint = int(np.prod([m - 2 for m in node_shape]))
    if kind == K2:
        return 16 * n + 28 * nint + 4 * mat_elems
    if threads == DENSE_THREADS:
        return 16 * n + 32 * nint + 16 * nint * nint
    return 16 * n + 64 * nint + 8 * mat_elems


def cluster_bytes(kind: str, node_shape: Tuple[int, ...], blocks: int) -> int:
    """The shared memory of each block of a cluster placement
    (``direct_cluster_bytes``): the vectors spread in chunks of
    ``ceil(/ blocks)``, K3 p (2n f64) and r and two transform buffers (2 nint
    f64 each), K2 x (2n f64) and two f32 transform buffers (2 nint each)."""
    n = int(np.prod(node_shape))
    nint = int(np.prod([m - 2 for m in node_shape]))
    pc, ic = -(-2 * n // blocks), -(-2 * nint // blocks)
    return 8 * pc + 24 * ic if kind == K3 else 8 * pc + 8 * ic


def distinct_axes(mesh) -> Tuple[int, ...]:
    """For each axis (x first), the first axis with the same eigenbasis
    (equal cells and spacing): the launchers stage each distinct one once."""
    keys = list(zip(mesh.cells, mesh.h))
    return tuple(keys.index(k) for k in keys)


def direct_plan(kind: str, node_shape: Tuple[int, ...], mat_elems: int) -> Optional[DirectPlan]:
    """The launcher's plan (``direct_plan`` in ``csrc/direct_smem.cuh``) for
    ``kind`` (:data:`K2` or :data:`K3`) on a grid of ``node_shape`` nodes
    whose distinct eigenbases hold ``mat_elems`` entries, or None where it
    places none."""
    if len(node_shape) not in (2, 3) or min(node_shape) < 3:
        return None  # no interior
    nint = int(np.prod([m - 2 for m in node_shape]))
    threads, per = 64, 1
    while threads < MAX_THREADS and threads < 2 * nint:  # a thread for each output of a pass
        threads *= 2
    while per < MAX_PER and threads * per < nint:
        per *= 2
    nbytes = smem_bytes(kind, node_shape, mat_elems, threads)
    if threads * per >= nint and nbytes <= SMEM_BUDGET:
        return DirectPlan(threads, per, nbytes)
    blocks = 2
    while blocks <= MAX_CLUSTER:  # a cluster of MAX_THREADS-thread blocks, the fewest that hold it
        per = 1
        while per < MAX_PER and MAX_THREADS * blocks * per < nint:
            per *= 2
        nbytes = cluster_bytes(kind, node_shape, blocks)
        if MAX_THREADS * blocks * per >= nint and nbytes <= SMEM_BUDGET:
            return DirectPlan(MAX_THREADS, per, nbytes, blocks)
        blocks *= 2
    return None


def _mat_elems(mesh) -> int:
    first = distinct_axes(mesh)
    return sum((c - 1) ** 2 for a, c in enumerate(mesh.cells) if first[a] == a)


def mesh_plan(op: DPPOperator) -> Optional[DirectPlan]:
    """The plan of ``op``'s mesh for the kernel its cells take."""
    kind = K2 if op.mesh.is_tensor_product else K3
    return direct_plan(kind, op.mesh.node_shape, _mat_elems(op.mesh))


#: the largest mesh, in nodes, the solve route takes each kernel on, per
#: dimension: the largest N such that the kernel was faster than the route
#: the mesh took before on every mesh measured up to N (K2:
#: ``MixedPrecisionDPPDirect``, about 2-4 ms of host time a solve; K3:
#: ``cg`` with K1), both timed in turns in one call on an NVIDIA H100
#: (``tools/profile_kernels.py --only direct``; kernel, route, kernel,
#: route; host clock, median of 10 each; ms; PERF.md): K2 on 2D N=120
#: (2.42/2.50 against 2.69/3.06; N=125 2.58/2.59 against 1.98/1.90, N=129
#: 3.66/3.70 against 2.23/2.82) and hex nx=33 (2.24/2.24 against 2.70/3.39;
#: nx=40 2.97/2.96 against 2.72/2.73, nx=41 3.20/3.18 against 2.31/2.46);
#: K3 on tri N=150 (5.81/5.86 against 11.76/8.13; N=160 7.88/7.82 against
#: 6.41/7.74, N=170 9.49/9.53 against 6.58/8.31) and on every tet mesh it
#: places (tet nx=39 4.04/4.02 against 7.01/7.05).
JOIN_MAX_NODES = {(K2, 2): 121 ** 2, (K2, 3): 34 ** 3, (K3, 2): 151 ** 2, (K3, 3): 40 ** 3}


def _joins(op: DPPOperator) -> bool:
    """Whether the solve route takes the kernel for ``op``'s mesh: a mesh
    the plan places, up to :data:`JOIN_MAX_NODES`."""
    kind = K2 if op.mesh.is_tensor_product else K3
    return mesh_plan(op) is not None and op.mesh.num_vertices <= JOIN_MAX_NODES[(kind, op.mesh.dim)]


def fused_direct_supported(op: DPPOperator) -> bool:
    """Whether K2 takes this operator: a quad/hex mesh its plan places."""
    return op.mesh.is_tensor_product and _joins(op)


def fused_simplicial_direct_supported(op: DPPOperator) -> bool:
    """Whether K3 takes this operator: a tri/tet mesh its plan places."""
    return not op.mesh.is_tensor_product and _joins(op)


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


def _axis_ptrs(first: Tuple[int, ...], mats) -> Tuple[int, int, int]:
    """Pointers of the x, y, z eigenvector matrices, an axis with the same
    eigenbasis as an earlier one (``first``, :func:`distinct_axes`) sharing
    its pointer (2D passes x as the unused z). The buffers are contiguous:
    they are built from numpy."""
    ptrs = [mats[first[a]].data_ptr() for a in range(len(mats))]
    return ptrs[0], ptrs[1], ptrs[-1] if len(ptrs) == 3 else ptrs[0]


class _Launched(nn.Module):
    """What K2 and K3 share: the plan, the cached weights and the launch
    placement the launcher last reported (threads, nodes a thread owns,
    dynamic shared memory, blocks). Each launch reads its buffers' pointers
    anew, so a move or a copy of the module keeps working; a cast refuses
    (the kernels read fixed element types)."""

    def _setup(self, op: DPPOperator, what: str, tensor: bool):
        self.plan = mesh_plan(op)
        if op.mesh.is_tensor_product != tensor or self.plan is None:
            raise ValueError(f"mesh {op.mesh} is outside the {what} envelope: the launcher's plan places it nowhere")
        self.node_shape = op.mesh.node_shape
        self._first = distinct_axes(op.mesh)
        self.stencils = dpp_stencils(op.mesh, op.params)
        self._weights = packed_weights(*self.stencils)
        self._placement = np.zeros(4, np.int32)

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def _apply(self, fn, recurse=True):
        dtypes = [t.dtype for t in self.buffers()]
        super()._apply(fn, recurse)
        if [t.dtype for t in self.buffers()] != dtypes:
            raise TypeError(f"{type(self).__name__} keeps its buffers' dtypes: build a new solver instead of a cast")
        return self

    @property
    def last_placement(self) -> DirectPlan:
        threads, per, nbytes, blocks = (int(v) for v in self._placement)
        return DirectPlan(threads, per, nbytes, blocks)


class FusedDirectSolver(_Launched):
    """K2: the mixed-precision direct solve of a small quad/hex system.

    Buffers: the f32 fast-diag solver's per-axis eigenvectors and per-mode
    ``a11``, ``a22``, ``det``. Every f32 solve is scaled by the max of its
    right-hand side; boundary rows take the right-hand side exactly.
    """

    def __init__(self, op: DPPOperator, refinements: int = 5):
        super().__init__()
        self._setup(op, "fused direct", True)
        self.refinements = refinements
        self.fast32 = FastDiagDPPSolver(op.mesh, op.params, device=op.W.device, dtype=torch.float32)
        # the kernel multiplies by the determinants' inverses (the twin divides)
        self.register_buffer("idet", (1.0 / self.fast32.det.double()).float().reshape(-1))
        self._grid = _grid_args(self.node_shape)

    def launch_args(self) -> tuple:
        """The launcher's arguments but b and x (and the stream)."""
        fd = self.fast32
        return (*_axis_ptrs(self._first, fd.mats), fd.a11.data_ptr(), fd.a22.data_ptr(), self.idet.data_ptr(),
                fd.a12, self._weights.ctypes.data, *self._grid, self.refinements, self._placement.ctypes.data)

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
        x = torch.empty_like(b)
        _cuda.launch(K2, "perphil_fused_direct", b.device, b.data_ptr(), x.data_ptr(), *self.launch_args())
        return x

    def forward(self, b1: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b = _stacked(b1, b2)
        _check_device(self.device, b)
        x = self.plain(b) if b.device.type == "cpu" else self.launch(b)
        return x[0], x[1]


def fused_direct_solve(op: DPPOperator, refinements: int = 5) -> FusedDirectSolver:
    """K2 solver for ``op``: call it as ``solve(b1, b2) -> (z1, z2)``."""
    return FusedDirectSolver(op, refinements)


def dense_preconditioner(pc: LumpedDPPPreconditioner) -> torch.Tensor:
    """Each field's lumped fast-diag interior solve as one matrix,
    ``T diag(1 / sc_f) T^T`` with ``T`` the Kronecker product of the axes'
    eigenbases (slowest axis first, as the interior index runs): a
    ``(2, nint, nint)`` f64 tensor on ``pc``'s device, for K3's dense
    placement."""
    T = np.ones((1, 1))
    for S, _ in pc.pc1.eig:  # x first: each later axis is slower
        T = np.kron(S, T)
    mats = [T @ np.diag(1.0 / f.mode_scale.reshape(-1).cpu().numpy()) @ T.T for f in (pc.pc1, pc.pc2)]
    return torch.as_tensor(np.stack(mats), device=pc.pc1.mode_scale.device)


class FusedSimplicialSolver(_Launched):
    """K3: f64 PCG to ``rtol`` (at most ``max_it`` iterations) on a small
    tri/tet system, preconditioned by the lumped fast-diag per field.

    Buffers: the preconditioner's per-axis lumped eigenvectors and the
    per-field mode scales ``sc`` (2, interior nodes).
    """

    def __init__(self, op: DPPOperator, rtol: float = 1e-13, max_it: int = 2000):
        super().__init__()
        self._setup(op, "fused simplicial", False)
        self.rtol = rtol
        self.max_it = max_it
        self.pc = LumpedDPPPreconditioner(op.mesh, op.params, device=op.W.device)
        self.register_buffer(
            "sc", torch.stack([self.pc.pc1.mode_scale.reshape(-1), self.pc.pc2.mode_scale.reshape(-1)])
        )
        dense = self.plan.threads == DENSE_THREADS and self.plan.blocks == 1
        self.register_buffer("dense", dense_preconditioner(self.pc) if dense else None)
        # the kernel multiplies by the mode scales' inverses (the twin divides)
        self.register_buffer("isc", 1.0 / self.sc)
        self._grid = _grid_args(self.node_shape)

    def launch_args(self) -> tuple:
        """The launcher's arguments but b, x, the iteration count (and the
        stream)."""
        return (*_axis_ptrs(self._first, self.pc.pc1.mats), self.isc.data_ptr(),
                None if self.dense is None else self.dense.data_ptr(), self._weights.ctypes.data, *self._grid,
                float(self.rtol), int(self.max_it), self._placement.ctypes.data)

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
        _cuda.launch(K3, "perphil_fused_pcg", b.device, b.data_ptr(), x.data_ptr(), its.data_ptr(),
                     *self.launch_args())
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
