"""The pinned-colouring SNES ``ngs`` Picard solve on quad meshes in one
kernel launch (``csrc/fused_ngs.cu``).

Counterpart of the JAX package's device-resident ngs loop
(``perphil_tpu/solvers/solver.py:1852-1911``, ``_build_nonlinear_solver``;
on the TPU ``_build_ngs_solver_df``): from the BC lift ``x0``,

    f0 = ||b - A x0||,  tol = max(rtol f0, atol)
    while fn > tol and its < max_it:
        for each colour c, ascending: x[c] += (b - A x)[c] / diag[c]
        fn = ||b - A x||

with the colours of ``ops/ordering.py::ngs_parity_coloring`` and the
residual of :class:`ilu.ColoredNGSSweeper`; the residual that a norm
computes serves the next iteration's colour 0, and every norm is the
halving tree (:func:`krylov.tree_sum`). :meth:`FusedNGSSolver.plain` is the
plain PyTorch twin (the CPU route), :meth:`FusedNGSSolver.launch` the kernel,
which keeps its bits. The kernel places the vector as the fused GMRES frame
does (``ops/fused_gmres.py::launch_geometry``: one block up to 512 values,
then a cluster of up to 16) and holds x, b and the residual in shared
memory; :func:`fused_ngs_plan` mirrors its launcher. Beyond the plan the
solver runs :func:`ngs_host_loop` (K1 residuals, a norm read back each
iteration).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.ops.fused_gmres import _slice_len, launch_geometry
from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper
from perphil_tpu_torch.ops.krylov import _norm

KERNEL = "fused_ngs"
#: dynamic shared memory a launch may plan with, in bytes (the launcher's
#: ``kNgsSmemBudget``, read from its source)
SMEM_BUDGET = _cuda.header_constant("fused_ngs.cu", "kNgsSmemBudget")
#: colours the kernel's bounds table holds at most
MAX_COLORS = _cuda.header_constant("fused_ngs.cu", "kNgsMaxColors")
RESULT_SLOTS = _cuda.header_constant("fused_ngs.cu", "kNgsResultSlots")
_XCHG_DOUBLES = 4096  # the norm's exchange between blocks (fused_gmres.cuh::kXchgDoubles)


class NgsPlan(NamedTuple):
    """The launcher's placement: ``blocks`` of 512 threads in one cluster,
    ``leaves`` values a thread, ``nloc`` values a block owns at most, and
    the dynamic shared memory in bytes (x, b, the residual and the block's
    colour lists: 28 bytes a value owned)."""

    blocks: int
    leaves: int
    nloc: int
    bytes: int


class NgsResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float
    initial_norm: float


def fused_ngs_plan(node_shape: Tuple[int, ...], ncolors: int) -> Optional[NgsPlan]:
    """The launcher's plan (``ngs_geometry`` in ``csrc/fused_ngs.cu``) for a
    2D grid of ``node_shape`` nodes, or None where it refuses: more than
    32 leaves a thread, more than :data:`MAX_COLORS` colours, or more
    shared memory than :data:`SMEM_BUDGET`."""
    if len(node_shape) != 2 or not 1 <= ncolors <= MAX_COLORS:
        return None
    L = 2 * int(np.prod(node_shape))
    try:
        geo = launch_geometry(L)
    except ValueError:
        return None
    nloc = _slice_len(L, geo.blocks)
    nbytes = (28 * nloc + 15) // 16 * 16
    return NgsPlan(geo.blocks, geo.leaves, nloc, nbytes) if nbytes <= SMEM_BUDGET else None


def owner_lists(node_shape: Tuple[int, int], colors: np.ndarray, blocks: int, nloc: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's colour lists: per block its interior rows' slots sorted
    by (colour, slot), ``(blocks, nloc)`` int32 padded with 0, and each
    block's colour bounds in its list, ``(blocks, ncolors + 1)`` int32.
    Value e lives on block ``(e >> 2) mod blocks`` in slot ``((e >> 2) //
    blocks) * 4 + e mod 4`` (the fused GMRES frame's ownership)."""
    ny, nx = node_shape
    ncolors = int(colors.max()) + 1
    e = np.arange(colors.size)
    j, i = np.divmod(e % (ny * nx), nx)
    interior = (j > 0) & (j < ny - 1) & (i > 0) & (i < nx - 1)
    piece = e >> 2
    owner, slot = piece % blocks, (piece // blocks) * 4 + (e & 3)
    lists = np.zeros((blocks, nloc), np.int32)
    cptr = np.zeros((blocks, ncolors + 1), np.int32)
    for b in range(blocks):
        mine = interior & (owner == b)
        order = np.lexsort((slot[mine], colors[mine]))
        lists[b, : order.size] = slot[mine][order]
        cptr[b, 1:] = np.cumsum(np.bincount(colors[mine], minlength=ncolors))
    return lists, cptr


def picard_loop(
    step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    residual: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor, rtol: float, atol: float, max_it: int,
) -> NgsResult:
    """The SNES loop of the Picard solves, on the host: ``x = step(x, r)``
    while ``||r|| > max(rtol ||r0||, atol)`` and fewer than ``max_it``
    iterations, ``r = residual(x)``; every norm a halving tree, read back."""
    r = residual(x)
    f0 = float(_norm(r))
    rel = rtol * f0
    tol = rel if rel > atol else atol  # Python's max(rtol * f0, atol)
    fn, its = f0, 0
    while fn > tol and its < max_it:
        x = step(x, r)
        r = residual(x)
        fn = float(_norm(r))
        its += 1
    return NgsResult(x, its, fn, f0)


class FusedNGSSolver(nn.Module):
    """The SNES ``ngs`` Picard solve on a quad mesh, ``(b, x0) -> NgsResult``
    on stacked ``(2, *node_shape)`` f64 tensors: ``b`` the lifted right-hand
    side, ``x0`` the BC lift. A CUDA tensor runs the kernel (one launch,
    counted as ``fused_ngs``; a mesh beyond :func:`fused_ngs_plan` raises),
    a CPU tensor the plain twin.

    :param sweeper: the mesh's :class:`ColoredNGSSweeper` (built here when
        not given; its colouring is the costly part).
    """

    def __init__(
        self,
        op: DPPOperator,
        sweeper: Optional[ColoredNGSSweeper] = None,
        rtol: float = 1e-8,
        atol: float = 1e-50,
        max_it: int = 50,
    ):
        super().__init__()
        mesh = op.mesh
        if mesh.element != "quad":
            raise ValueError(f"the fused NGS solve is pinned for quad meshes, got {mesh.element!r}")
        self.device = op.W.device
        self.sweeper = ColoredNGSSweeper(mesh, op.params, self.device) if sweeper is None else sweeper
        if self.sweeper.device != self.device or self.sweeper.mesh != mesh:
            raise ValueError("the sweeper belongs to another mesh or device")
        self.rtol, self.atol, self.max_it = float(rtol), float(atol), int(max_it)
        self.node_shape = tuple(mesh.node_shape)
        self.plan = fused_ngs_plan(self.node_shape, self.sweeper.ncolors)
        sw = self.sweeper
        self.weights = np.concatenate([sw.weights.ravel(), np.asarray(sw.diag)])
        self.register_buffer("lists", None)
        self.register_buffer("cptr", None)

    def plain(self, b: torch.Tensor, x0: torch.Tensor) -> NgsResult:
        """Plain PyTorch twin (any device): the kernel's arithmetic, the
        stop test on the host."""
        sw = self.sweeper
        return picard_loop(
            lambda x, r: sw.sweep_stacked(x, b, r), lambda x: sw.residual(x, b), x0, self.rtol, self.atol, self.max_it
        )

    def launch_args(self, b: torch.Tensor, x0: torch.Tensor, x: torch.Tensor, result: torch.Tensor) -> Tuple[tuple, torch.Tensor]:
        """The launcher's arguments (all but the stream) for stacked f64
        CUDA tensors ``b``, ``x0`` and the output ``x``, and the scratch
        they point to (keep it while the launch may run)."""
        if self.plan is None:
            raise ValueError(f"mesh {self.node_shape} with {self.sweeper.ncolors} colours is beyond the fused NGS plan")
        shape = (2,) + self.node_shape
        for name, t in (("b", b), ("x0", x0), ("x", x)):
            _cuda.require_cuda_tensor(t, name, torch.float64, self.device)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if self.lists is None:
            lists, cptr = owner_lists(self.node_shape, self.sweeper.colors, self.plan.blocks, self.plan.nloc)
            self.lists = torch.tensor(lists, device=self.device)
            self.cptr = torch.tensor(cptr, device=self.device)
        xchg = torch.empty(_XCHG_DOUBLES, dtype=torch.float64, device=b.device)
        ny, nx = self.node_shape
        args = (
            b.data_ptr(), x0.data_ptr(), x.data_ptr(), self.lists.data_ptr(), self.cptr.data_ptr(),
            xchg.data_ptr(), result.data_ptr(), self.weights.ctypes.data,
            ny, nx, self.sweeper.ncolors, self.rtol, self.atol, self.max_it, self.plan.blocks, self.plan.nloc,
        )
        return args, xchg

    def launch(self, b: torch.Tensor, x0: torch.Tensor) -> NgsResult:
        """Run ``csrc/fused_ngs.cu`` on stacked f64 CUDA tensors; reads the
        iteration count and the norms back."""
        x = torch.empty_like(b)
        result = torch.empty(RESULT_SLOTS, dtype=torch.float64, device=b.device)
        args, _scratch = self.launch_args(b, x0, x, result)
        _cuda.launch(KERNEL, "perphil_fused_ngs", b.device, *args)
        its, fn, f0 = result[:3].tolist()
        return NgsResult(x, int(its), fn, f0)

    def forward(self, b: torch.Tensor, x0: torch.Tensor) -> NgsResult:
        for t in (b, x0):
            if t.device != self.device:
                raise ValueError(f"tensor on {t.device}, solver built for {self.device}")
        if self.device.type == "cpu":
            return self.plain(b, x0)
        if self.device.type != "cuda":
            raise ValueError(f"the NGS solve runs on cpu or cuda, got {self.device}")
        return self.launch(b, x0)


def ngs_host_loop(
    op: DPPOperator, sweeper: ColoredNGSSweeper, b: torch.Tensor, x0: torch.Tensor,
    rtol: float, atol: float, max_it: int,
) -> NgsResult:
    """The same solve as a host loop (the route beyond the kernel's plan):
    per colour a K1 residual (``op.stacked_matvec()``) and a masked update,
    and one norm read back an iteration; the norm's residual serves colour
    0. K1 sums in its own order, so the bits are not the kernel's."""
    mv = op.stacked_matvec()

    def step(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        for c in range(sweeper.ncolors):
            if c > 0:
                r = b - mv(x)
            x = torch.where(sweeper.masks[c], x + r / sweeper.diagonal, x)
        return x

    return picard_loop(step, lambda x: b - mv(x), x0, rtol, atol, max_it)
