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
which keeps its bits. The kernel spreads the grid over a thread block
cluster of 1-16 blocks by slabs of interior node rows (:func:`slab_rows`),
each block holding its rows of x and b with a halo row on either side in
shared memory and pushing its edge rows' updates into its neighbours'
halos; the norm's residuals go to the fused GMRES frame's tree layout
(:func:`tree_slots`). :func:`fused_ngs_plan` mirrors its launcher,
:func:`ngs_tables` builds its colour lists. Beyond the plan the solver runs
:func:`ngs_host_loop` (K1 residuals, a norm read back each iteration).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.ops.fused_gmres import MAX_BLOCKS, MAX_LEAVES, _next_pow2, _slice_len
from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper
from perphil_tpu_torch.ops.krylov import CLUSTER_THREADS, _norm

KERNEL = "fused_ngs"
#: dynamic shared memory a launch may plan with, in bytes (the launcher's
#: ``kNgsSmemBudget``, read from its source)
SMEM_BUDGET = _cuda.header_constant("fused_ngs.cu", "kNgsSmemBudget")
#: colours the kernel's bounds table holds at most
MAX_COLORS = _cuda.header_constant("fused_ngs.cu", "kNgsMaxColors")
RESULT_SLOTS = _cuda.header_constant("fused_ngs.cu", "kNgsResultSlots")
#: the most blocks the launcher's rule takes (``kNgsRuleBlocks``)
RULE_BLOCKS = _cuda.header_constant("fused_ngs.cu", "kNgsRuleBlocks")
#: shared memory's 4-byte banks hold 16 doubles a row
BANKS = 16


class NgsPlan(NamedTuple):
    """The launcher's placement: ``blocks`` of 512 threads in one cluster,
    at most ``rows`` interior node rows a block, the norm's tree at
    ``leaves`` values a thread and ``nloc`` values a block, ``width``
    entries of a block's colour list at most (both fields of its rows'
    interior nodes), and the dynamic shared memory in bytes (x with its two
    halo rows, b, the tree's slice and the list, each rounded up to 16)."""

    blocks: int
    rows: int
    leaves: int
    nloc: int
    width: int
    bytes: int


class NgsResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float
    initial_norm: float


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def _place(ny: int, nx: int, ncolors: int, blocks: int) -> Optional[NgsPlan]:
    """``ngs_place``: ``blocks`` blocks (a power of two, at most 16, the
    interior rows and ``Lt / 512``), the tree at most 32 leaves a thread,
    the slab within :data:`SMEM_BUDGET`."""
    if nx < 3 or ny < 3 or not 1 <= ncolors <= MAX_COLORS:
        return None
    if not 1 <= blocks <= MAX_BLOCKS or blocks & (blocks - 1) or blocks > ny - 2:
        return None
    L = 2 * nx * ny
    if CLUSTER_THREADS * blocks > max(CLUSTER_THREADS, _next_pow2(L)):
        return None
    leaves = 1
    while CLUSTER_THREADS * blocks * leaves < L:
        leaves *= 2
    if leaves > MAX_LEAVES:
        return None
    nloc, rows = _slice_len(L, blocks), -(-(ny - 2) // blocks)
    width = 2 * rows * (nx - 2)
    nbytes = (_align16(16 * (rows + 2) * nx) + _align16(16 * rows * nx) + _align16(8 * nloc)
              + _align16(2 * width))
    return NgsPlan(blocks, rows, leaves, nloc, width, nbytes) if nbytes <= SMEM_BUDGET else None


def fused_ngs_plan(node_shape: Tuple[int, ...], ncolors: int, blocks: Optional[int] = None) -> Optional[NgsPlan]:
    """The launcher's plan (``ngs_geometry`` in ``csrc/fused_ngs.cu``) for a
    2D grid of ``node_shape`` nodes on ``blocks`` blocks, or None where it
    refuses. Left open, ``blocks`` is the launcher's rule: the most blocks,
    up to :data:`RULE_BLOCKS`, that place the grid."""
    if len(node_shape) != 2:
        return None
    ny, nx = node_shape
    if blocks is not None:
        return _place(ny, nx, ncolors, blocks)
    nb = RULE_BLOCKS
    while nb >= 1:
        plan = _place(ny, nx, ncolors, nb)
        if plan is not None:
            return plan
        nb //= 2
    return None


def slab_rows(ny: int, blocks: int) -> List[Tuple[int, int]]:
    """Each block's slab ``(r0, rows)``: the ``ny - 2`` interior node rows
    in order, the first ``(ny - 2) % blocks`` blocks one row more."""
    base, extra = divmod(ny - 2, blocks)
    return [(1 + b * base + min(b, extra), base + (b < extra)) for b in range(blocks)]


def tree_slots(num_values: int, blocks: int) -> Tuple[np.ndarray, np.ndarray]:
    """Where the norm stores value e's residual: block ``(e >> 2) mod
    blocks``, slot ``((e >> 2) // blocks) * 4 + e mod 4`` (the fused GMRES
    frame's ownership, whose cluster tree sums it)."""
    e = np.arange(num_values)
    piece = e >> 2
    return piece % blocks, (piece // blocks) * 4 + (e & 3)


def _deal(rows: np.ndarray, bank: np.ndarray) -> np.ndarray:
    """``rows`` (indices into ``bank``, in offset order) in groups of a
    warp's 32, each group taking from every bank in turn, the fullest
    first, so that no bank gives a group more rows than the banks left
    force."""
    queues = [list(rows[bank[rows] == k]) for k in range(BANKS)]
    out = []
    while any(queues):
        taken = [0] * BANKS
        group = 0
        while group < 32 and any(queues):
            for k in sorted(range(BANKS), key=lambda k: (taken[k], -len(queues[k]))):
                if queues[k]:
                    out.append(queues[k].pop(0))
                    taken[k] += 1
                    group += 1
                    break
    return np.asarray(out, np.int64)


def ngs_tables(
    node_shape: Tuple[int, int], colors: np.ndarray, plan: NgsPlan
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's tables for the colouring ``colors`` (a colour a value,
    field-major): per block its interior rows by colour, ``(blocks, width)``
    uint16 padded with 0, an entry the value's offset in the block's slab of
    x (``f * (rows + 2) * nx + (local row) * nx + i``, local row 0 the halo
    below), a colour's rows dealt out by their offset in the field modulo
    :data:`BANKS` (:func:`_deal`), so that a warp's 32 rows read each tap
    from as many of shared memory's banks as they can (a colour's rows are
    sparse in the slab; no row of a colour reads another, so their order is
    free); each block's colour bounds in its list, ``(blocks, ncolors + 1)``
    int32; and the values of each colour it pushes to the block below and
    above (its first and last row's), ``(blocks, ncolors, 2)`` int32."""
    ny, nx = node_shape
    ncolors = int(colors.max()) + 1
    cols = colors.reshape(2, ny, nx)
    fs = (plan.rows + 2) * nx
    lists = np.zeros((plan.blocks, plan.width), np.uint16)
    cptr = np.zeros((plan.blocks, ncolors + 1), np.int32)
    sends = np.zeros((plan.blocks, ncolors, 2), np.int32)
    f, j, i = np.meshgrid(np.arange(2), np.arange(1, ny - 1), np.arange(1, nx - 1), indexing="ij")
    for b, (r0, rows) in enumerate(slab_rows(ny, plan.blocks)):
        mine = (j >= r0) & (j < r0 + rows)
        within = (j[mine] - r0 + 1) * nx + i[mine]  # the offset in the field
        code = f[mine] * fs + within
        c = cols[f[mine], j[mine], i[mine]]
        order = np.concatenate([_deal(np.flatnonzero(c == k)[np.argsort(code[c == k])], within % BANKS)
                                for k in range(ncolors)])
        lists[b, : order.size] = code[order]
        cptr[b, 1:] = np.cumsum(np.bincount(c, minlength=ncolors))
        if b > 0:
            sends[b, :, 0] = np.bincount(cols[:, r0, 1:-1].ravel(), minlength=ncolors)
        if b < plan.blocks - 1:
            sends[b, :, 1] = np.bincount(cols[:, r0 + rows - 1, 1:-1].ravel(), minlength=ncolors)
    return lists, cptr, sends


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
    :param blocks: the kernel's block count (left open: the launcher's
        rule; any count :func:`fused_ngs_plan` places, for measurements).
    """

    def __init__(
        self,
        op: DPPOperator,
        sweeper: Optional[ColoredNGSSweeper] = None,
        rtol: float = 1e-8,
        atol: float = 1e-50,
        max_it: int = 50,
        blocks: Optional[int] = None,
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
        self.blocks = blocks
        self.plan = fused_ngs_plan(self.node_shape, self.sweeper.ncolors, blocks=blocks)
        sw = self.sweeper
        self.weights = np.concatenate([sw.weights.ravel(), np.asarray(sw.diag)])
        self.register_buffer("lists", None)
        self.register_buffer("cptr", None)
        self.register_buffer("sends", None)

    def plain(self, b: torch.Tensor, x0: torch.Tensor) -> NgsResult:
        """Plain PyTorch twin (any device): the kernel's arithmetic, the
        stop test on the host."""
        sw = self.sweeper
        return picard_loop(
            lambda x, r: sw.sweep_stacked(x, b, r), lambda x: sw.residual(x, b), x0, self.rtol, self.atol, self.max_it
        )

    def launch_args(self, b: torch.Tensor, x0: torch.Tensor, x: torch.Tensor, result: torch.Tensor) -> tuple:
        """The launcher's arguments (all but the stream) for stacked f64
        CUDA tensors ``b``, ``x0``, the output ``x`` and ``result``
        (:data:`RESULT_SLOTS` f64)."""
        if self.plan is None:
            raise ValueError(f"mesh {self.node_shape} with {self.sweeper.ncolors} colours is beyond the fused NGS plan")
        shape = (2,) + self.node_shape
        for name, t in (("b", b), ("x0", x0), ("x", x)):
            _cuda.require_cuda_tensor(t, name, torch.float64, self.device)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if self.lists is None:
            lists, cptr, sends = ngs_tables(self.node_shape, self.sweeper.colors, self.plan)
            self.lists = torch.tensor(lists.view(np.int16), device=self.device)  # the kernel reads uint16
            self.cptr = torch.tensor(cptr, device=self.device)
            self.sends = torch.tensor(sends, device=self.device)
        ny, nx = self.node_shape
        p = self.plan
        return (
            b.data_ptr(), x0.data_ptr(), x.data_ptr(), self.lists.data_ptr(), self.cptr.data_ptr(),
            self.sends.data_ptr(), result.data_ptr(), self.weights.ctypes.data,
            ny, nx, self.sweeper.ncolors, self.rtol, self.atol, self.max_it,
            0 if self.blocks is None else p.blocks,  # 0: the launcher applies its own rule
            p.rows, p.nloc, p.width,
        )

    def launch(self, b: torch.Tensor, x0: torch.Tensor) -> NgsResult:
        """Run ``csrc/fused_ngs.cu`` on stacked f64 CUDA tensors; reads the
        iteration count and the norms back."""
        x = torch.empty_like(b)
        result = torch.empty(RESULT_SLOTS, dtype=torch.float64, device=b.device)
        _cuda.launch(KERNEL, "perphil_fused_ngs", b.device, *self.launch_args(b, x0, x, result))
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
