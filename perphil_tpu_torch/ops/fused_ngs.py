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

On blocks (the sharded Picard solve, ``parallel/sharding.py``): a rank
holds one block of the grid and steps colour by colour, each colour after a
plane exchange (``parallel/halo.py``), by :class:`NgsBlock`: its step is
the kernel ``csrc/ngs_colour_halo.cu`` on a CUDA tensor (counted as
``ngs_colour_halo``) and its plain twin :func:`colour_step_plain` on a CPU
one, both bit for bit with :class:`ilu.ColoredNGSSweeper`'s rows;
:func:`blocked_ngs` is the Picard loop over them, its norm the blocks'
tree sums reduced over the ranks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.ops.fused_gmres import MAX_BLOCKS, MAX_LEAVES, _next_pow2, _slice_len
from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper
from perphil_tpu_torch.ops.krylov import CLUSTER_THREADS, tree_sum

KERNEL = "fused_ngs"
COLOUR_KERNEL = "ngs_colour_halo"
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


def tree_geometry(num_values: int, blocks: int) -> Optional[Tuple[int, int]]:
    """(leaves a thread, values a block) of the norm's tree over
    ``num_values`` values on ``blocks`` blocks of 512 threads (the fused
    GMRES frame's layout), or None where the launchers refuse: more threads
    than ``Lt`` (the power of two at least 512 and the length), or more than
    32 leaves a thread."""
    if CLUSTER_THREADS * blocks > max(CLUSTER_THREADS, _next_pow2(num_values)):
        return None
    leaves = 1
    while CLUSTER_THREADS * blocks * leaves < num_values:
        leaves *= 2
    return (leaves, _slice_len(num_values, blocks)) if leaves <= MAX_LEAVES else None


def _place(ny: int, nx: int, ncolors: int, blocks: int) -> Optional[NgsPlan]:
    """``ngs_place``: ``blocks`` blocks (a power of two, at most 16, the
    interior rows and ``Lt / 512``), the tree at most 32 leaves a thread,
    the slab within :data:`SMEM_BUDGET`."""
    if nx < 3 or ny < 3 or not 1 <= ncolors <= MAX_COLORS:
        return None
    if not 1 <= blocks <= MAX_BLOCKS or blocks & (blocks - 1) or blocks > ny - 2:
        return None
    tree = tree_geometry(2 * nx * ny, blocks)
    if tree is None:
        return None
    (leaves, nloc), rows = tree, -(-(ny - 2) // blocks)
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


def picard_norm(r: torch.Tensor) -> float:
    """``||r||`` as the Picard kernels take it: the halving tree over the
    squares (:func:`krylov.tree_sum`), read back, and its correctly rounded
    square root (the kernels' ``__dsqrt_rn``; the card's ``torch.sqrt`` is
    too, but the CPU's is not always: 0.57 ulp off at one tri N=64 norm)."""
    v = r.reshape(-1)
    return math.sqrt(float(tree_sum(v * v)))


def picard_loop(
    step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    residual: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor, rtol: float, atol: float, max_it: int,
    norm: Callable[[torch.Tensor], float] = picard_norm,
) -> NgsResult:
    """The SNES loop of the Picard solves, on the host: ``x = step(x, r)``
    while ``||r|| > max(rtol ||r0||, atol)`` and fewer than ``max_it``
    iterations, ``r = residual(x)``; every norm ``norm`` (on blocks:
    :func:`blocked_norm`)."""
    r = residual(x)
    f0 = norm(r)
    rel = rtol * f0
    tol = rel if rel > atol else atol  # Python's max(rtol * f0, atol)
    fn, its = f0, 0
    while fn > tol and its < max_it:
        x = step(x, r)
        r = residual(x)
        fn = norm(r)
        its += 1
    return NgsResult(x, its, fn, f0)


def blocked_norm(blocks) -> Callable[[Dict], float]:
    """``||r||`` of a vector held as blocks (``parallel/transpose.py``):
    each block's halving tree over its squares, the sum over every block,
    the correctly rounded square root (one block: :func:`picard_norm`)."""

    def norm(rs: Dict) -> float:
        return math.sqrt(float(blocks.total({c: tree_sum((v * v).reshape(-1)) for c, v in rs.items()})))

    return norm


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

    def tolerances(self, tols: Optional[Tuple[float, float]] = None) -> Tuple[float, float]:
        """``(rtol, atol)`` of a call: ``tols`` where the caller gives them
        (the chunked continuation's ``(0, atol)``), else the solver's own."""
        return (self.rtol, self.atol) if tols is None else (float(tols[0]), float(tols[1]))

    def plain(self, b: torch.Tensor, x0: torch.Tensor, tols: Optional[Tuple[float, float]] = None) -> NgsResult:
        """Plain PyTorch twin (any device): the kernel's arithmetic, the
        stop test on the host."""
        sw = self.sweeper
        return picard_loop(
            lambda x, r: sw.sweep_stacked(x, b, r), lambda x: sw.residual(x, b), x0, *self.tolerances(tols), self.max_it
        )

    def launch_args(
        self, b: torch.Tensor, x0: torch.Tensor, x: torch.Tensor, result: torch.Tensor,
        tols: Optional[Tuple[float, float]] = None,
    ) -> tuple:
        """The launcher's arguments (all but the stream) for stacked f64
        CUDA tensors ``b``, ``x0``, the output ``x`` and ``result``
        (:data:`RESULT_SLOTS` f64); ``tols``: the call's ``(rtol, atol)``
        (:meth:`tolerances`)."""
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
            ny, nx, self.sweeper.ncolors, *self.tolerances(tols), self.max_it,
            0 if self.blocks is None else p.blocks,  # 0: the launcher applies its own rule
            p.rows, p.nloc, p.width,
        )

    def launch(self, b: torch.Tensor, x0: torch.Tensor, tols: Optional[Tuple[float, float]] = None) -> NgsResult:
        """Run ``csrc/fused_ngs.cu`` on stacked f64 CUDA tensors; reads the
        iteration count and the norms back."""
        x = torch.empty_like(b)
        result = torch.empty(RESULT_SLOTS, dtype=torch.float64, device=b.device)
        _cuda.launch(KERNEL, "perphil_fused_ngs", b.device, *self.launch_args(b, x0, x, result, tols))
        its, fn, f0 = result[:3].tolist()
        return NgsResult(x, int(its), fn, f0)

    def forward(self, b: torch.Tensor, x0: torch.Tensor, tols: Optional[Tuple[float, float]] = None) -> NgsResult:
        for t in (b, x0):
            if t.device != self.device:
                raise ValueError(f"tensor on {t.device}, solver built for {self.device}")
        if self.device.type == "cpu":
            return self.plain(b, x0, tols)
        if self.device.type != "cuda":
            raise ValueError(f"the NGS solve runs on cpu or cuda, got {self.device}")
        return self.launch(b, x0, tols)


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


def _owned_box(x: torch.Tensor, planes) -> torch.Tensor:
    """The stacked 2D block ``x`` with a ghost row and column on every side:
    the received planes (``halo.exchange_planes``; the x planes hold the
    corners) where they arrived, zeros elsewhere."""
    two, ly, lx = x.shape
    box = x.new_zeros((two, ly + 2, lx + 2))
    box[:, 1:-1, 1:-1] = x
    for k, pair in enumerate(planes):
        for side, g in enumerate(pair):
            if g is None:
                continue
            if k == 0:
                box[:, 0 if side == 0 else ly + 1, 1:-1] = g[:, 0]
            else:
                box[:, :, 0 if side == 0 else lx + 1] = g[:, :, 0]
    return box


def colour_step_plain(
    x: torch.Tensor, b: torch.Tensor, planes, taps, diagonal: torch.Tensor, bdry: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Plain PyTorch twin of ``csrc/ngs_colour_halo.cu`` (any device) on a
    stacked ``(2, ly, lx)`` block and its received planes: every row's
    residual as :meth:`ilu.ColoredNGSSweeper.residual` computes it (the
    taps ``taps``, per tap ``(field, dy, dx, weights (2, 1, 1))``; a
    neighbour in ``bdry`` reads 0.0, ``bdry`` the box's boundary and
    phantom nodes), then with ``mask`` (the colour's rows) ``x + r /
    diagonal`` on them, without it (the residual mode) the residual."""
    _, ly, lx = x.shape
    box = _owned_box(x, planes)
    xi = torch.where(bdry, 0.0, box)
    acc = x.new_zeros(x.shape)
    for f, dy, dx, w in taps:
        acc = acc + w * xi[f, 1 + dy:1 + dy + ly, 1 + dx:1 + dx + lx]
    r = torch.where(bdry[1:-1, 1:-1], b - x, b - acc)
    if mask is None:
        return r
    return torch.where(mask, x + r / diagonal, x)


class NgsBlock:
    """The colour steps of :class:`ilu.ColoredNGSSweeper` on one block of
    the 2D node grid (``grid``: the node grid, padded or not, blocked on
    ``mesh_shape``) at ``coords``: per colour its rows (the kernel's int32
    list, field-major offsets in the block) and mask (the twin's); phantom
    nodes take no colour."""

    def __init__(self, sweeper: ColoredNGSSweeper, grid: Sequence[int], mesh_shape: Sequence[int],
                 coords: Sequence[int]):
        from perphil_tpu_torch.parallel.transpose import block_slices

        ny, nx = sweeper.mesh.node_shape
        grid = tuple(int(n) for n in grid)
        colors = np.full((2,) + grid, -1, np.int64)
        colors[:, :ny, :nx] = sweeper.colors.reshape(2, ny, nx)
        sl = block_slices(grid, mesh_shape, coords)
        own = colors[(slice(None),) + sl]
        self.shape = own.shape
        self.offsets = tuple(s.start or 0 for s in sl)
        self.n_phys = (ny, nx)
        self.ncolors = sweeper.ncolors
        dev = sweeper.device
        self.rows = [torch.tensor(np.flatnonzero(own == c).astype(np.int32), device=dev)
                     for c in range(self.ncolors)]
        self.masks = torch.tensor(np.stack([own == c for c in range(self.ncolors)]), device=dev)
        gy = np.arange(-1, self.shape[1] + 1) + self.offsets[0]
        gx = np.arange(-1, self.shape[2] + 1) + self.offsets[1]
        bdry = ((gy <= 0) | (gy >= ny - 1))[:, None] | ((gx <= 0) | (gx >= nx - 1))[None, :]
        self.bdry = torch.tensor(bdry, device=dev)
        inner = self.bdry[1:-1, 1:-1]
        self.diagonal = torch.stack([torch.full(inner.shape, d, dtype=torch.float64, device=dev).masked_fill_(inner, 1.0)
                                     for d in sweeper.diag])
        self.taps = [(t // 9, (t % 9) // 3 - 1, t % 3 - 1, w) for t, w in enumerate(sweeper._taps)]
        self.weights = np.ascontiguousarray(np.concatenate([sweeper.weights.ravel(), np.asarray(sweeper.diag)]))
        self.device = dev

    def _launch(self, x: torch.Tensor, b: torch.Tensor, planes, rows: Optional[torch.Tensor],
                r: Optional[torch.Tensor]) -> None:
        for name, t in (("x", x), ("b", b)):
            _cuda.require_cuda_tensor(t, name, torch.float64, x.device)
            if tuple(t.shape) != self.shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, the block is {self.shape}")
        ptrs = [0, 0, 0, 0]
        for k, pair in enumerate(planes):
            for side, g in enumerate(pair):
                if g is not None:
                    _cuda.require_cuda_tensor(g, "plane", torch.float64, x.device)
                    ptrs[2 * k + side] = g.data_ptr()
        count = int(rows.numel()) if rows is not None else x.numel()
        _, ly, lx = self.shape
        _cuda.launch(
            COLOUR_KERNEL, "perphil_ngs_colour_halo", x.device, x.data_ptr(), b.data_ptr(), *ptrs,
            0 if rows is None else rows.data_ptr(), count, 0 if r is None else r.data_ptr(),
            self.weights.ctypes.data, ly, lx, *self.offsets, *self.n_phys,
        )

    def step(self, x: torch.Tensor, b: torch.Tensor, planes, colour: int) -> torch.Tensor:
        """Colour ``colour``'s step: on a CUDA tensor the kernel, in place
        (``x`` returned; no launch where the block holds no row of the
        colour), on a CPU tensor the twin (a new tensor)."""
        if x.device.type == "cpu":
            return colour_step_plain(x, b, planes, self.taps, self.diagonal, self.bdry, self.masks[colour])
        if self.rows[colour].numel():
            self._launch(x, b, planes, self.rows[colour], None)
        return x

    def residual(self, x: torch.Tensor, b: torch.Tensor, planes) -> torch.Tensor:
        """Every row's residual ``b - A x`` (the kernel's residual mode on a
        CUDA tensor, the twin on a CPU one)."""
        if x.device.type == "cpu":
            return colour_step_plain(x, b, planes, self.taps, self.diagonal, self.bdry, None)
        r = torch.empty_like(x)
        self._launch(x, b, planes, None, r)
        return r


def blocked_ngs(blocks, parts: Dict, b: Dict, x0: Dict, rtol: float, atol: float, max_it: int) -> NgsResult:
    """The pinned-colouring Picard solve on the blocks ``blocks`` holds
    (``parallel/transpose.py``), ``parts`` their :class:`NgsBlock` s: per
    iteration a plane exchange and the residual (which colour 0 steps by),
    then for every further colour an exchange and its step; the norm
    :func:`blocked_norm`. ``x0`` is stepped in place on the card."""
    ncolors = next(iter(parts.values())).ncolors
    seen = {}

    def residual(x):
        seen["planes"] = blocks.planes(x)
        return {c: parts[c].residual(x[c], b[c], seen["planes"][c]) for c in x}

    def step(x, r):
        for k in range(ncolors):
            planes = seen["planes"] if k == 0 else blocks.planes(x)
            x = {c: parts[c].step(x[c], b[c], planes[c], k) for c in x}
        return x

    return picard_loop(step, residual, {c: v.contiguous() for c, v in x0.items()}, rtol, atol, max_it,
                       norm=blocked_norm(blocks))
