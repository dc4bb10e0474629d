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

On blocks (the sharded Picard solve, ``parallel/sharding.py``): a process
holds one block of the grid (a rank) or several (loopback), and
:class:`NgsSweep` runs the iteration on all of them with no round trip to
the host: a colour step of every block is one launch of
``csrc/ngs_colour_halo.cu`` (counted as ``ngs_colour_halo``), a ghost read
in the neighbour block where it is in the process and in a fixed receive
buffer where it is on another rank; the norm and the stop test are one
call of two dependent launches (``ngs_colour_norm``, counted once a call)
that leaves done, the count and the norms in a state on the card. :func:`blocked_ngs` issues :data:`ITERATIONS_PER_READ`
iterations between read-backs of that state, from a CUDA graph where no
peer is involved. The twins (:func:`colour_step_box`, :func:`stop_plain`)
run the same loop on CPU tensors, bit for bit with
:class:`ilu.ColoredNGSSweeper`'s rows and :func:`blocked_ngs_loop`, the
first blocked loop (a norm read back every iteration), which stays as the
reference and, with the first kernel (:func:`blocked_ngs_probe`), as the
probe it is timed against.
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


def colour_step_box(
    box: torch.Tensor, b: torch.Tensor, taps, diagonal: torch.Tensor, bdry: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Plain PyTorch twin of a colour step of ``csrc/ngs_colour_halo.cu``
    (any device) on a block extended by a ghost row and column on every
    side (``box``, ``(2, ly + 2, lx + 2)``): every row's residual as
    :meth:`ilu.ColoredNGSSweeper.residual` computes it (the taps ``taps``,
    per tap ``(field, dy, dx, weights (2, 1, 1))``; a neighbour in ``bdry``
    reads 0.0, ``bdry`` the box's boundary and phantom nodes), then with
    ``mask`` (the colour's rows) ``x + r / diagonal`` on them, without it
    (the norm's residual) the residual."""
    x = box[:, 1:-1, 1:-1]
    _, ly, lx = x.shape
    xi = torch.where(bdry, 0.0, box)
    acc = x.new_zeros(x.shape)
    for f, dy, dx, w in taps:
        acc = acc + w * xi[f, 1 + dy:1 + dy + ly, 1 + dx:1 + dx + lx]
    r = torch.where(bdry[1:-1, 1:-1], b - x, b - acc)
    if mask is None:
        return r
    return torch.where(mask, x + r / diagonal, x)


def colour_step_plain(
    x: torch.Tensor, b: torch.Tensor, planes, taps, diagonal: torch.Tensor, bdry: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """:func:`colour_step_box` on a stacked ``(2, ly, lx)`` block and its
    received planes (``halo.exchange_planes``)."""
    return colour_step_box(_owned_box(x, planes), b, taps, diagonal, bdry, mask)


class NgsBlock:
    """The colour steps of :class:`ilu.ColoredNGSSweeper` on one block of
    the 2D node grid (``grid``: the node grid, padded or not, blocked on
    ``mesh_shape``) at ``coords``: per colour its rows (field-major offsets
    in the block, int32) and mask (the twin's); phantom nodes take no
    colour. The twins' steps (:meth:`step`, :meth:`residual`) take the
    received planes; :class:`NgsSweep` runs every block of a process."""

    def __init__(self, sweeper: ColoredNGSSweeper, grid: Sequence[int], mesh_shape: Sequence[int],
                 coords: Sequence[int]):
        from perphil_tpu_torch.parallel.transpose import block_slices

        ny, nx = sweeper.mesh.node_shape
        grid = tuple(int(n) for n in grid)
        colors = np.full((2,) + grid, -1, np.int64)
        colors[:, :ny, :nx] = sweeper.colors.reshape(2, ny, nx)
        sl = block_slices(grid, mesh_shape, coords)
        own = colors[(slice(None),) + sl]
        self.colors = own
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

    def interior(self) -> np.ndarray:
        """``(ly, lx)`` bool: the nodes whose rows take the kernel's
        straight path, every tap in the block and none on the boundary."""
        _, ly, lx = self.shape
        ny, nx = self.n_phys
        j, i = np.arange(ly)[:, None], np.arange(lx)[None, :]
        gj, gi = j + self.offsets[0], i + self.offsets[1]
        return ((j >= 1) & (j <= ly - 2) & (i >= 1) & (i <= lx - 2)
                & (gj >= 2) & (gj <= ny - 3) & (gi >= 2) & (gi <= nx - 3))

    def _plain_only(self, x: torch.Tensor) -> None:
        if x.device.type != "cpu":
            raise ValueError("NgsBlock's steps are the twins (CPU tensors); on the card the kernel runs "
                             "every block of a process at once (NgsSweep)")

    def step(self, x: torch.Tensor, b: torch.Tensor, planes, colour: int) -> torch.Tensor:
        """Colour ``colour``'s step by the twin, a new tensor (CPU)."""
        self._plain_only(x)
        return colour_step_plain(x, b, planes, self.taps, self.diagonal, self.bdry, self.masks[colour])

    def residual(self, x: torch.Tensor, b: torch.Tensor, planes) -> torch.Tensor:
        """Every row's residual ``b - A x`` by the twin (CPU)."""
        self._plain_only(x)
        return colour_step_plain(x, b, planes, self.taps, self.diagonal, self.bdry, None)


# -- the blocked iteration on the card: csrc/ngs_colour_halo.cu -------------

COLOUR_SOURCE = "ngs_colour_halo.cu"
NORM_KERNEL = "ngs_colour_norm"
NORM_THREADS = _cuda.header_constant(COLOUR_SOURCE, "kNormThreads")
#: the leaves a norm tree thread sums where the block allows (the tree's
#: CTAs of a block: its padded length over NORM_THREADS * NORM_LEAVES, 1 to
#: 256): one leaf a thread, as many CTAs as that takes. The rows stage does
#: not depend on it (a thread a row, ceil(n / 256) CTAs a block). The first
#: norm kernel computed its rows in the tree's layout: 4 rows a thread on 64
#: CTAs took 0.0176 ms at 2D N=128, one row on 256 0.0100 (an H100 at 700 W,
#: ``chip_smoke.py`` phase 14); 2 leaves a thread against 1 in the two-stage
#: norm: tied on one block, slower on 8 slabs (``--only ngs-blocked``).
NORM_LEAVES = 1
MAX_PARTS = _cuda.header_constant(COLOUR_SOURCE, "kNgsMaxParts")
MAX_EXTENT = _cuda.header_constant(COLOUR_SOURCE, "kNgsMaxExtent")
MAX_LEAVES = _cuda.header_constant(COLOUR_SOURCE, "kNgsMaxLeaves")
STATE_SLOTS = _cuda.header_constant(COLOUR_SOURCE, "kNgsStateSlots")
#: the state's slots (``kState*``)
DONE, ITS, F0, FN, TOL, TOTAL, RTOL, ATOL, MAX_IT = range(9)
#: int64 words of one block's ``NgsPart``: x, b, 9 sources and 9 send
#: buffers of 4 words, ly, lx, oy, ox, cta0, ctas, leaves, r
PART_WORDS = 2 + 2 * 9 * 4 + 8
_SRC, _SND, _META = 2, 2 + 36, 2 + 72
#: Iterations issued between two read-backs of the stop state (done, its,
#: fn). Issued past the stop, an iteration costs its launches and changes
#: nothing; a read-back costs a host round trip with the card idle. Timed
#: on one block in turns (``tools/profile_kernels.py --only ngs-blocked``;
#: an H100 at 700 W): 8 / 16 / 32 / 64 took 0.163-0.126 / 0.134-0.128 /
#: 0.136-0.128 / 0.158-0.114 s at 2D N=64 (1673 iterations) and 0.381-0.374
#: / 0.348-0.369 / 0.360-0.373 / 0.384-0.350 s at N=128 (5135), an
#: iteration 63-65 µs from the graph at every k: the read-backs are lost in
#: the noise from 16 on, and 32 wastes at most 31 iterations (~2 ms).
ITERATIONS_PER_READ = 32


def directions(mesh_shape: Sequence[int], coords: Sequence[int]) -> Dict[int, Tuple[int, ...]]:
    """The neighbours of the block at ``coords`` of a 2D grid blocked on
    ``mesh_shape`` (mesh axis k splits grid axis k): direction ``(sy + 1) * 3
    + (sx + 1)`` -> the neighbour's coords, the eight directions of a 9-point
    stencil (a corner neighbour across two split axes)."""
    out = {}
    for sy in (-1, 0, 1):
        for sx in (-1, 0, 1):
            if (sy, sx) == (0, 0) or (sx and len(mesh_shape) < 2):
                continue
            c = (coords[0] + sy,) + ((coords[1] + sx,) if len(mesh_shape) > 1 else ())
            if all(0 <= v < int(m) for v, m in zip(c, mesh_shape)):
                out[(sy + 1) * 3 + sx + 1] = tuple(c)
    return out


def side_shape(d: int, ly: int, lx: int) -> Tuple[int, ...]:
    """The send / receive buffer of direction ``d``: a row (2, lx), a
    column (2, ly) or a corner (2,)."""
    sy, sx = d // 3 - 1, d % 3 - 1
    return (2,) if sy and sx else ((2, lx) if sy else (2, ly))


def side_strides(d: int, ly: int, lx: int) -> Tuple[int, int, int]:
    """(field, row, column) strides of direction ``d``'s buffer, as the
    kernel indexes it at a ghost's (or an edge row's) local (j, i)."""
    sy, sx = d // 3 - 1, d % 3 - 1
    return (1, 0, 0) if sy and sx else ((lx, 0, 1) if sy else (ly, 1, 0))


def edge_of(x: torch.Tensor, d: int) -> torch.Tensor:
    """The rows of the stacked block ``x`` that direction ``d``'s neighbour
    reads: its first / last row, column or corner, in the buffer's shape."""
    sy, sx = d // 3 - 1, d % 3 - 1
    rows = slice(None) if sy == 0 else (0 if sy < 0 else -1)
    cols = slice(None) if sx == 0 else (0 if sx < 0 else -1)
    return x[:, rows, cols]


def norm_geometry(n_values: int) -> Tuple[int, int]:
    """(CTAs, leaves a thread) of the norm kernel's tree over a block of
    ``n_values`` values: the padded length (the power of two at least
    ``n_values``, and at least a CTA's threads) over NORM_THREADS *
    NORM_LEAVES CTAs, 1 to NORM_THREADS, and the leaves that cover it."""
    size = max(NORM_THREADS, 1 << max(0, (n_values - 1).bit_length()))
    ctas = min(NORM_THREADS, max(1, size // (NORM_THREADS * NORM_LEAVES)))
    return ctas, size // (ctas * NORM_THREADS)


def tree_sum_norm(v: torch.Tensor, ctas: int, leaves: int) -> torch.Tensor:
    """:func:`krylov.tree_sum` of a 1-D tensor as the norm kernel takes it
    (``ctas``, ``leaves``: :func:`norm_geometry`): value ``e = k * 256 ctas +
    t * ctas + b`` is leaf k of thread t of CTA b; each thread halves over
    its leaves, each CTA over its threads, the last over the CTAs. Equal to
    ``tree_sum`` bit for bit where no total is -0.0 (a sum of squares)."""
    size = ctas * NORM_THREADS * leaves
    if v.numel() > size:
        raise ValueError(f"{v.numel()} values for a tree of {size}")
    p = torch.cat([v, v.new_zeros(size - v.numel())]).reshape(leaves, NORM_THREADS, ctas)
    for _ in range(3):
        p = tree_sum(p, dim=0)
    return p


def _warp_tree(s: torch.Tensor) -> torch.Tensor:
    """Warp 0's tree over ``s`` (256 values along dim 0, as the CTA's shared
    memory holds them): lane l's ``v[m] = s[l + 32 m]``, m < 8; the levels t
    + 128, t + 64, t + 32 in its registers; then t + 16 ... t + 1 as
    ``__shfl_down_sync`` (lane l adds lane l + w's value, a lane past 31
    reads its own); lane 0's sum."""
    v = s.reshape(8, 32, *s.shape[1:])
    a = [v[m] + v[m + 4] for m in range(4)]
    lane = (a[0] + a[2]) + (a[1] + a[3])
    for w in (16, 8, 4, 2, 1):
        lane = lane + torch.cat([lane[w:], lane[32 - w:]])
    return lane[0]


def norm_replay(squares: Sequence[torch.Tensor], ctas: int, leaves: int) -> torch.Tensor:
    """The norm kernel's sum of squares over the blocks, replayed step by
    step: ``squares`` holds each block's n squares as the rows stage writes
    them (natural order, the block's L = ``leaves * 256 * ctas`` scratch,
    :func:`norm_geometry`); tree thread t of CTA b takes its leaves ``e = k
    * 256 ctas + t * ctas + b`` (0 where e >= n) in the kernel's order (k
    bit-reversed, a binary counter: the halving over k); the CTA stores its
    256 sums once and warp 0 reduces them (:func:`_warp_tree`); the block's
    last CTA reduces the ``ctas`` partials zero-padded to 256 the same way;
    the blocks' sums are added in order. The total, a 0-dim tensor (its root
    is ``finish``'s). Equal to :func:`krylov.tree_sum` of each block, added
    in order, bit for bit where no total is -0.0 (a sum of squares)."""
    size = ctas * NORM_THREADS * leaves
    e = torch.arange(size).reshape(leaves, NORM_THREADS, ctas)
    log_k = leaves.bit_length() - 1
    total = None
    for sq in squares:
        n = sq.numel()
        if n > size:
            raise ValueError(f"{n} values for a tree of {size}")
        scratch = torch.cat([sq.reshape(-1), sq.new_zeros(size - n)])
        leaf = torch.where(e < n, scratch[e], 0.0)
        stack = []
        for m in range(leaves):
            v = leaf[int(format(m, f"0{log_k}b")[::-1], 2) if log_k else 0]
            z = m
            while z & 1:
                v = stack.pop() + v
                z >>= 1
            stack.append(v)
        partials = _warp_tree(stack[0])
        block = _warp_tree(torch.cat([partials, partials.new_zeros(NORM_THREADS - ctas)]))
        total = block if total is None else total + block
    return total


class NgsSweep:
    """The colour steps and the norm of the pinned-colouring Picard
    iteration on every block ``blocks`` holds (``parallel/transpose.py``:
    ``LoopbackBlocks``, every block of a grid in this process, or
    ``RankBlocks``, this rank's), over the 2D node grid ``grid`` (padded or
    not). It owns each block's x and b and the exchange buffers, so that
    what the kernels read is built once:

      - on a CUDA device, ``csrc/ngs_colour_halo.cu``: a colour step is one
        launch over every block (counted as ``ngs_colour_halo``), the norm
        with the stop test two dependent launches, the rows then the tree
        (counted once a call as ``ngs_colour_norm``); the table of
        blocks (:data:`PART_WORDS` int64 a block) and each colour's rows
        (:meth:`row_lists`) live on the card;
      - on the CPU, the twins: :func:`colour_step_box` per block on the
        ghosts the kernel reads, and the plain norm and stop test
        (:meth:`_norm_plain`), with the same state.

    A ghost reads the neighbour block's x where that block is in this
    process; where it is on another rank (``RankBlocks`` in a world with
    peers, or ``remote=True``: loopback blocks that exchange through the
    same buffers, copied in memory, to check that path on one card) it
    reads a receive buffer, and the block's edge rows are written to a send
    buffer by the step that writes them (the kernel; the twin copies them).
    The exchange after each step moves them (:meth:`_exchange`: one
    ``batch_isend_irecv`` of up to eight neighbours, corners included).
    ``plain=True`` runs the twins on any device (the card's comparisons and
    the twins' times)."""

    def __init__(self, sweeper: ColoredNGSSweeper, grid: Sequence[int], blocks, remote: bool = False,
                 plain: bool = False):
        from perphil_tpu_torch.parallel.transpose import LoopbackBlocks

        self.blocks = blocks
        self.coords = tuple(blocks.coords)
        if not 1 <= len(self.coords) <= MAX_PARTS:
            raise ValueError(f"{len(self.coords)} blocks: the kernel's table holds 1 to {MAX_PARTS}")
        self.parts = {c: NgsBlock(sweeper, grid, blocks.mesh_shape, c) for c in self.coords}
        part = self.parts[self.coords[0]]
        self.ncolors, self.n_phys, self.weights = sweeper.ncolors, part.n_phys, part.weights
        _, ly, lx = self.shape = part.shape
        if max(ly, lx) > MAX_EXTENT:
            raise ValueError(f"block {self.shape}: the kernel's rows take extents up to {MAX_EXTENT}")
        dev = self.device = sweeper.device
        self.kernel = dev.type == "cuda" and not plain
        self.loopback = isinstance(blocks, LoopbackBlocks)
        # a world with peers: the exchange crosses ranks, the norm's total an all-reduce
        self.peers = not self.loopback and blocks.dmesh.size > 1
        self.remote = bool(remote) or self.peers
        if remote and not self.loopback:
            raise ValueError("remote=True is the loopback check of the exchange buffers")
        f64 = dict(dtype=torch.float64, device=dev)
        self.x = {c: torch.zeros(self.shape, **f64) for c in self.coords}
        self.b = {c: torch.zeros(self.shape, **f64) for c in self.coords}
        self.neighbours = {c: directions(blocks.mesh_shape, c) for c in self.coords}
        self.send, self.recv = {}, {}
        for c in self.coords:
            ds = self.neighbours[c] if self.remote else {}
            self.send[c] = {d: torch.zeros(side_shape(d, ly, lx), **f64) for d in ds}
            self.recv[c] = {d: torch.zeros(side_shape(d, ly, lx), **f64) for d in ds}
        self.state = torch.zeros(STATE_SLOTS, **f64)
        self.geometry = {c: norm_geometry(2 * ly * lx) for c in self.coords}
        if max(k for _, k in self.geometry.values()) > MAX_LEAVES:
            raise ValueError(f"block {self.shape}: the norm kernel's threads sum up to {MAX_LEAVES} rows each")
        self.ctas = sum(g for g, _ in self.geometry.values())
        self.spans, codes = self.row_lists()
        self._graph = None
        if self.kernel:
            self.rows = torch.tensor(codes.view(np.int32), device=dev)  # the kernel reads uint32
            self.words = self.table_words()  # the launchers read x, b, offsets and the norm's CTAs from it
            self.table = torch.tensor(self.words, device=dev)
            # the norm's scratch: each block's squares (padded to L, never
            # read past n) and the tree's partials; its arrival word (reset
            # on the card)
            ctas, leaves = self.geometry[self.coords[0]]
            self.work = torch.zeros(len(self.coords) * ctas * NORM_THREADS * leaves + self.ctas, **f64)
            self.arrivals = torch.zeros(1, dtype=torch.int32, device=dev)

    # -- tables ---------------------------------------------------------
    def row_lists(self) -> Tuple[List[Tuple[int, int, int]], np.ndarray]:
        """Each colour's rows over every block, packed ``part << 27 | field
        << 26 | j << 13 | i`` (uint32): per colour the interior rows of
        every block (:meth:`NgsBlock.interior`), then the edge rows; returns
        each colour's ``(start, edge, end)`` and the codes."""
        spans, lists = [], []
        at = 0
        for colour in range(self.ncolors):
            inner, edge = [], []
            for p, c in enumerate(self.coords):
                part = self.parts[c]
                f, j, i = np.nonzero(part.colors == colour)
                code = (np.uint32(p) << 27) | (f.astype(np.uint32) << 26) | (j.astype(np.uint32) << 13) | i.astype(np.uint32)
                straight = part.interior()[j, i]
                inner.append(code[straight])
                edge.append(code[~straight])
            inner, edge = np.concatenate(inner), np.concatenate(edge)
            spans.append((at, at + inner.size, at + inner.size + edge.size))
            at += inner.size + edge.size
            lists += [inner, edge]
        return spans, np.concatenate(lists).astype(np.uint32)

    def table_words(self) -> np.ndarray:
        """The kernel's table: ``NgsPart`` a block, int64 words."""
        _, ly, lx = self.shape
        words = np.zeros((len(self.coords), PART_WORDS), np.int64)
        cta0 = 0
        for p, c in enumerate(self.coords):
            w = words[p]
            w[0], w[1] = self.x[c].data_ptr(), self.b[c].data_ptr()
            for d, q in self.neighbours[c].items():
                sy, sx = d // 3 - 1, d % 3 - 1
                if self.remote:
                    src = [self.recv[c][d].data_ptr(), *side_strides(d, ly, lx)]
                    w[_SND + 4 * d:_SND + 4 * d + 4] = [self.send[c][d].data_ptr(), *side_strides(d, ly, lx)]
                else:  # the neighbour's x, at the ghost's local (j, i) shifted by a block
                    src = [self.x[q].data_ptr() - 8 * (sy * ly * lx + sx * lx), ly * lx, lx, 1]
                w[_SRC + 4 * d:_SRC + 4 * d + 4] = src
            ctas, leaves = self.geometry[c]
            w[_META:_META + 8] = [ly, lx, *self.parts[c].offsets, cta0, ctas, leaves, 0]
            cta0 += ctas
        return words

    # -- the pieces of an iteration -------------------------------------
    def load(self, b: Dict, x0: Dict) -> None:
        """Each block's b and starting iterate into the sweep's buffers, and
        the edges of x0 to the neighbours."""
        for c in self.coords:
            self.b[c].copy_(b[c])
            self.x[c].copy_(x0[c])
        if self.remote:
            self._fill_sends()
            self._exchange()

    def _fill_sends(self) -> None:
        for c in self.coords:
            for d, buf in self.send[c].items():
                buf.copy_(edge_of(self.x[c], d))

    def _exchange(self) -> None:
        """The edges a step wrote, into the neighbours' receive buffers:
        copied in memory (loopback), or one ``batch_isend_irecv`` with every
        peer, which blocks the host only on the CPU (gloo)."""
        if not self.remote:
            return
        if self.loopback:
            for c in self.coords:
                for d, q in self.neighbours[c].items():
                    self.recv[c][d].copy_(self.send[q][8 - d])
            return
        import torch.distributed as dist

        from perphil_tpu_torch.parallel import halo

        (c,) = self.coords
        dm = self.blocks.dmesh
        ops = []
        for d, q in self.neighbours[c].items():
            peer = int(np.ravel_multi_index(q, dm.shape))
            ops += [dist.P2POp(dist.isend, self.send[c][d], peer), dist.P2POp(dist.irecv, self.recv[c][d], peer)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        halo.COLLECTIVES["exchange"] += 1

    def _box(self, c) -> torch.Tensor:
        """Block ``c`` with the ghosts the kernel reads around it (the
        twin's input)."""
        x = self.x[c]
        _, ly, lx = x.shape
        box = x.new_zeros((2, ly + 2, lx + 2))
        box[:, 1:-1, 1:-1] = x
        spans = {-1: (slice(0, 1), slice(-1, None)), 0: (slice(1, -1), slice(None)), 1: (slice(-1, None), slice(0, 1))}
        for d, q in self.neighbours[c].items():
            sy, sx = d // 3 - 1, d % 3 - 1
            (by, qy), (bx, qx) = spans[sy], spans[sx]
            if self.remote:
                box[:, by, bx] = self.recv[c][d].reshape(box[:, by, bx].shape)
            else:
                box[:, by, bx] = self.x[q][:, qy, qx]
        return box

    def step(self, colour: int) -> None:
        """Colour ``colour``'s step on every block, in place (the kernel on
        the card, the twin on the CPU), then the exchange. No step once the
        state says done."""
        if self.kernel:
            start, edge, end = self.spans[colour]
            _cuda.launch(COLOUR_KERNEL, "perphil_ngs_colour_step", self.device, self.table.data_ptr(),
                         self.words.ctypes.data, len(self.coords), self.rows.data_ptr(), start, edge, end,
                         self.weights.ctypes.data, *self.n_phys, self.state.data_ptr())
        else:
            if self.state[DONE]:
                return
            boxes = {c: self._box(c) for c in self.coords}
            for c in self.coords:
                part = self.parts[c]
                self.x[c].copy_(colour_step_box(boxes[c], self.b[c], part.taps, part.diagonal, part.bdry,
                                                part.masks[colour]))
            if self.remote:
                self._fill_sends()
        self._exchange()

    def norm(self, init: bool = False, residuals: Optional[Dict] = None) -> None:
        """The norm of every block's residual and the stop test, into the
        state (``init``: the first norm, which sets f0 and tol).
        ``residuals`` (a tensor a block) receives the residual (checks)."""
        if not self.kernel:
            return self._norm_plain(init, residuals)
        _cuda.launch(NORM_KERNEL, "perphil_ngs_norm", self.device, *self.norm_args(init, residuals))
        if self.peers:
            import torch.distributed as dist

            from perphil_tpu_torch.parallel import halo

            dist.all_reduce(self.state[TOTAL:TOTAL + 1])
            halo.COLLECTIVES["all_reduce"] += 1
            _cuda.launch(NORM_KERNEL, "perphil_ngs_finish", self.device, self.state.data_ptr(), int(init))

    def norm_args(self, init: bool = False, residuals: Optional[Dict] = None, work: Optional[torch.Tensor] = None,
                  arrivals: Optional[torch.Tensor] = None) -> tuple:
        """The norm launcher's arguments but the stream (``perphil_ngs_norm``
        and the launchers of its signature: the measurement builds, the
        probe's): ``residuals`` (a tensor a block) patched into the table's
        copy, ``work`` / ``arrivals`` in place of the sweep's own."""
        words = self.words
        if residuals is not None:  # the residuals' outputs
            words = words.copy()
            for p, c in enumerate(self.coords):
                _cuda.require_cuda_tensor(residuals[c], "residual", torch.float64, self.device)
                words[p, _META + 7] = residuals[c].data_ptr()
        work = self.work if work is None else work
        arrivals = self.arrivals if arrivals is None else arrivals
        # words.ctypes (not its address) keeps a patched copy alive until the call
        return (self.table.data_ptr(), words.ctypes, len(self.coords), self.ctas, self.weights.ctypes.data,
                *self.n_phys, self.state.data_ptr(), work.data_ptr(), arrivals.data_ptr(), int(init),
                int(not self.peers))

    def _norm_plain(self, init: bool, residuals: Optional[Dict]) -> None:
        """The twin of the norm: each block's residual and its tree
        (:func:`krylov.tree_sum`), the blocks' total (``blocks.total``: in
        coordinate order, or all-reduced over the ranks), the stop test."""
        if self.state[DONE]:
            return
        sums = {}
        for c in self.coords:
            part = self.parts[c]
            r = colour_step_box(self._box(c), self.b[c], part.taps, part.diagonal, part.bdry, None)
            if residuals is not None:
                residuals[c].copy_(r)
            sums[c] = tree_sum((r * r).reshape(-1))
        if self.peers:
            total = self.blocks.total(sums)
        else:  # the kernel's order: the blocks' sums one after the other
            total = sums[self.coords[0]]
            for c in self.coords[1:]:
                total = total + sums[c]
        stop_plain(self.state, float(total), init)

    def iteration(self) -> None:
        """One Picard iteration: every colour's step, then the norm."""
        for colour in range(self.ncolors):
            self.step(colour)
        self.norm()

    def issue(self, k: int) -> None:
        """``k`` iterations, without reading anything back: from a CUDA
        graph captured once where the blocks need no peer, else launch by
        launch (with the exchanges)."""
        if not self.kernel or self.peers:
            for _ in range(k):
                self.iteration()
            return
        if self._graph is None or self._graph[0] != k:
            self._graph = (k, _cuda.CapturedLaunches(self.device, lambda: [self.iteration() for _ in range(k)]))
        self._graph[1].replay()

    def reset(self, rtol: float, atol: float, max_it: int) -> None:
        self.state.zero_()
        self.state[RTOL], self.state[ATOL], self.state[MAX_IT] = float(rtol), float(atol), float(max_it)


def stop_plain(state: torch.Tensor, total: float, init: bool) -> None:
    """The kernels' root and stop test (``finish`` in
    ``csrc/ngs_colour_halo.cu``) on the host: ``fn = sqrt(total)``
    correctly rounded; the first sets f0 and ``tol = rtol * f0 if that is >
    atol else atol``; then ``its`` counts, and ``done`` is set once ``fn >
    tol and its < max_it`` fails."""
    fn = math.sqrt(total)
    if init:
        rel = float(state[RTOL]) * fn
        tol = rel if rel > float(state[ATOL]) else float(state[ATOL])
        state[F0], state[TOL], its = fn, tol, 0.0
    else:
        tol, its = float(state[TOL]), float(state[ITS]) + 1.0
    state[FN], state[ITS] = fn, its
    state[DONE] = 0.0 if (fn > tol and its < float(state[MAX_IT])) else 1.0


def blocked_ngs(sweep: NgsSweep, b: Dict, x0: Dict, rtol: float, atol: float, max_it: int,
                every: int = ITERATIONS_PER_READ) -> NgsResult:
    """The pinned-colouring Picard solve on the blocks of ``sweep``
    (:class:`NgsSweep`) from ``x0`` (a tensor a block): the first norm,
    then ``every`` iterations issued between two read-backs of the state
    (done, its, fn) until it says done. The iterations issued past the stop
    change nothing, so the count, the norm and the iterate are those of
    :func:`picard_loop` with the blocks' norm (:func:`blocked_norm`)."""
    if every < 1:
        raise ValueError(f"every={every}: at least one iteration between read-backs")
    sweep.reset(rtol, atol, max_it)
    sweep.load(b, x0)
    sweep.norm(init=True)
    while True:
        done, its, f0, fn = sweep.state[[DONE, ITS, F0, FN]].tolist()
        if done:
            break
        sweep.issue(every)
    return NgsResult({c: v.clone() for c, v in sweep.x.items()}, int(its), fn, f0)


def blocked_ngs_loop(blocks, parts: Dict, b: Dict, x0: Dict, rtol: float, atol: float, max_it: int,
                     step: Optional[Callable] = None, residual: Optional[Callable] = None) -> NgsResult:
    """The first blocked Picard loop (as it stood before the iteration
    moved to the card), kept as the reference of :func:`blocked_ngs` on the
    CPU and, with the probe's launches (:func:`blocked_ngs_probe`), to be
    timed beside it: per iteration a plane exchange and the residual, then
    for every further colour an exchange and a step (``step(c, x, b,
    planes, colour)``, ``residual(c, x, b, planes)``; default the twins of
    ``parts``), the norm :func:`blocked_norm` read back every iteration."""
    ncolors = next(iter(parts.values())).ncolors
    step = step or (lambda c, x, bc, planes, k: parts[c].step(x, bc, planes, k))
    residual = residual or (lambda c, x, bc, planes: parts[c].residual(x, bc, planes))
    seen = {}

    def res(x):
        seen["planes"] = blocks.planes(x)
        return {c: residual(c, x[c], b[c], seen["planes"][c]) for c in x}

    def sweep(x, r):
        for k in range(ncolors):
            planes = seen["planes"] if k == 0 else blocks.planes(x)
            x = {c: step(c, x[c], b[c], planes[c], k) for c in x}
        return x

    return picard_loop(sweep, res, {c: v.contiguous() for c, v in x0.items()}, rtol, atol, max_it,
                       norm=blocked_norm(blocks))


def probe_library():
    """``csrc/profile/ngs_colour_halo_first.cu`` built alone: the first
    colour-step kernel (one launch a block a colour,
    ``perphil_ngs_colour_halo_first``), kept to time the first blocked loop
    in turns with :func:`blocked_ngs` (:func:`blocked_ngs_probe`). A
    measurement build: its launches are counted nowhere."""
    sig = [_cuda._P] * 7 + [_cuda._I, _cuda._P, _cuda._P] + [_cuda._I] * 6 + [_cuda._P]
    return _cuda.variant_library("profile/ngs_colour_halo_first.cu", "PERPHIL_NGS_PROBE",
                                 {"perphil_ngs_colour_halo_first": sig})


def norm_probe_library():
    """``csrc/profile/ngs_colour_norm_first.cu`` built alone: the first norm
    kernel (the rows in the tree's layout, a barrier a tree level, the last
    CTA's tail block by block; ``perphil_ngs_norm_first``, the
    launcher's signature), kept to hold the package's norm to it bit for bit
    and to time the two in turns (:class:`FirstNormSweep`). A measurement
    build: its launches are counted nowhere."""
    sig = _cuda._SIGNATURES["perphil_ngs_norm"]
    return _cuda.variant_library("profile/ngs_colour_norm_first.cu", "PERPHIL_NGS_NORM_PROBE",
                                 {"perphil_ngs_norm_first": sig})


def norm_variant_library(define: str):
    """``csrc/ngs_colour_halo.cu`` built alone with ``-D<define>``
    (``PERPHIL_NGS_NORM_*``: the measurement builds of the norm, a part
    skipped), its
    ``perphil_ngs_norm`` bound; launched with :meth:`NgsSweep.norm_args`.
    Counted nowhere."""
    return _cuda.variant_library(COLOUR_SOURCE, define, {"perphil_ngs_norm": _cuda._SIGNATURES["perphil_ngs_norm"]})


class FirstNormSweep(NgsSweep):
    """A :class:`NgsSweep` on the card whose norm is the first norm kernel
    (``dll``: :func:`norm_probe_library`) on its own partials and arrival
    word, in place of the package's: to hold the two norms' bits together
    and to time the whole blocked solve with each in turns. Its colour steps
    are the package's (counted); its norms are counted nowhere. No peers."""

    def __init__(self, dll, sweeper: ColoredNGSSweeper, grid: Sequence[int], blocks, remote: bool = False):
        super().__init__(sweeper, grid, blocks, remote)
        if not self.kernel or self.peers:
            raise ValueError("the first norm kernel runs on the card, on the blocks of one process")
        self._first = dll.perphil_ngs_norm_first
        self._first_partials = torch.zeros(self.ctas, dtype=torch.float64, device=self.device)
        self._first_arrivals = torch.zeros(1, dtype=torch.int32, device=self.device)

    def norm(self, init: bool = False, residuals: Optional[Dict] = None) -> None:
        args = self.norm_args(init, residuals, self._first_partials, self._first_arrivals)
        _cuda.check(self._first(*args, torch.cuda.current_stream(self.device).cuda_stream), "perphil_ngs_norm_first")


def blocked_ngs_probe(dll, blocks, parts: Dict, b: Dict, x0: Dict, rtol: float, atol: float,
                      max_it: int) -> NgsResult:
    """:func:`blocked_ngs_loop` on the card with the first kernel (``dll``:
    :func:`probe_library`): per colour a plane exchange and one launch a
    block that holds rows of the colour, the residual by its residual mode,
    the norm as torch ops and one read-back an iteration. ``x0`` is stepped
    in place."""

    def run(c, x, bc, planes, rows, r):
        part = parts[c]
        ptrs = [0, 0, 0, 0]
        for k, pair in enumerate(planes):
            for side, g in enumerate(pair):
                if g is not None:
                    ptrs[2 * k + side] = g.data_ptr()
        count = int(rows.numel()) if rows is not None else x.numel()
        _, ly, lx = part.shape
        err = dll.perphil_ngs_colour_halo_first(
            x.data_ptr(), bc.data_ptr(), *ptrs, 0 if rows is None else rows.data_ptr(), count,
            0 if r is None else r.data_ptr(), part.weights.ctypes.data, ly, lx, *part.offsets, *part.n_phys,
            torch.cuda.current_stream(x.device).cuda_stream)
        _cuda.check(err, "perphil_ngs_colour_halo_first")

    def step(c, x, bc, planes, k):
        rows = parts[c].rows[k]
        if rows.numel():
            run(c, x, bc, planes, rows, None)
        return x

    def residual(c, x, bc, planes):
        r = torch.empty_like(x)
        run(c, x, bc, planes, None, r)
        return r

    return blocked_ngs_loop(blocks, parts, b, x0, rtol, atol, max_it, step, residual)
