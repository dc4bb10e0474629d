"""The lexicographic SNES ``ngs`` Picard solve on tri/hex/tet meshes in one
kernel launch (``csrc/fused_gs.cu``).

Counterpart of the JAX package's device-resident ngs loop
(``perphil_tpu/solvers/solver.py:1871-1911``, ``_ngs_from`` with
``GaussSeidelSweeper.sweep``): from the BC lift ``x0``,

    f0 = ||b - A x0||,  tol = max(rtol f0, atol)
    while fn > tol and its < max_it:
        x = one forward lexicographic Gauss-Seidel sweep from x
        fn = ||b - A x||

with the sweep of :meth:`ilu.GaussSeidelSweeper.plain` and the residual of
:meth:`FusedGSSolver.residual` (``b`` less every entry's product in the
system's stored offset order); every norm is the halving tree
(:func:`krylov.tree_sum`). :meth:`FusedGSSolver.plain` is the plain
PyTorch twin (the CPU route), :meth:`FusedGSSolver.launch` the kernel,
which keeps its bits. The kernel holds x and b in shared memory: on one
block where the grid fits, else in slabs of interior node rows (2D) or
planes (3D) over a thread block cluster of the most blocks (2-16) that
place it, a halo row or plane on either side, the halo pushed level by
level (``fused_ngs``'s protocol).
:func:`fused_gs_plan` mirrors its launcher, :func:`gs_tables` builds its
level lists, :func:`gs_taps` its entries; :func:`probe_library` builds the
kernel's measurement variant (empty levels, phase clocks). Beyond the plan
the solver runs :func:`gs_host_loop`: one ``structured_ilu_apply[gs]``
launch, one K1 residual and one norm read back an iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.ops.fused_gmres import MAX_BLOCKS
from perphil_tpu_torch.ops.fused_ngs import NgsResult, picard_loop, slab_rows, tree_geometry
from perphil_tpu_torch.ops.ilu import GaussSeidelSweeper, _geom_offsets, monolithic_stencils

KERNEL = "fused_gs"
#: dynamic shared memory a launch may plan with, in bytes (the launcher's
#: ``kGsSmemBudget``, read from its source)
SMEM_BUDGET = _cuda.header_constant("fused_gs.cu", "kGsSmemBudget")
RESULT_SLOTS = _cuda.header_constant("fused_gs.cu", "kGsResultSlots")
#: one block's staging of its threads' partial sums of the norm, in bytes
STAGE_BYTES = _cuda.header_constant("fused_gs.cu", "kGsStageBytes")
#: a row's entries at most (the launcher's tap table holds this many a field)
MAX_TAPS = _cuda.header_constant("fused_gs.cu", "kGsMaxTaps")
#: the meshes whose ngs is the lexicographic Gauss-Seidel (quad: ``fused_ngs``)
ELEMENTS = {"triangle": 2, "hex": 3, "tet": 3}
#: the level key's weights per coordinate (x, y, z) and its field shift
#: (``ilu.py::_build_system``)
_LAMBDA = (1, 2, 4)
_SHIFT = {2: 4, 3: 8}


class GsPlan(NamedTuple):
    """The launcher's placement: ``blocks`` of 512 threads in one cluster,
    at most ``rows`` interior node rows (2D) or planes (3D) a block, the
    norm's tree at ``leaves`` values a thread and ``nloc`` values a block,
    ``width`` entries of a block's list at most (both fields' interior nodes
    of ``rows``), the sweep's ``levels`` (those that hold interior rows), and
    the dynamic shared memory in bytes (x with its two halo rows or planes,
    b, on a cluster the tree's slice (one block: its staging,
    :data:`STAGE_BYTES`), the list, the level bounds and on a
    cluster the halo's counts, each rounded up to 16)."""

    blocks: int
    rows: int
    leaves: int
    nloc: int
    width: int
    levels: int
    bytes: int


def probe_library():
    """``csrc/fused_gs.cu`` built alone with ``PERPHIL_GS_PROFILE`` (the
    measurement build): ``perphil_fused_gs_probe(*launch_args, extra_levels,
    clocks, stream)`` runs a launch with ``extra_levels`` empty levels after
    each sweep's last and, where ``clocks`` is nonzero, sums thread 0 of
    block 0's cycles in each phase, which ``perphil_fused_gs_profile_take``
    copies out (four uint64) and zeroes. Not counted as ``fused_gs``."""
    sig = _cuda._SIGNATURES["perphil_fused_gs"]
    return _cuda.variant_library("fused_gs.cu", "PERPHIL_GS_PROFILE", {
        "perphil_fused_gs": sig,
        "perphil_fused_gs_probe": sig[:-1] + [_cuda._I, _cuda._I, _cuda._P],
        "perphil_fused_gs_profile_take": [_cuda._P],
    })


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def _planes(node_shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(planes, nodes a plane, interior nodes a plane): node rows in 2D,
    z-planes in 3D."""
    if len(node_shape) == 2:
        return node_shape[0], node_shape[1], node_shape[1] - 2
    nz, ny, nx = node_shape
    return nz, ny * nx, (ny - 2) * (nx - 2)


def _interior_keys(node_shape: Tuple[int, ...]) -> np.ndarray:
    """The level key of every interior node, one field (x fastest)."""
    inner = [np.arange(1, m - 1) for m in node_shape]  # slowest first
    grids = np.meshgrid(*inner, indexing="ij")
    return sum(lam * g for lam, g in zip(_LAMBDA, reversed(grids))).ravel()


def interior_levels(node_shape: Tuple[int, ...]) -> np.ndarray:
    """The sweep's levels that hold interior rows, ascending (the launcher's
    ``gs_levels``): the distinct ``key + field * shift``."""
    keys = _interior_keys(node_shape)
    return np.unique(np.concatenate([keys, keys + _SHIFT[len(node_shape)]]))


def _place(node_shape: Tuple[int, ...], blocks: int) -> Optional[GsPlan]:
    """``gs_place``: ``blocks`` blocks (a power of two, at most 16, the
    interior rows or planes, and ``Lt / 512``), the tree at most 32 leaves a
    thread, a slab's offsets within 16 bits, the slab within
    :data:`SMEM_BUDGET`."""
    if len(node_shape) not in (2, 3) or min(node_shape) < 3:
        return None
    outer, plane, inner = _planes(node_shape)
    if not 1 <= blocks <= MAX_BLOCKS or blocks & (blocks - 1) or blocks > outer - 2:
        return None
    tree = tree_geometry(2 * int(np.prod(node_shape)), blocks)
    if tree is None:
        return None
    (leaves, nloc), rows = tree, -(-(outer - 2) // blocks)
    if 2 * (rows + 2) * plane > 65536:
        return None
    width, levels = 2 * rows * inner, interior_levels(node_shape).size
    cluster = blocks > 1
    nbytes = (_align16(16 * (rows + 2) * plane) + _align16(16 * rows * plane)
              + (_align16(8 * nloc) if cluster else STAGE_BYTES) + _align16(2 * width) + _align16(4 * (levels + 1))
              + (_align16(8 * levels) if cluster else 0))
    return GsPlan(blocks, rows, leaves, nloc, width, levels, nbytes) if nbytes <= SMEM_BUDGET else None


def fused_gs_plan(node_shape: Tuple[int, ...], element: str, blocks: Optional[int] = None) -> Optional[GsPlan]:
    """The launcher's plan (``gs_geometry`` in ``csrc/fused_gs.cu``) for an
    ``element`` mesh of ``node_shape`` nodes on ``blocks`` blocks, or None
    where it refuses (a quad mesh's ngs is ``fused_ngs``). Left open,
    ``blocks`` is the launcher's rule: one block where the grid fits, else
    the most blocks that place it (measured fastest: a level on 16 blocks
    17% faster than on 4 at tet nx=24, within 2% at tri N=128)."""
    if ELEMENTS.get(element) != len(node_shape):
        return None
    if blocks is not None:
        return _place(tuple(node_shape), blocks)
    for nb in (1, MAX_BLOCKS, 8, 4, 2):
        plan = _place(tuple(node_shape), nb)
        if plan is not None:
            return plan
    return None


def gs_tables(node_shape: Tuple[int, ...], plan: GsPlan) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's tables: per block its interior rows sorted by level (and
    within a level by offset, so field 0's come first), ``(blocks, width)``
    uint16 padded with 0, an entry the row's offset in the block's slab of x
    (``f * (rows + 2) * plane + (local plane) * plane + place``, local plane
    0 the halo below); each block's level bounds in its list, ``(blocks,
    levels + 1)`` int32; and the values of each level it pushes to the
    block below and above (its first and last plane's), ``(blocks, levels,
    2)`` int32."""
    outer, plane, _ = _planes(node_shape)
    levels = interior_levels(node_shape)
    fs = (plan.rows + 2) * plane
    lists = np.zeros((plan.blocks, plan.width), np.uint16)
    cptr = np.zeros((plan.blocks, levels.size + 1), np.int32)
    sends = np.zeros((plan.blocks, levels.size, 2), np.int32)
    keys = _interior_keys(node_shape).reshape(outer - 2, -1)  # interior planes x their interior nodes
    inner = [np.arange(1, m - 1) for m in node_shape[1:]]
    place = sum(s * g for s, g in zip((node_shape[-1], 1), np.meshgrid(*inner, indexing="ij"))).ravel() \
        if len(node_shape) == 3 else inner[0]
    shift = _SHIFT[len(node_shape)]
    for b, (r0, rows) in enumerate(slab_rows(outer, plan.blocks)):
        local = np.arange(1, rows + 1)[:, None]  # local plane of each own plane
        code = np.concatenate([f * fs + (local * plane + place[None, :]).ravel() for f in (0, 1)])
        lev = np.searchsorted(levels, np.concatenate([keys[r0 - 1 : r0 - 1 + rows].ravel() + f * shift
                                                      for f in (0, 1)]))
        order = np.lexsort((code, lev))
        lists[b, : code.size] = code[order]
        cptr[b, 1:] = np.cumsum(np.bincount(lev, minlength=levels.size))
        first = np.tile(np.repeat(np.arange(rows) == 0, place.size), 2)
        last = np.tile(np.repeat(np.arange(rows) == rows - 1, place.size), 2)
        if b > 0:
            sends[b, :, 0] = np.bincount(lev[first], minlength=levels.size)
        if b < plan.blocks - 1:
            sends[b, :, 1] = np.bincount(lev[last], minlength=levels.size)
    return lists, cptr, sends


def gs_taps(mesh, params, plan: GsPlan) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's entries of an interior row (``GsTaps``): per row field f,
    each nonzero weight of the system's stored offsets (``_build_system``'s
    order: column block -1, 0, +1, then the 3^d geometric offsets, x
    fastest; the diagonal kept) with its offset in a block's slab of x;
    ``(2, MAX_TAPS)`` f64 weights, ``(2, MAX_TAPS)`` int32 offsets and
    ``[n0, n1, c0, c1]`` int32, the count and the diagonal's place a field."""
    shape = tuple(mesh.node_shape)
    _, plane, _ = _planes(shape)
    fs = (plan.rows + 2) * plane
    strides = (1, shape[-1], shape[-1] * shape[-2])  # x, y, z
    stencils = monolithic_stencils(mesh, params)
    w = np.zeros((2, MAX_TAPS))
    d = np.zeros((2, MAX_TAPS), np.int32)
    nc = np.zeros(4, np.int32)
    for f in (0, 1):
        k = 0
        for bd in (-1, 0, 1):
            st = stencils.get((f, f + bd))
            if st is None:
                continue
            for g in _geom_offsets(mesh.dim):
                v = float(st[tuple(int(o) + 1 for o in reversed(g))])
                centre = bd == 0 and not any(g)
                if v == 0.0 and not centre:
                    continue
                if centre:
                    nc[2 + f] = k
                w[f, k], d[f, k] = v, bd * fs + sum(o * s for o, s in zip(g, strides))
                k += 1
        nc[f] = k
    return w, d, nc


class FusedGSSolver(nn.Module):
    """The lexicographic SNES ``ngs`` Picard solve on a tri/hex/tet mesh,
    ``(b, x0) -> NgsResult`` on stacked ``(2, *node_shape)`` f64 tensors:
    ``b`` the lifted right-hand side, ``x0`` the BC lift. A CUDA tensor runs
    the kernel (one launch, counted as ``fused_gs``; a mesh beyond
    :func:`fused_gs_plan` raises), a CPU tensor the plain twin.

    :param sweeper: the mesh's :class:`GaussSeidelSweeper`, which the twin
        and the host route beyond the plan sweep with; left out, it is built
        at its first use (a launch within the plan needs none).
    :param blocks: the kernel's block count (left open: the launcher's
        rule; any count :func:`fused_gs_plan` places, for measurements).
    """

    def __init__(
        self,
        op: DPPOperator,
        sweeper: Optional[GaussSeidelSweeper] = None,
        rtol: float = 1e-8,
        atol: float = 1e-50,
        max_it: int = 50,
        blocks: Optional[int] = None,
    ):
        super().__init__()
        mesh = op.mesh
        if mesh.element not in ELEMENTS:
            raise ValueError(f"the fused GS solve is the lexicographic ngs of tri/hex/tet meshes, got {mesh.element!r}")
        self.device = op.W.device
        self.mesh, self.params = mesh, op.params
        if sweeper is not None and (sweeper.device != self.device or sweeper.nrows != 2 * mesh.num_vertices):
            raise ValueError("the sweeper belongs to another mesh or device")
        self._sweeper = sweeper
        self._entries = None  # the twin's residual entries, taken from the sweeper at first use
        self.rtol, self.atol, self.max_it = float(rtol), float(atol), int(max_it)
        self.node_shape = tuple(mesh.node_shape)
        self.blocks = blocks
        self.plan = fused_gs_plan(self.node_shape, mesh.element, blocks=blocks)
        #: what the last launch ran with: (blocks, rows, leaves a thread, dynamic bytes, levels)
        self.last_placement: Optional[Tuple[int, ...]] = None
        self.register_buffer("lists", None)
        self.register_buffer("cptr", None)
        self.register_buffer("sends", None)

    @property
    def sweeper(self) -> GaussSeidelSweeper:
        """The mesh's :class:`GaussSeidelSweeper` (the packed system and its
        level schedule on the solver's device), built at first use."""
        if self._sweeper is None:
            self._sweeper = GaussSeidelSweeper.for_monolithic(self.mesh, self.params, self.device)
        return self._sweeper

    def residual(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``b - A x`` on flat ``(nrows,)`` f64 tensors, the kernel's order:
        ``b`` less each entry's product in the system's stored offset order
        (the diagonal at its place; the offsets that hold no entry left
        out), each product and difference rounded apart; a column past
        either end reads 0."""
        if self._entries is None:
            vals, deltas = self.sweeper.vals, self.sweeper.deltas
            self._entries = [(vals[t], deltas[t]) for t in range(len(deltas)) if bool(vals[t].any())]
        p, n = max(abs(d) for _, d in self._entries), x.shape[0]
        xp = torch.nn.functional.pad(x, (p, p))
        r = b
        for v, d in self._entries:
            r = r - v * xp[p + d : p + d + n]
        return r

    def tolerances(self, tols: Optional[Tuple[float, float]] = None) -> Tuple[float, float]:
        """``(rtol, atol)`` of a call: ``tols`` where the caller gives them
        (the chunked continuation's ``(0, atol)``), else the solver's own."""
        return (self.rtol, self.atol) if tols is None else (float(tols[0]), float(tols[1]))

    def plain(self, b: torch.Tensor, x0: torch.Tensor, tols: Optional[Tuple[float, float]] = None) -> NgsResult:
        """Plain PyTorch twin (any device): the kernel's arithmetic, the
        stop test on the host."""
        sw, bf = self.sweeper, b.reshape(-1)
        res = picard_loop(lambda x, r: sw.plain(x, bf), lambda x: self.residual(x, bf), x0.reshape(-1),
                          *self.tolerances(tols), self.max_it)
        return NgsResult(res.x.reshape(b.shape), res.iterations, res.residual_norm, res.initial_norm)

    def sweep_warps(self) -> int:
        """The warps that take a level's rows: the widest level a block holds."""
        return int(min(16, max(1, -(-int(np.diff(self.cptr.cpu().numpy(), axis=1).max()) // 32))))

    def launch_args(
        self, b: torch.Tensor, x0: torch.Tensor, x: torch.Tensor, result: torch.Tensor,
        tols: Optional[Tuple[float, float]] = None,
    ) -> tuple:
        """The launcher's arguments (all but the stream) for stacked f64
        CUDA tensors ``b``, ``x0``, the output ``x`` and ``result``
        (:data:`RESULT_SLOTS` f64); ``tols``: the call's ``(rtol, atol)``
        (:meth:`tolerances`). They hold pointers only: the caller
        keeps every tensor alive until the launch has run."""
        if self.plan is None:
            raise ValueError(f"{self.mesh.element} mesh {self.node_shape} is beyond the fused GS plan")
        shape = (2,) + self.node_shape
        for name, t in (("b", b), ("x0", x0), ("x", x)):
            _cuda.require_cuda_tensor(t, name, torch.float64, self.device)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if self.lists is None:
            lists, cptr, sends = gs_tables(self.node_shape, self.plan)
            self.lists = torch.tensor(lists.view(np.int16), device=self.device)  # the kernel reads uint16
            self.cptr = torch.tensor(cptr, device=self.device)
            self.sends = torch.tensor(sends, device=self.device)
            self._taps = gs_taps(self.mesh, self.params, self.plan)
            self._sweep_warps = self.sweep_warps()
        w, d, nc = self._taps
        nz, ny, nx = (1,) * (3 - len(self.node_shape)) + self.node_shape
        p = self.plan
        return (
            b.data_ptr(), x0.data_ptr(), x.data_ptr(), self.lists.data_ptr(), self.cptr.data_ptr(),
            self.sends.data_ptr(), result.data_ptr(), w.ctypes.data, d.ctypes.data, nc.ctypes.data,
            len(self.node_shape), nz, ny, nx, *self.tolerances(tols), self.max_it,
            0 if self.blocks is None else p.blocks,  # 0: the launcher applies its own rule
            p.rows, p.nloc, p.width, p.levels, self._sweep_warps,
        )

    def launch(self, b: torch.Tensor, x0: torch.Tensor, tols: Optional[Tuple[float, float]] = None) -> NgsResult:
        """Run ``csrc/fused_gs.cu`` on stacked f64 CUDA tensors; reads the
        iteration count and the norms back."""
        x = torch.empty_like(b)
        result = torch.empty(RESULT_SLOTS, dtype=torch.float64, device=b.device)
        _cuda.launch(KERNEL, "perphil_fused_gs", b.device, *self.launch_args(b, x0, x, result, tols))
        out = result.tolist()
        self.last_placement = tuple(int(v) for v in out[3:8])
        return NgsResult(x, int(out[0]), out[1], out[2])

    def forward(self, b: torch.Tensor, x0: torch.Tensor, tols: Optional[Tuple[float, float]] = None) -> NgsResult:
        for t in (b, x0):
            if t.device != self.device:
                raise ValueError(f"tensor on {t.device}, solver built for {self.device}")
        if self.device.type == "cpu":
            return self.plain(b, x0, tols)
        if self.device.type != "cuda":
            raise ValueError(f"the GS solve runs on cpu or cuda, got {self.device}")
        return self.launch(b, x0, tols)


def gs_host_loop(
    op: DPPOperator, sweeper, b: torch.Tensor, x0: torch.Tensor, rtol: float, atol: float, max_it: int,
) -> NgsResult:
    """The same solve as a host loop (the route beyond the kernel's plan,
    and ``trisolve_backend=partri`` with a :class:`ilu.PartriGS`): a sweep
    (``sweeper.sweep``: on the card ``structured_ilu_apply[gs]`` or the
    partri scans), a K1 residual (``op.flat_matvec()``) and one norm read
    back an iteration, on stacked tensors. K1 sums in its own order, so the
    bits are not the kernel's."""
    mv, bf = op.flat_matvec(), b.reshape(-1)
    res = picard_loop(lambda x, r: sweeper.sweep(x, bf), lambda x: bf - mv(x), x0.reshape(-1), rtol, atol, max_it)
    return NgsResult(res.x.reshape(b.shape), res.iterations, res.residual_norm, res.initial_norm)
