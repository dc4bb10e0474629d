"""Re-blocking between mesh axes, and the blocks a process holds.

The sharded fast-diagonalisation solves (``ops/direct.py``) contract each
grid axis with a dense matrix while that axis is whole. A rank's block
leaves an axis whole only where no mesh axis splits it, so before an axis
is contracted the mesh axes that split it move to another grid axis: within
each group of ranks that differ only in their coordinate on mesh axis ``m``
(a row or a column of the :class:`~perphil_tpu_torch.parallel.sharding.DeviceMesh`),
every rank cuts its block into as many pieces along the destination axis
and sends piece ``p`` to the group's rank ``p`` (``all_to_all_single``); the
pieces it receives, joined along the source axis in rank order, hold that
axis whole (PETSc's and FFTW's pencil transposes; the JAX package leaves
them to XLA's partitioner, which reshards its ``tensordot`` transforms).
Where the destination axis does not divide, it is padded with zeros in the
transposed layout and cropped back by the inverse move.

:func:`transform_plan` orders the moves and contractions of a transform;
:func:`layout_index` says which global indices a block holds in any layout
of the plan (the mode data of the scaling are sliced by it).

A blocked solve runs on :class:`RankBlocks` (this rank's one block; the
plane exchange of ``parallel/halo.py``, the all-to-all transposes on the
mesh's row and column groups, all-reduces over the process group) or on
:class:`LoopbackBlocks` (every block of a grid in one process, the same
planes and pieces moved in memory: the check on one card, and the
one-block form the padded single-device builders run; :class:`JoinedBlocks`
shows them to a solve as the joined grid). Both count what
they issue in ``halo.COLLECTIVES`` (``exchange``: one a split axis an
exchange; ``all_to_all``: one a move), the loopback what each rank of its
mesh would.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_halo_planes
from perphil_tpu_torch.parallel import halo
from perphil_tpu_torch.parallel.distributed import is_initialized

Coords = Tuple[int, ...]
Blocks = Dict[Coords, torch.Tensor]


class Move(NamedTuple):
    """Mesh axis ``m`` moves from grid axis ``src`` (which becomes whole:
    ``src_full`` long, its length before ``m`` split it) to grid axis
    ``dst`` (``dst_full`` long before the move, then cut in ``size``
    pieces)."""

    m: int
    src: int
    dst: int
    src_full: int
    dst_full: int

    def inverse(self) -> "Move":
        return Move(self.m, self.dst, self.src, self.dst_full, self.src_full)


def transform_plan(grid: Sequence[int], mesh_shape: Sequence[int]):
    """The steps of a per-axis transform of a grid blocked on
    ``mesh_shape`` (mesh axis k splits grid axis k): ``("contract", a)`` or
    a :class:`Move`, the innermost grid axis contracted first; a split moves
    to an axis already contracted where there is one (the least split, the
    outermost among equals), else to the outermost other axis. Returns the
    steps and, per grid axis, the mesh axes that split it at the end with
    the axis's length before each split (:func:`layout_index`)."""
    d = len(grid)
    splits: List[List[Tuple[int, int]]] = [[(k, int(grid[k]))] if k < len(mesh_shape) else [] for k in range(d)]
    ext = [int(grid[k]) // int(mesh_shape[k]) if k < len(mesh_shape) else int(grid[k]) for k in range(d)]
    steps, done = [], []
    for a in reversed(range(d)):
        while splits[a]:
            m, full = splits[a].pop()
            cands = done or [b for b in range(d) if b != a]
            b = min(cands, key=lambda b: (len(splits[b]), b))
            steps.append(Move(m, a, b, full, ext[b]))
            splits[b].append((m, ext[b]))
            ext[b] = -(-ext[b] // int(mesh_shape[m]))
            ext[a] = full
        steps.append(("contract", a))
        done.append(a)
    return steps, splits


def layout_index(grid: Sequence[int], splits, coords: Sequence[int], mesh_shape: Sequence[int]) -> List[np.ndarray]:
    """Per grid axis, the global index of each entry a block at ``coords``
    holds in the layout ``splits`` (:func:`transform_plan`'s), -1 where the
    layout pads."""
    out = []
    for a, n in enumerate(grid):
        idx = np.arange(int(n))
        for m, full in splits[a]:
            if len(idx) != full:
                raise AssertionError(f"axis {a}: {len(idx)} entries where the plan has {full}")
            s = int(mesh_shape[m])
            piece = -(-len(idx) // s)
            idx = np.concatenate([idx, -np.ones(piece * s - len(idx), np.int64)])
            idx = idx[coords[m] * piece:(coords[m] + 1) * piece]
        out.append(idx)
    return out


def _pieces(x: torch.Tensor, dim: int, s: int) -> torch.Tensor:
    """``x`` cut along ``dim`` into ``s`` equal pieces (zero-padded where
    ``s`` does not divide it), stacked: ``(s, ...)``, contiguous."""
    n = x.shape[dim]
    piece = -(-n // s)
    if piece * s != n:
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, piece * s - n]
        x = F.pad(x, pad)
    return torch.stack(x.split(piece, dim)).contiguous()


def _joined(parts: Sequence[torch.Tensor], dim: int, full: int) -> torch.Tensor:
    """The pieces joined along ``dim`` in order, cropped to ``full``."""
    out = torch.cat(list(parts), dim)
    return out if out.shape[dim] == full else out.narrow(dim, 0, full).contiguous()


_GROUPS: Dict[tuple, tuple] = {}


def axis_group(dmesh, m: int):
    """This rank's group along mesh axis ``m`` (the ranks that differ from
    it only in coordinate ``m``, in coordinate order). Every group of every
    mesh axis is created at the first call, on every rank in the same
    order, as ``new_group`` requires."""
    world = dist.distributed_c10d._get_default_group()
    key = (dmesh.shape, id(world))
    if key not in _GROUPS:
        groups = {}
        for axis in range(len(dmesh.shape)):
            others = [s if k != axis else 1 for k, s in enumerate(dmesh.shape)]
            for rest in np.ndindex(*others):
                ranks = []
                for c in range(dmesh.shape[axis]):
                    coords = list(rest)
                    coords[axis] = c
                    ranks.append(int(np.ravel_multi_index(coords, dmesh.shape)))
                group = dist.new_group(ranks)
                if dmesh.rank in ranks:
                    groups[axis] = group
        _GROUPS[key] = (world, groups)  # the world kept alive: its id stays its own
    return _GROUPS[key][1][m]


def release_groups() -> None:
    """Drop the axis groups :func:`axis_group` keeps (before the world is
    destroyed: ``parallel/distributed.py::shutdown``)."""
    _GROUPS.clear()


def regrid(x: torch.Tensor, dmesh, move: Move, lead: int = 0) -> torch.Tensor:
    """This rank's block after ``move`` (grid axis k at dim ``lead + k``),
    by one ``all_to_all_single`` in the mesh axis's group. A mesh of one
    rank without a process group moves nothing across ranks."""
    s = dmesh.shape[move.m]
    send = _pieces(x, lead + move.dst, s)
    if is_initialized():
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=axis_group(dmesh, move.m))
    elif s == 1:
        recv = send
    else:
        raise RuntimeError(f"mesh axis {move.m} has {s} ranks and no process group is up")
    halo.COLLECTIVES["all_to_all"] += 1
    return _joined(recv.unbind(0), lead + move.src, move.src_full)


def loopback_regrid(blocks: Blocks, mesh_shape: Sequence[int], move: Move, lead: int = 0) -> Blocks:
    """:func:`regrid` on every block of a grid in one process: the same
    pieces, moved in memory."""
    s = int(mesh_shape[move.m])
    sent = {c: _pieces(b, lead + move.dst, s) for c, b in blocks.items()}
    out = {}
    for c in blocks:
        parts = [sent[c[:move.m] + (r,) + c[move.m + 1:]][c[move.m]] for r in range(s)]
        out[c] = _joined(parts, lead + move.src, move.src_full)
    halo.COLLECTIVES["all_to_all"] += 1
    return out


def block_slices(grid: Sequence[int], mesh_shape: Sequence[int], coords: Sequence[int]) -> Tuple[slice, ...]:
    """The slices of the block at ``coords`` in a grid blocked on
    ``mesh_shape`` (the outermost axes split)."""
    out = []
    for a, n in enumerate(grid):
        if a < len(mesh_shape):
            piece = int(n) // int(mesh_shape[a])
            out.append(slice(coords[a] * piece, (coords[a] + 1) * piece))
        else:
            out.append(slice(None))
    return tuple(out)


class _Blocks:
    """What a blocked solve needs of the blocks a process holds (``coords``)
    of grids blocked on ``mesh_shape``: their collectives, each block's
    share of a global array, and a memo for what is built once per set of
    blocks."""

    mesh_shape: Tuple[int, ...]
    coords: Tuple[Coords, ...]

    def __init__(self):
        self.memo: Dict[object, object] = {}

    def built(self, key, build: Callable[[], object]):
        """``build()`` once per key for these blocks."""
        if key not in self.memo:
            self.memo[key] = build()
        return self.memo[key]

    def cut(self, x, lead: int = 0) -> Blocks:
        """Each held block of the global array ``x`` (a tensor, or numpy
        made a tensor on ``device``), ``lead`` leading dims whole."""
        grid = tuple(x.shape[lead:])
        return {c: x[(slice(None),) * lead + block_slices(grid, self.mesh_shape, c)].contiguous() for c in self.coords}

    def own(self, x: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """The share of the global array ``x`` that the tensor functions of
        :meth:`one` take: the one held block."""
        return self.cut(x, lead)[self.coords[0]]

    def offsets(self, grid: Sequence[int], c: Coords) -> Tuple[int, ...]:
        return tuple(s.start or 0 for s in block_slices(grid, self.mesh_shape, c))

    def halo_apply(self, S, xs: Blocks, mode: str, grid: Sequence[int], n_phys: Sequence[int]) -> Blocks:
        """K1's halo form (the BC-eliminated operator or the lift) on every
        held stacked block of the ``grid``, after the plane exchange."""
        planes = self.planes(xs)
        return {c: fused_dpp_apply_halo_planes(x[0], x[1], planes[c], *S, mode=mode, offsets=self.offsets(grid, c),
                                               n_phys=n_phys) for c, x in xs.items()}

    def boxes(self, xs: Blocks, w: int) -> Blocks:
        """Each held stacked block extended by ``w`` ghost planes a side
        along every split axis, after the plane exchange: the neighbours'
        planes, zeros where there is no neighbour (``halo.halo_box``)."""
        planes = self.planes(xs, w)
        return {c: halo.halo_box(x, planes[c], w) for c, x in xs.items()}

    def total(self, values: Blocks) -> torch.Tensor:
        """The sum of the blocks' values (0-d tensors) over every block."""
        raise NotImplementedError

    def largest(self, values: Blocks) -> torch.Tensor:
        raise NotImplementedError

    def planes(self, xs: Blocks, w: int = 1) -> Dict[Coords, list]:
        """Each held stacked block's received planes, ``w`` deep
        (``halo.exchange_planes``)."""
        raise NotImplementedError

    def regrid(self, xs: Blocks, move: Move, lead: int = 0) -> Blocks:
        raise NotImplementedError

    def one(self, fn: Callable[[Blocks], Blocks]) -> Callable[[torch.Tensor], torch.Tensor]:
        """``fn`` on the one block held, as a tensor function."""
        if len(self.coords) != 1:
            raise ValueError(f"{len(self.coords)} blocks held: a tensor function needs one")
        c = self.coords[0]
        return lambda x: fn({c: x})[c]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global stacked grid of the one held block ``x``."""
        raise NotImplementedError

    def gathered(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
        """``fn``, a function of the global stacked grid, on the one block
        held: the block gathered, the result cut back (the parts that stay
        gathered)."""
        c = self.coords[0]
        return lambda x: self.cut(fn(self.gather(x)), lead=1)[c]

    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of a value of the one held block over every block (the
        Krylov loops' ``allreduce``)."""
        return self.total({self.coords[0]: t})


class RankBlocks(_Blocks):
    """This rank's block of a :class:`DeviceMesh`."""

    def __init__(self, dmesh):
        super().__init__()
        self.dmesh = dmesh
        self.mesh_shape = dmesh.shape
        self.coords = (dmesh.coords,)
        self.transport = halo.RankTransport(dmesh)

    def planes(self, xs: Blocks, w: int = 1) -> Dict[Coords, list]:
        return {c: halo.exchange_planes(x.contiguous(), len(self.mesh_shape), self.transport.exchange, w)
                for c, x in xs.items()}

    def regrid(self, xs: Blocks, move: Move, lead: int = 0) -> Blocks:
        return {c: regrid(x, self.dmesh, move, lead) for c, x in xs.items()}

    def total(self, values: Blocks) -> torch.Tensor:
        (v,) = values.values()
        return self.dmesh.allreduce(v)

    def largest(self, values: Blocks) -> torch.Tensor:
        (v,) = values.values()
        return self.dmesh.allreduce(v, op="max")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.dmesh.gather(x, stacked=True)


class LoopbackBlocks(_Blocks):
    """Every block of a grid blocked on ``mesh_shape``, in one process (a
    mesh of ones: the whole grid as one block)."""

    def __init__(self, mesh_shape: Sequence[int]):
        super().__init__()
        self.mesh_shape = tuple(int(s) for s in mesh_shape)
        self.coords = tuple(tuple(int(v) for v in c) for c in np.ndindex(*self.mesh_shape))

    def planes(self, xs: Blocks, w: int = 1) -> Dict[Coords, list]:
        halo.COLLECTIVES["exchange"] += len(self.mesh_shape)  # what a rank of the mesh would issue
        return halo.loopback_planes({c: x.contiguous() for c, x in xs.items()}, self.mesh_shape, w)

    def regrid(self, xs: Blocks, move: Move, lead: int = 0) -> Blocks:
        return loopback_regrid(xs, self.mesh_shape, move, lead)

    def total(self, values: Blocks) -> torch.Tensor:
        out = None
        for c in self.coords:
            out = values[c] if out is None else out + values[c]
        return out

    def largest(self, values: Blocks) -> torch.Tensor:
        return torch.stack([values[c] for c in self.coords]).max()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if len(self.coords) != 1:
            raise ValueError(f"{len(self.coords)} blocks held: a block is the global grid only on a mesh of ones")
        return x

    def join(self, xs: Blocks, lead: int = 1) -> torch.Tensor:
        """The global grid of the blocks (stacked, ``lead`` 1, or bare, 0)."""
        if lead == 1:
            return halo.join_blocks(xs, self.mesh_shape)
        return halo.join_blocks({c: x[None] for c, x in xs.items()}, self.mesh_shape)[0]


class JoinedBlocks(LoopbackBlocks):
    """Every block of a ``ndim``-dimensional grid blocked on ``mesh_shape``,
    in one process, seen by a solve's tensor functions as the joined global
    grid: :meth:`one` cuts its argument into the blocks, runs the blocks'
    function on every block and joins the result, and a Krylov loop runs on
    the global vector (its dots whole). ``solvers/solver.py::_run_parts``
    on it computes what a world of ``mesh_shape`` ranks computes, on one
    device."""

    def __init__(self, mesh_shape: Sequence[int], ndim: int):
        super().__init__(mesh_shape)
        self.ndim = int(ndim)

    def one(self, fn: Callable[[Blocks], Blocks]) -> Callable[[torch.Tensor], torch.Tensor]:
        def apply(x: torch.Tensor) -> torch.Tensor:
            lead = x.dim() - self.ndim
            return self.join(fn(self.cut(x, lead)), lead)

        return apply

    def own(self, x: torch.Tensor, lead: int = 0) -> torch.Tensor:
        return x

    def gathered(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> Callable[[torch.Tensor], torch.Tensor]:
        def apply(x: torch.Tensor) -> torch.Tensor:
            halo.COLLECTIVES["all_gather"] += 1  # what a rank of the mesh would issue
            return fn(x)

        return apply

    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        return t
