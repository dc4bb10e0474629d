"""Explicit halo exchange around K1: the sharded stencil apply.

Counterpart of ``perphil_tpu/parallel/halo.py``. Each rank holds one block
of the stacked fields ``(2, *grid)``; mesh axis k splits grid axis k. An
apply receives one neighbour plane (``w`` of them for the degree-p
operators, whose 1D factors couple nodes p apart) on each side of every
split axis, one axis after the other: the plane a rank sends along axis k
is its block's first or last plane along k with the rows the earlier axes'
received planes hold at its sides, so that edge and corner neighbours
arrive in d hops without messages of their own (PETSc's VecScatter ghost update, the JAX
package's ``ppermute`` exchange). Only plane-sized pieces are copied, never
the block. K1's halo form (``ops/fused_apply.py::fused_dpp_apply_halo_planes``)
then reads the owned block and the received planes where they lie and
writes the owned block, taking the boundary from the global node index; a
rank at the edge of the grid receives nothing there, and the kernel reads
zeros.

The building of planes (tensor code) is kept apart from their transport:
:class:`RankTransport` moves them between ranks (``torch.distributed``
point-to-point, batched), :func:`loopback_planes` between the blocks of one
grid inside one process, so that the same planes and K1 can be checked on
one card. The loopback is a check, not a route: no solve takes it.

``COLLECTIVES`` counts what the sharded path issues: ``exchange`` (one a
split axis an apply: a rank's two planes out and two in), ``all_to_all``
(one a transpose of ``parallel/transpose.py``), ``all_reduce`` and
``all_gather``.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


#: Collectives issued by the sharded path since the last ``clear()``.
COLLECTIVES: Dict[str, int] = collections.Counter()


def send_plane(block: torch.Tensor, planes: Sequence, k: int, side: int, w: int = 1) -> torch.Tensor:
    """What a rank sends along grid axis ``k`` to its lower (``side`` 0) or
    upper (1) neighbour, contiguous: the stacked ``block``'s first or last
    ``w`` planes along ``k``, with the matching rows of the planes received
    along the earlier axes (``planes``, ``(below, above)`` each, None:
    zeros) at its sides."""
    idx = 0 if side == 0 else block.shape[1 + k] - w
    plane = block.narrow(1 + k, idx, w)
    for j in range(k):
        rows = []
        for g in planes[j]:
            if g is None:
                shape = list(plane.shape)
                shape[1 + j] = w
                rows.append(plane.new_zeros(shape))
            else:
                rows.append(g.narrow(1 + k, idx, w))
        plane = torch.cat([rows[0], plane, rows[1]], dim=1 + j)
    return plane.contiguous()


def halo_box(block: torch.Tensor, planes: Sequence, w: int = 1) -> torch.Tensor:
    """The stacked ``block`` extended by its received ``planes``, ``w`` a
    side (zeros where none arrived), built whole: the box the whole-box twin
    (``fused_dpp_apply_halo_plain``) and the degree-p operators read; K1's
    halo form reads the planes where they lie."""
    for k, pair in enumerate(planes):
        shape = list(block.shape)
        shape[1 + k] = w
        below, above = (block.new_zeros(shape) if g is None else g for g in pair)
        block = torch.cat([below, block, above], dim=1 + k)
    return block


def halo_fits(grid: Sequence[int], mesh_shape: Sequence[int], w: int) -> bool:
    """Whether every block of the lattice ``grid`` (phantom padded to
    divisibility) blocked on ``mesh_shape`` holds the ``w`` planes a side
    that a degree-``w`` operator (Qp at p = w, P2 at w = 2) reads along each
    split axis, so that its neighbours can send them. Where it does not,
    the solver's degree-p parts run gathered (``solvers/solver.py::
    _linear_parts``), as the JAX package's partitioner does."""
    return all(int(grid[k]) // int(s) >= w for k, s in enumerate(mesh_shape))


def check_halo_width(grid: Sequence[int], mesh_shape: Sequence[int], w: int) -> None:
    """Raise ``ValueError`` where :func:`halo_fits` does not hold: a block
    of the lattice ``grid`` blocked on ``mesh_shape`` is thinner than the
    ``w`` planes a side its operator reads along a split axis. The blocked
    operators call it (``apply_blocks`` on such blocks raises); the solver
    takes the gathered form first. The message names the grid, the mesh and
    the smallest N (cells along that axis, a lattice of ``w N + 1`` nodes)
    that divides evenly into blocks of ``w`` planes, or, where no such N
    exists, the smallest whose padded blocks hold them."""
    for k, s in enumerate(mesh_shape):
        s = int(s)
        if int(grid[k]) // s >= w:
            continue
        thick = [n for n in range(1, 4 * s * w + 2) if -(-(w * n + 1) // s) >= w]
        even = [n for n in thick if (w * n + 1) % s == 0]
        hint = (f"the smallest N that divides evenly into blocks of {w} planes is N={even[0]}" if even else
                f"no N divides evenly; the smallest whose padded blocks hold {w} planes is N={thick[0]}")
        raise ValueError(
            f"grid {tuple(int(n) for n in grid)} on mesh {tuple(int(m) for m in mesh_shape)}: blocks of "
            f"{int(grid[k]) // s} planes along grid axis {k}, thinner than the {w}-plane halo of a degree-{w} "
            f"operator; {hint} cells along that axis"
        )


def block_geometry(
    mesh_shape: Sequence[int], coords: Sequence[int], local: Sequence[int], n_phys: Sequence[int]
):
    """K1's halo geometry of the extended block at ``coords``: one ghost a
    side on every split axis, the global offset of its first owned node, the
    physical extents."""
    d = len(local)
    k = len(mesh_shape)
    ghosts = tuple((1, 1) if ax < k else (0, 0) for ax in range(d))
    offsets = tuple(int(coords[ax]) * int(local[ax]) if ax < k else 0 for ax in range(d))
    return ghosts, offsets, tuple(int(n) for n in n_phys)


def eliminated_apply(blocks, xs, bdry, w: int, raw: Callable, mode: str = "matvec"):
    """The BC-eliminated operator (``mode="matvec"``: boundary rows
    identity, the interior rows of the operator on the boundary-masked
    input) or the lift (``"lift"``: boundary rows the data, interior rows
    the negated operator on the boundary data) on the stacked blocks ``xs``
    that ``blocks`` holds (``parallel/transpose.py``): the masked blocks
    exchanged ``w`` planes deep along every split axis, ``raw(c, box) -> y``
    the operator's two fields, stacked, on block ``c``'s box; ``bdry`` the
    boundary rows by block."""
    if mode == "matvec":
        masked = {c: torch.where(bdry[c], 0.0, x) for c, x in xs.items()}
    elif mode == "lift":
        masked = {c: torch.where(bdry[c], x, 0.0) for c, x in xs.items()}
    else:
        raise ValueError(f"mode must be matvec or lift, got {mode!r}")
    out = {}
    for c, box in blocks.boxes(masked, w).items():
        y = raw(c, box)
        out[c] = torch.where(bdry[c], xs[c], -y if mode == "lift" else y)
    return out


class RankTransport:
    """Planes between the ranks of a device mesh: along mesh axis ``k`` a
    rank sends its last plane up and its first plane down and receives the
    lower neighbour's last plane and the upper neighbour's first, in one
    batch of point-to-point operations. A plane is built and a buffer
    allocated only where the neighbour exists; an edge rank receives None
    there."""

    def __init__(self, dmesh):
        self.dmesh = dmesh

    def exchange(self, k: int, send: Callable[[int], torch.Tensor]):
        """``(below, above)`` along mesh axis ``k``; ``send(side)`` builds
        the plane for the lower (0) or upper (1) neighbour."""
        received, ops = [None, None], []
        for side, step in ((0, -1), (1, +1)):
            peer = self.dmesh.neighbour(k, step)
            if peer is None:
                continue
            out = send(side)
            received[side] = torch.empty_like(out)
            ops += [dist.P2POp(dist.isend, out, peer), dist.P2POp(dist.irecv, received[side], peer)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        COLLECTIVES["exchange"] += 1
        return tuple(received)


def exchange_planes(block: torch.Tensor, n_axes: int, exchange: Callable, w: int = 1) -> list:
    """The planes, ``w`` deep, the stacked ``block`` receives along its
    first ``n_axes`` grid axes, one axis after the other, by ``exchange(k,
    send) -> (below, above)``: ``(below, above)`` an axis."""
    planes = []
    for k in range(n_axes):
        planes.append(exchange(k, lambda side, k=k: send_plane(block, planes, k, side, w)))
    return planes


def stacked_halo_apply(op, dmesh, mode: str = "matvec") -> Callable[[torch.Tensor], torch.Tensor]:
    """The BC-eliminated operator (``mode="matvec"``) or the lift
    (``mode="lift"``) of ``op`` (a ``DPPOperator``, padded or not) on this
    rank's stacked block: the exchange along every mesh axis, then K1's halo
    form on the owned block and the received planes
    (``parallel/transpose.py::RankBlocks.halo_apply``)."""
    S, grid = op._combined_stencils, op.grid_shape
    if len(dmesh.shape) > len(grid):
        raise ValueError(f"{len(dmesh.shape)}-axis mesh cannot shard a {len(grid)}-D grid")
    for k, (name, s) in enumerate(zip(dmesh.axis_names, dmesh.shape)):
        if grid[k] % s:
            raise ValueError(f"Grid axis {k} (size {grid[k]}) not divisible by mesh axis {name!r} (size {s})")
    blocks = dmesh.blocks()
    return blocks.one(lambda xs: blocks.halo_apply(S, xs, mode, grid, op.mesh.node_shape))


def stacked_halo_matvec(op, dmesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The BC-eliminated monolithic matvec on this rank's block of the
    stacked fields, with the explicit halo exchange along every mesh axis
    (counterpart of ``shard_map_stacked_matvec``)."""
    return stacked_halo_apply(op, dmesh, "matvec")


def split_blocks(x: torch.Tensor, mesh_shape: Sequence[int]) -> Dict[Tuple[int, ...], torch.Tensor]:
    """The blocks of a stacked grid on a mesh of ``mesh_shape``, by coords."""
    local = [n // s for n, s in zip(x.shape[1:], mesh_shape)]
    out = {}
    for coords in np.ndindex(*mesh_shape):
        sl = tuple(slice(c * n, (c + 1) * n) for c, n in zip(coords, local))
        out[tuple(int(c) for c in coords)] = x[(slice(None),) + sl].contiguous()
    return out


def join_blocks(blocks: Dict[Tuple[int, ...], torch.Tensor], mesh_shape: Sequence[int]) -> torch.Tensor:
    """The stacked grid of its blocks (the inverse of :func:`split_blocks`)."""
    rows = blocks
    for k in range(len(mesh_shape) - 1, -1, -1):
        merged = {}
        for coords in {c[:k] for c in rows}:
            parts = [rows[coords + (i,)] for i in range(mesh_shape[k])]
            merged[coords] = torch.cat(parts, dim=1 + k)
        rows = merged
    return rows[()]


def loopback_planes(blocks: Dict[Tuple[int, ...], torch.Tensor], mesh_shape: Sequence[int], w: int = 1):
    """Every block's received planes, ``w`` deep, as :func:`exchange_planes`
    gives them across ranks, moved between the blocks of one process (None
    at the grid's edges)."""
    planes = {c: [] for c in blocks}
    for k in range(len(mesh_shape)):
        sends = {c: (send_plane(b, planes[c], k, 0, w), send_plane(b, planes[c], k, 1, w)) for c, b in blocks.items()}
        for c in blocks:
            prev = c[:k] + (c[k] - 1,) + c[k + 1:]
            nxt = c[:k] + (c[k] + 1,) + c[k + 1:]
            planes[c].append((sends[prev][1] if c[k] > 0 else None,
                              sends[nxt][0] if c[k] < mesh_shape[k] - 1 else None))
    return planes


def loopback_apply(
    x: torch.Tensor, S, mesh_shape: Sequence[int], mode: str = "matvec", n_phys=None
) -> torch.Tensor:
    """K1's halo form over the blocks of one stacked grid ``x`` in one
    process (``parallel/transpose.py::LoopbackBlocks.halo_apply``): split on
    ``mesh_shape``, planes moved by :func:`loopback_planes`, one halo launch
    a block, the owned blocks joined. With the same values it equals the
    whole-grid apply bit for bit."""
    from perphil_tpu_torch.parallel.transpose import LoopbackBlocks

    grid = tuple(x.shape[1:])
    blocks = LoopbackBlocks(mesh_shape)
    return blocks.join(blocks.halo_apply(S, blocks.cut(x, lead=1), mode, grid, grid if n_phys is None else n_phys))


def benchmark_vs_gathered(op, dmesh, reps: int = 50, seed: int = 0) -> Dict[str, object]:
    """Time the halo matvec against K1 on the all-gathered global vector on
    the same mesh (counterpart of ``benchmark_vs_gspmd``): seconds a call of
    each, and the largest absolute difference of their owned blocks over
    every rank."""
    grid = op.grid_shape
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((2,) + tuple(grid)), device=dmesh.device)
    xl = dmesh.block(x, stacked=True)
    halo = stacked_halo_matvec(op, dmesh)
    whole = op.stacked_matvec()

    def gathered(v: torch.Tensor) -> torch.Tensor:
        return dmesh.block(whole(dmesh.gather(v, stacked=True)), stacked=True)

    diff = torch.max(torch.abs(halo(xl) - gathered(xl))).reshape(1).to(torch.float64)
    diff = dmesh.allreduce(diff, op="max")

    def _time(fn) -> float:
        fn(xl)  # warm
        dmesh.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(xl)
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        dmesh.barrier()
        return (time.perf_counter() - t0) / reps

    return {
        "halo_s": _time(halo),
        "gathered_s": _time(gathered),
        "max_abs_diff": float(diff.item()),
        "mesh": dict(zip(dmesh.axis_names, dmesh.shape)),
    }

