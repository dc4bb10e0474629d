"""Explicit halo exchange around K1: the sharded stencil apply.

Counterpart of ``perphil_tpu/parallel/halo.py``. Each rank holds one block
of the stacked fields ``(2, *grid)``; mesh axis k splits grid axis k. An
apply extends the block by one neighbour plane on each side of every split
axis, one axis after the other on the block already extended along the
previous axes, so that edge and corner neighbours arrive in d hops without
messages of their own (PETSc's VecScatter ghost update, the JAX package's
``ppermute`` exchange). Ranks at the edge of the grid receive zeros. K1's
halo form (``ops/fused_apply.py::fused_dpp_apply_halo``) then applies the
stencil to the extended block and writes the owned one, taking the boundary
from the global node index.

The packing and unpacking of planes (tensor code) is kept apart from their
transport: :class:`RankTransport` moves them between ranks
(``torch.distributed`` point-to-point, batched), :func:`loopback_apply`
moves them between the blocks of one grid inside one process, so that the
same pack, K1 and unpack can be checked on one card. The loopback is a
check, not a route: no solve takes it.

``COLLECTIVES`` counts what the sharded path issues: ``exchange`` (one a
split axis an apply: a rank's two planes out and two in), ``all_reduce``
and ``all_gather``.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_halo

#: Collectives issued by the sharded path since the last ``clear()``.
COLLECTIVES: Dict[str, int] = collections.Counter()


def pack_planes(block: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first and the last plane of ``block`` along tensor dim ``dim``,
    contiguous: what a rank sends to its lower and its upper neighbour."""
    n = block.shape[dim]
    return block.narrow(dim, 0, 1).contiguous(), block.narrow(dim, n - 1, 1).contiguous()


def unpack_planes(block: torch.Tensor, below: torch.Tensor, above: torch.Tensor, dim: int) -> torch.Tensor:
    """``block`` extended by the lower neighbour's last plane and the upper
    neighbour's first plane along ``dim``."""
    return torch.cat([below, block, above], dim=dim)


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


class RankTransport:
    """Planes between the ranks of a device mesh: along mesh axis ``k`` a
    rank sends its last plane up and its first plane down and receives the
    lower neighbour's last plane and the upper neighbour's first, in one
    batch of point-to-point operations. Edge ranks receive zeros."""

    def __init__(self, dmesh):
        self.dmesh = dmesh

    def exchange(self, k: int, lo: torch.Tensor, hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        prev, nxt = self.dmesh.neighbour(k, -1), self.dmesh.neighbour(k, +1)
        below, above = torch.zeros_like(hi), torch.zeros_like(lo)
        ops = []
        if prev is not None:
            ops += [dist.P2POp(dist.isend, lo, prev), dist.P2POp(dist.irecv, below, prev)]
        if nxt is not None:
            ops += [dist.P2POp(dist.isend, hi, nxt), dist.P2POp(dist.irecv, above, nxt)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        COLLECTIVES["exchange"] += 1
        return below, above


def extend(block: torch.Tensor, n_axes: int, exchange: Callable) -> torch.Tensor:
    """The stacked ``block`` extended along its first ``n_axes`` grid axes,
    one after the other, by ``exchange(k, lo, hi) -> (below, above)``."""
    for k in range(n_axes):
        lo, hi = pack_planes(block, 1 + k)
        below, above = exchange(k, lo, hi)
        block = unpack_planes(block, below, above, 1 + k)
    return block


def stacked_halo_apply(op, dmesh, mode: str = "matvec") -> Callable[[torch.Tensor], torch.Tensor]:
    """The BC-eliminated operator (``mode="matvec"``) or the lift
    (``mode="lift"``) of ``op`` (a ``DPPOperator``, padded or not) on this
    rank's stacked block: the exchange along every mesh axis, then K1's halo
    form on the extended block."""
    S, grid = op._combined_stencils, op.grid_shape
    if len(dmesh.shape) > len(grid):
        raise ValueError(f"{len(dmesh.shape)}-axis mesh cannot shard a {len(grid)}-D grid")
    for k, (name, s) in enumerate(zip(dmesh.axis_names, dmesh.shape)):
        if grid[k] % s:
            raise ValueError(f"Grid axis {k} (size {grid[k]}) not divisible by mesh axis {name!r} (size {s})")
    local = dmesh.local_shape(grid)
    ghosts, offsets, n_phys = block_geometry(dmesh.shape, dmesh.coords, local, op.mesh.node_shape)
    transport = RankTransport(dmesh)

    def apply(x_local: torch.Tensor) -> torch.Tensor:
        ze = extend(x_local, len(dmesh.shape), transport.exchange)
        return fused_dpp_apply_halo(ze, *S, mode=mode, ghosts=ghosts, offsets=offsets, n_phys=n_phys)

    return apply


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


def loopback_extend(blocks: Dict[Tuple[int, ...], torch.Tensor], mesh_shape: Sequence[int]):
    """Every block extended as :func:`extend` extends it across ranks, the
    planes moved between the blocks of one process (edges get zeros)."""
    for k in range(len(mesh_shape)):
        packs = {c: pack_planes(b, 1 + k) for c, b in blocks.items()}
        new = {}
        for c, b in blocks.items():
            prev = c[:k] + (c[k] - 1,) + c[k + 1:]
            nxt = c[:k] + (c[k] + 1,) + c[k + 1:]
            lo, hi = packs[c]
            below = packs[prev][1] if c[k] > 0 else torch.zeros_like(hi)
            above = packs[nxt][0] if c[k] < mesh_shape[k] - 1 else torch.zeros_like(lo)
            new[c] = unpack_planes(b, below, above, 1 + k)
        blocks = new
    return blocks


def loopback_apply(
    x: torch.Tensor, S, mesh_shape: Sequence[int], mode: str = "matvec", n_phys=None
) -> torch.Tensor:
    """K1's halo form over the blocks of one stacked grid ``x`` in one
    process: split on ``mesh_shape``, planes moved by :func:`loopback_extend`,
    one halo launch a block, the owned blocks joined. With the same values it
    equals the whole-grid apply bit for bit."""
    grid = tuple(x.shape[1:])
    n_phys = grid if n_phys is None else tuple(n_phys)
    blocks = loopback_extend(split_blocks(x, mesh_shape), mesh_shape)
    local = [n // s for n, s in zip(grid, mesh_shape)] + list(grid[len(mesh_shape):])
    out = {}
    for c, b in blocks.items():
        ghosts, offsets, nph = block_geometry(mesh_shape, c, local, n_phys)
        out[c] = fused_dpp_apply_halo(b, *S, mode=mode, ghosts=ghosts, offsets=offsets, n_phys=nph)
    return join_blocks(out, mesh_shape)


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

