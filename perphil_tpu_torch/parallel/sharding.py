"""Multi-device DPP solves over ``torch.distributed`` ranks.

Counterpart of ``perphil_tpu/parallel/sharding.py``. The reference scales by
MPI domain decomposition (DMPlex partitions, PETSc's distributed Mat/Vec:
halo exchange a SpMV, an allreduce a dot product). The JAX package places
its boundary data on a device mesh and lets XLA's partitioner derive the
same collectives from the single-device program. PyTorch has no
partitioner, so the distribution is written out here:

  - a :class:`DeviceMesh` arranges the process group's ranks on a grid; mesh
    axis k splits grid axis k (slabs on one axis, pencils on two), named
    after the grid axes, outermost first: ("z", "y") in 3D, ("y",) or
    ("y", "x") in 2D. The field-stacking axis and the inner axes stay whole;
  - node grids are phantom-padded to divisibility (:func:`mesh_padding`;
    identity rows with zero data, inert);
  - the matvec and the lift are K1's halo form on each rank's block after a
    plane exchange (``parallel/halo.py``; the degree-p operators' own on a
    box of p or 2 ghost planes a side);
  - the Krylov loop (``ops/krylov.py``: ``gmres``, ``cg``) runs on each
    rank's block: axpys local, every dot product and norm the block's tree
    sum and one all-reduce, so the Givens rotations and the stopping test
    see the same scalars on every rank;
  - the parts the JAX package lets its partitioner distribute keep their
    blocks (``solvers/solver.py``: ``LinearParts.blocked``,
    ``_nonlinear_parts``): the quad/hex direct solves (the mixed-precision
    fast-diag on blocks, its transforms through all-to-all transposes,
    ``parallel/transpose.py``), the tri/tet direct solves (``cg`` with the
    lumped fast-diag preconditioner on blocks), both at every size by
    design (the JAX package takes these routes only under padding; on a
    divisible lattice its partitioner gathers K2/K3),
    Jacobi, the fieldsplit with exact, Jacobi or Krylov blocks, and the
    Picard sweeps: ``ngs`` on quad meshes colour by colour
    (``csrc/ngs_colour_halo.cu``: a colour step a launch, the norm and the
    stop test on the card, the ghosts exchanged through fixed buffers;
    on a world of one rank, where the fused kernel's plan places the grid,
    the single-device ``fused_ngs`` solve, measured faster:
    ``solvers/solver.py::ngs_on_one_rank_whole``), ``block_gs`` and
    ``nrichardson`` on the blocked field solves and preconditioners;
  - the degree-p parts, which the JAX package's partitioner splits, keep
    their blocks too: the Qp operator (its 1D factors' bands on a box of p
    ghost planes a side), the Qp fast-diag direct solve and fieldsplit
    blocks (through the all-to-all transposes), the P2 stencils (the whole
    lattice's weight fields cut to the block, on a box of 2 planes a side:
    the whole lattice's bits), Jacobi;
  - gathered on every rank, the global vector cropped: ILU (monolithic, in
    a fieldsplit block, the ordering-parity route) and the lexicographic
    Gauss-Seidel / partri Picard sweeps on tri/hex/tet meshes, which the
    JAX package gathers too;
  - a world of one rank runs the single-device linear solve
    (``solvers/solver.py::linear_on_one_rank_whole``: K2-K8 or the mixed
    route, no collective), as the JAX package does on a one-device mesh;
    :func:`blocked_solve_dpp` keeps the blocked route callable there.

Only planes (the exchange) and transposes (``all_to_all``) cross ranks in a
blocked solve; its one ``all_gather`` returns the cropped solution. Where a
block is thinner than the planes its operator reads (p a side for Qp, 2 for
P2; ``halo.halo_fits``), the degree-p parts run gathered instead, as the JAX
package's partitioner runs them: the whole grid's operator, lift and
preconditioner or direct solve on the gathered vector, one ``all_gather`` an
application.

Ranks are NCCL ranks on the card and gloo ranks on the CPU
(``parallel/distributed.py``); a mesh whose device does not match the
process group's backend is refused.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from perphil_tpu_torch.config import DeviceLike, resolve_device
from perphil_tpu_torch.forms.spaces import Function, MixedFunctionSpace
from perphil_tpu_torch.parallel import halo
from perphil_tpu_torch.parallel.distributed import backend_for, is_initialized


class DeviceMesh:
    """The ranks of the process group on a grid of ``shape``, row-major
    (rank r at ``np.unravel_index(r, shape)``), with the device of this
    rank's tensors. A mesh of one rank needs no process group."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device: torch.device):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.device = device
        self.size = int(np.prod(self.shape))
        world = dist.get_world_size() if is_initialized() else 1
        if self.size != world:
            raise ValueError(f"Need {self.size} ranks, the process group has {world}")
        if is_initialized():
            backend, want = str(dist.get_backend()), backend_for(device)
            if backend != want:
                raise ValueError(f"the process group runs {backend}; a mesh on {device} needs {want}")
        self.rank = dist.get_rank() if is_initialized() else 0
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def __repr__(self) -> str:
        return f"DeviceMesh({dict(zip(self.axis_names, self.shape))}, rank {self.rank}, {self.device})"

    def neighbour(self, axis: int, step: int) -> Optional[int]:
        """The rank ``step`` places along mesh axis ``axis``, or None."""
        c = list(self.coords)
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return int(np.ravel_multi_index(c, self.shape))

    def local_shape(self, grid: Sequence[int]) -> Tuple[int, ...]:
        return tuple(n // self.shape[k] if k < len(self.shape) else n for k, n in enumerate(grid))

    def _slices(self, grid: Sequence[int], coords: Sequence[int]) -> Tuple[slice, ...]:
        local = self.local_shape(grid)
        return tuple(
            slice(coords[k] * n, (coords[k] + 1) * n) if k < len(self.shape) else slice(None)
            for k, n in enumerate(local)
        )

    def block(self, x: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """This rank's block of a global grid (``stacked``: ``(2, *grid)``)."""
        lead = (slice(None),) if stacked else ()
        grid = x.shape[1:] if stacked else x.shape
        return x[lead + self._slices(grid, self.coords)].contiguous()

    def gather(self, x_local: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """The global grid of every rank's block, on every rank."""
        if not is_initialized():
            return x_local
        parts = [torch.empty_like(x_local) for _ in range(self.size)]
        dist.all_gather(parts, x_local.contiguous())
        halo.COLLECTIVES["all_gather"] += 1
        blocks = {tuple(int(c) for c in np.unravel_index(r, self.shape)): p for r, p in enumerate(parts)}
        if not stacked:
            blocks = {c: b[None] for c, b in blocks.items()}
        out = halo.join_blocks(blocks, self.shape)
        return out if stacked else out[0]

    def allreduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum (or max) of ``t`` over the ranks, on every rank."""
        if not is_initialized():
            return t
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        halo.COLLECTIVES["all_reduce"] += 1
        return t

    def blocks(self):
        """This rank's block as ``parallel/transpose.py::RankBlocks`` (one
        a mesh: what blocked solves build on it is kept there)."""
        if getattr(self, "_blocks", None) is None:
            from perphil_tpu_torch.parallel.transpose import RankBlocks

            self._blocks = RankBlocks(self)
        return self._blocks

    def barrier(self) -> None:
        if is_initialized():
            dist.barrier(device_ids=[self.device.index] if self.device.type == "cuda" else None)


def device_mesh(
    axis_sizes: Sequence[int],
    axis_names: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
) -> DeviceMesh:
    """The process group's ranks as a mesh, e.g. ``device_mesh([4, 2])`` ->
    axes ("z", "y"); ``device`` (None: the card) is where this rank's
    tensors live and must match the group's backend (NCCL on the card,
    gloo on the CPU)."""
    dev = resolve_device(device)
    if axis_names is None:
        d = len(axis_sizes)
        axis_names = ("z", "y", "x")[:d] if d <= 3 else tuple(f"d{i}" for i in range(d))
    return DeviceMesh(axis_sizes, axis_names, dev)


def field_spec(dmesh: DeviceMesh, grid_ndim: int, stacked: bool = True) -> Tuple[Optional[str], ...]:
    """Which mesh axis splits each dim of a (stacked) field grid: the mesh
    axes take the outermost grid axes, the rest stay whole, e.g. a 3D grid
    on a ("z", "y") mesh -> (None, "z", "y", None) for ``(2, nz, ny, nx)``."""
    names = list(dmesh.axis_names)
    spec = names[:grid_ndim] + [None] * (grid_ndim - len(names))
    return tuple([None] + spec) if stacked else tuple(spec)


def _check_divisible(shape: Tuple[int, ...], dmesh: DeviceMesh, offset: int) -> None:
    sizes = dict(zip(dmesh.axis_names, dmesh.shape))
    for ax, name in enumerate(dmesh.axis_names):
        dim = offset + ax
        if dim < len(shape) and shape[dim] % sizes[name] != 0:
            raise ValueError(
                f"Grid axis {dim} (size {shape[dim]}) is not divisible by "
                f"device-mesh axis {name!r} (size {sizes[name]}). Choose N "
                f"with (N+1) divisible by the mesh axis (e.g. N=15, 31, 63) "
                f"or let the solve phantom-pad the grid."
            )


def shard_stacked(x: torch.Tensor, dmesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a stacked field array ``(2, *grid)``."""
    _check_divisible(tuple(x.shape), dmesh, 1)
    return dmesh.block(x.to(dmesh.device), stacked=True)


def shard_grid(x: torch.Tensor, dmesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a bare field grid."""
    _check_divisible(tuple(x.shape), dmesh, 0)
    return dmesh.block(x.to(dmesh.device))


def mesh_padding(node_shape: Tuple[int, ...], dmesh: DeviceMesh) -> Tuple[int, ...]:
    """Phantom padding per grid axis that makes each split axis divisible by
    its mesh axis (node grids are N+1 and rarely divisible)."""
    pad = []
    for ax, n in enumerate(node_shape):
        pad.append((-n) % dmesh.shape[ax] if ax < len(dmesh.shape) else 0)
    return tuple(pad)


def _pad_stacked(x: torch.Tensor, padding: Tuple[int, ...]) -> torch.Tensor:
    if not any(padding):
        return x
    pads = []
    for p in reversed(padding):
        pads += [0, p]
    return F.pad(x, pads)


def _crop_stacked(x: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    return x[(slice(None),) + tuple(slice(0, n) for n in shape)]


def _check_device(W: MixedFunctionSpace, dmesh: DeviceMesh) -> None:
    if W.device != dmesh.device:
        raise ValueError(f"the space lies on {W.device}, the mesh's ranks on {dmesh.device}")


def _linear_inputs(W: MixedFunctionSpace, bcs, dmesh: DeviceMesh, solver_parameters: Dict):
    """What both routes of a sharded linear solve start from: the checked
    space and mesh, the options with ``solve_dpp``'s prefix overrides (a
    ``set_options("dpp", ...)`` changes sharded and single-device runs
    alike), the boundary data; P2 preonly + lu is refused for every sharded
    call, divisible or not, as in the JAX package: the host splu stage has
    no distribution."""
    from perphil_tpu_torch.ops.assembly import bc_values_per_field
    from perphil_tpu_torch.solvers.options import apply_prefix_overrides
    from perphil_tpu_torch.solvers.solver import _validate_mixed

    _validate_mixed(W)
    _check_device(W, dmesh)
    solver_parameters = apply_prefix_overrides(solver_parameters, "dpp")
    if W.spaces[0].degree > 1 and not W.mesh.is_tensor_product:
        if str(solver_parameters.get("ksp_type", "preonly")) == "preonly":
            raise NotImplementedError(
                "P2 simplex preonly+lu is a host sparse-direct path "
                "(scipy splu) with no distribution; sharded P2 "
                "simplex solves support ksp_type=gmres with "
                "pc_type none/jacobi"
            )
    return solver_parameters, bc_values_per_field(W, bcs)


def sharded_solve_dpp(
    W: MixedFunctionSpace,
    model_params,
    bcs,
    dmesh: DeviceMesh,
    solver_parameters: Dict = {},
):
    """``solve_dpp`` over the ranks of ``dmesh``: on a world of one rank the
    single-device solve, with no collective
    (``solvers/solver.py::linear_on_one_rank_whole``), else
    :func:`blocked_solve_dpp`. Every rank returns the whole solution with
    the same iteration count and residual."""
    from perphil_tpu_torch.solvers.solver import Solution, _degree_solver, _freeze, linear_on_one_rank_whole

    if not linear_on_one_rank_whole(dmesh.size):
        return blocked_solve_dpp(W, model_params, bcs, dmesh, solver_parameters)
    solver_parameters, (g1, g2) = _linear_inputs(W, bcs, dmesh, solver_parameters)
    z1, z2, its, rnorm = _degree_solver(W, model_params, _freeze(solver_parameters))(g1, g2)
    return Solution(Function(W, (z1, z2)), int(its), float(rnorm))


def blocked_solve_dpp(
    W: MixedFunctionSpace,
    model_params,
    bcs,
    dmesh: DeviceMesh,
    solver_parameters: Dict = {},
):
    """The blocked route of :func:`sharded_solve_dpp`, on any world (a world
    of one too, where the route's rule does not take it: the check that it
    runs there): the grids are phantom-padded to divisibility, each rank
    solves on its block with the operator on blocks (K1's halo form; the Qp
    and P2 operators on boxes of p and 2 planes a side) and the distributed
    Krylov loop, the preconditioner or direct solve on its block (ILU on
    the gathered vector), and every rank returns the whole cropped
    solution, gathered once."""
    from perphil_tpu_torch.solvers.solver import Solution, _freeze, _linear_parts, _run_parts

    solver_parameters, (g1, g2) = _linear_inputs(W, bcs, dmesh, solver_parameters)
    dof_shape = W.spaces[0].dof_mesh.node_shape
    # a divisible lattice shares the unpadded builders' cache entries
    padding = mesh_padding(dof_shape, dmesh)
    if not any(padding):
        padding = ()
    parts = _linear_parts(W, model_params, _freeze(solver_parameters), padding)
    if parts.kind == "whole":
        # boundary data is replicated: the gathered vector is every rank's
        z1, z2, its, rnorm = parts.whole(g1, g2)
        return Solution(Function(W, (z1, z2)), int(its), float(rnorm))
    g = _pad_stacked(torch.stack([g1, g2]), padding or (0,) * len(dof_shape))
    z, its, rnorm = _run_parts(parts, dmesh.block(g, stacked=True), dmesh.blocks(),
                               dmesh.allreduce if is_initialized() else None)
    z = _crop_stacked(dmesh.gather(z, stacked=True), dof_shape)
    return Solution(Function(W, (z[0].contiguous(), z[1].contiguous())), int(its), float(rnorm))


def sharded_solve_dpp_nonlinear(
    W: MixedFunctionSpace,
    model_params,
    bcs,
    dmesh: DeviceMesh,
    solver_parameters: Dict = {},
):
    """``solve_dpp_nonlinear`` over the ranks of ``dmesh``. ``ksponly`` is
    one linear solve through :func:`sharded_solve_dpp` (which pads). The
    Picard sweeps run on each rank's block (``_nonlinear_parts``: ``ngs``
    on quad meshes colour by colour after a plane exchange, ``block_gs``
    and ``nrichardson`` on the blocked solves), their norms reduced over
    the ranks, and every rank returns the whole solution (a world of one
    runs the quad ``ngs`` whole, ``ngs_on_one_rank_whole``); the lexicographic
    ``ngs`` on tri/hex/tet meshes runs whole on the gathered boundary data
    on every rank (the fused sweep kernel on the card), as in the JAX
    package. The node grid must be divisible, as in the JAX package, whose
    phantom nodes would enter its pointwise sweeps."""
    from perphil_tpu_torch.ops.assembly import bc_values_per_field
    from perphil_tpu_torch.solvers.options import apply_prefix_overrides
    from perphil_tpu_torch.solvers.solver import (
        Solution,
        _build_nonlinear_solver,
        _freeze,
        _nonlinear_parts,
        _validate_mixed,
        ngs_on_one_rank_whole,
    )

    _validate_mixed(W)
    _check_device(W, dmesh)
    solver_parameters = apply_prefix_overrides(solver_parameters, "dpp_nonlinear")
    snes = str(solver_parameters.get("snes_type", "ngs"))
    if snes == "ksponly":
        ksp_opts = {k: v for k, v in solver_parameters.items() if not k.startswith("snes_")}
        sol = sharded_solve_dpp(W, model_params, bcs, dmesh, ksp_opts)
        return Solution(sol.solution, 1, sol.residual_error)
    if W.spaces[0].degree > 1:
        raise NotImplementedError(
            "sharded Picard/NGS drivers are degree-1 (matching "
            "solve_dpp_nonlinear); use snes_type='ksponly' for Qp systems"
        )
    dof_shape = W.spaces[0].dof_mesh.node_shape
    if any(mesh_padding(dof_shape, dmesh)):
        raise NotImplementedError(
            f"sharded nonlinear solves need device-divisible node grids "
            f"(got {dof_shape} on {dict(zip(dmesh.axis_names, dmesh.shape))}): "
            "phantom nodes would enter the pointwise-GS sweeps and change "
            "the Picard trajectory"
        )
    g1, g2 = bc_values_per_field(W, bcs)
    frozen = _freeze(solver_parameters)
    build = None if ngs_on_one_rank_whole(W, frozen, dmesh.size) else _nonlinear_parts(W, model_params, frozen)
    if build is None:
        solver = _build_nonlinear_solver(W, model_params, frozen)
        z1, z2, its, fnorm = solver(g1, g2)
        return Solution(Function(W, (z1, z2)), int(its), float(fnorm))
    blocks = dmesh.blocks()
    solve = blocks.built(("nonlinear", build), lambda: build(blocks))
    x, its, fnorm = solve(dmesh.block(torch.stack([g1, g2]), stacked=True))
    z = dmesh.gather(x, stacked=True)
    return Solution(Function(W, (z[0].contiguous(), z[1].contiguous())), int(its), float(fnorm))
