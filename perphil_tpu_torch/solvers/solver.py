"""DPP solves: direct, Krylov and Picard.

Counterpart of ``perphil_tpu/solvers/solver.py`` for ``ksp_type`` preonly,
gmres and cg with ``pc_type`` lu/cholesky, none, jacobi, ilu and fieldsplit,
and for the Picard solves of ``solve_dpp_nonlinear``.
The routing is the JAX package's accelerator route, the same on every
device; the device only decides whether a kernel wrapper launches CUDA or
runs its plain twin.

Direct (``preonly`` + lu; ``LINEAR_SOLVER_PARAMS``, ``TPU_DIRECT_PARAMS``):

  - quad/hex the K2 gate takes (its launcher's plan, up to the largest mesh
    measured faster: ``ops/fused_direct.py``)
                                         -> K2 ``fused_direct_solve``
  - quad/hex beyond it                   -> ``MixedPrecisionDPPDirect``
                                            (f32 fast-diag, residuals by K1's
                                            halo form, the grid one block)
  - tri/tet the K3 gate takes            -> K3 ``fused_simplicial_direct_solve``
  - tri/tet beyond it                    -> ``cg`` to 1e-13 with the lumped
                                            fast-diag preconditioner (K1 matvec)

A preonly solve reports 1 iteration and residual 0.0 (PETSc semantics).

The ordering-parity ILU (``pc_type: ilu`` with
``pc_factor_mat_ordering_type: rcm``, whatever ``ksp_type`` says, as the JAX
package routes it) is GMRES with ILU(0) in the reference's numbering and
pattern, factored on the host once a solver:

  - on the card, unless ``pc_band_execution: host``
                                       -> ``krylov.gmres`` (K1 matvec) with
                                          the level-scheduled ILU apply
                                          (``band_trisolve``); a band plan
                                          beyond the card's free memory
                                          raises ``MemoryError``
  - on the CPU, or ``pc_band_execution: host``
                                       -> the C++ CSR kernels' GMRES + ILU(0)

Krylov (``PLAIN_GMRES_PARAMS``, ``GMRES_JACOBI_PARAMS``, ``GMRES_ILU_PARAMS``,
the fieldsplit presets, ``ksp_type: cg``) solves the Newton-step system
``A d = b - A x0`` with x0 the BC lift, as Firedrake's KSP-only SNES does,
and returns ``x0 + d``:

  - gmres, pc none, at most 512 DoF, inside the fused GMRES envelope
                                         -> K5 ``fused_gmres_ef64``
  - gmres, pc none/jacobi, inside it     -> K4 ``fused_gmres_df``
  - gmres, multiplicative fieldsplit with preonly + lu blocks, inside it
                                         -> K6 (inner PCG, fast-diag PC)
  - gmres, ILU(0), inside it             -> K7 (monolithic ILU sweeps)
  - gmres, multiplicative fieldsplit with gmres + ILU blocks at the
    preset's block options, inside it    -> K8 (the blocks' own GMRES(30) +
                                            ILU, or with
                                            ``fieldsplit_inner_ksp: pcg`` the
                                            TPU kernel's ILU-PCG)
  - gmres otherwise                      -> ``krylov.gmres`` (K1 matvec,
                                            ``_monolithic_pc``)
  - cg                                   -> ``krylov.cg`` (K1 matvec)

The host preconditioners follow the JAX package's native-f64 route: f64
fast-diag exact blocks, literal inner Krylov solves, ``StructuredILU0``.
K8 follows it too unless ``fieldsplit_inner_ksp`` (:func:`_inner_ksp_option`)
asks for the TPU's PCG blocks.
The RHS lift is K1 in lift mode. Every other option path raises
``NotImplementedError`` naming the ROADMAP slice that ports it.

Every host ILU apply and lexicographic GS sweep built here runs on the
``trisolve_backend`` option (:func:`_trisolve_backend`): ``wavefront`` (the
level sweeps: ``structured_ilu_apply`` and its GS mode on the card),
``partri`` (the parallel-prefix trisolves, torch ops; on the card only when
its build fits the free memory) or left open: the wavefront on the card,
where partri was measured slower at every size, and on the CPU the JAX
package's default, partri where its maps fit its 6 GiB, else the wavefront.
The fused roles K7/K8 keep their own sweep. ``partri_group``
(:func:`_partri_group`) runs partri's 2D solves grouped.

Picard (``solve_dpp_nonlinear``; ``snes_type``, the JAX package's native-f64
solves), from the BC lift, stopping on ``||F|| <= max(snes_rtol ||F0||,
snes_atol)`` or ``snes_max_it``:

  - ngs on quad meshes, the pinned-colouring multicolour sweep inside the
    kernel's plan                        -> ``fused_ngs`` (one launch)
  - ngs on quad meshes beyond it         -> ``ngs_host_loop`` (K1 residuals)
  - ngs on tri/hex/tet meshes, the       -> ``fused_gs`` (one launch; the
    wavefront inside the kernel's plan      twin on the CPU)
  - ngs on tri/hex/tet meshes beyond it  -> ``gs_host_loop``: one
    on the card, or on partri               ``GaussSeidelSweeper`` sweep
                                            (``structured_ilu_apply[gs]``) or
                                            ``PartriGS`` sweep and one K1
                                            residual an iteration
  - block_gs                             -> exact alternating field solves
  - nrichardson                          -> damped Richardson with
                                            ``_monolithic_pc`` (the JAX
                                            package's documented deviation)
  - ksponly                              -> one linear solve, then the true
                                            residual norm; iteration 1

Degree p (``W``'s spaces of degree > 1; the JAX package's
``_build_tensor_linear_solver`` / ``_build_simplex_p2_linear_solver``):

  - Qp on quad/hex, preonly + lu         -> ``TensorFastDiagDPP`` (exact
                                            fast diagonalisation: dense
                                            products on the device, the
                                            grid as one block)
  - Qp, gmres with pc none, jacobi or    -> ``krylov.gmres`` with the
    the multiplicative fieldsplit with     ``TensorDPPOperator`` matvec
    exact fast-diag blocks                 (ILU is refused, as there)
  - P2 on tri/tet, gmres with pc none    -> ``krylov.gmres`` with the
    or jacobi                              ``P2SimplexDPPOperator`` matvec
  - P2, preonly + lu                     -> the host stage: scipy ``splu``
                                            of ``assemble_p2_monolithic``,
                                            the solution copied to ``W``'s
                                            device (the JAX package factors
                                            on the host too)

These GMRES solves run from the BC lift on ``A x = b`` (not the Newton-step
form), as the JAX package's degree-p solves do. The fused kernels are
Q1/P1 stencils and take none of these operators; ``solve_dpp_nonlinear``
takes degree p with ``snes_type: ksponly`` only.

Padding and blocks (the sharded path's phantom nodes and rank blocks,
``parallel/sharding.py``): the builders take a trailing ``padding``; a
padded solve, and every degree-p GMRES or fast-diag solve, is
:func:`_linear_parts` (what a rank needs: the operator and the lift on
blocks, ``LinearParts.operator``, and the direct solve or preconditioner
on blocks, ``LinearParts.blocked``, or, for ILU, on the gathered vector)
run on one device by :func:`_run_parts` with the whole grid as one block,
the same function the sharded entry runs on each rank's block. On blocks
a quad/hex direct solve is the mixed-precision fast-diag at every size
and a tri/tet one ``cg`` with the lumped preconditioner, by design: the
JAX package takes that route only under padding; on a divisible lattice
its unpadded builder takes K2/K3, which its partitioner gathers. The
degree-p parts run on blocks too (the Qp operator on its factors' bands,
the Qp fast-diag through the transposes, the P2 stencils on the whole
lattice's weight fields; :func:`_degree_pc`). A world of one rank runs
the single-device solve (:func:`linear_on_one_rank_whole`). The sharded
Picard solves are :func:`_nonlinear_parts`.

Solvers are cached on ``(W, params, frozen options)``; ``W`` carries the
device. No builder reads the environment.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy.sparse.linalg import splu

from perphil_tpu_torch.forms.spaces import Function, MixedFunctionSpace
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops import _native
from perphil_tpu_torch.ops.assembly import (
    DirichletBC,
    DPPOperator,
    FieldOperator,
    bc_values_per_field,
    coupling_apply,
)
from perphil_tpu_torch.ops.bandsolve import build_band_parity_ilu, level_schedule, plan_of
from perphil_tpu_torch.ops.direct import FastDiagFieldSolver, LumpedDPPPreconditioner, field_pair_blocks
from perphil_tpu_torch.ops.fused_direct import (
    fused_direct_solve,
    fused_direct_supported,
    fused_simplicial_direct_solve,
    fused_simplicial_direct_supported,
)
from perphil_tpu_torch.ops.fused_gmres import (
    EF64_MAX_DOF,
    INNER_KSP,
    INNER_TOLS,
    K5,
    MAX_RESTART,
    ROLES,
    FusedGMRESSolver,
    fused_gmres_supported,
)
from perphil_tpu_torch.ops.fused_gs import FusedGSSolver, gs_host_loop
from perphil_tpu_torch.ops.fused_ngs import (
    FusedNGSSolver,
    NgsSweep,
    blocked_ngs,
    blocked_norm,
    fused_ngs_plan,
    ngs_host_loop,
    picard_loop,
)
from perphil_tpu_torch.ops.ilu import (
    CPU_PARTRI_MAX_BYTES,
    GS_BACKENDS,
    ILU_BACKENDS,
    TRISOLVE_BACKENDS,
    ColoredNGSSweeper,
    GaussSeidelSweeper,
    PartriGS,
    partri_peak,
    partri_plan,
)
from perphil_tpu_torch.ops.krylov import _norm, cg, gmres
from perphil_tpu_torch.ops.mixed import MixedPrecisionDPPDirect
from perphil_tpu_torch.ops.ordering import parity_system
from perphil_tpu_torch.ops.simplexfem import P2SimplexDPPOperator, assemble_p2_monolithic
from perphil_tpu_torch.ops.tensorfem import TensorDPPOperator, TensorFastDiagDPP
from perphil_tpu_torch.parallel.halo import halo_fits
from perphil_tpu_torch.solvers.options import apply_prefix_overrides

_DIRECT_RTOL = 1e-13  # inner tolerance when "LU" is played by PCG
_DIRECT_MAX_IT = 2000


@dataclass(frozen=True)
class Solution:
    """Result of a solve: the solution, the iteration count and the residual."""

    solution: Union[Function, Tuple[Function, Function]]
    iteration_number: int
    residual_error: float


def _flatten_options(sp: Dict, prefix: str = "") -> Dict[str, object]:
    """Flatten nested option dicts (``{"fieldsplit_0": {...}}``) into
    PETSc-style prefixed keys (``fieldsplit_0_ksp_type``)."""
    out: Dict[str, object] = {}
    for k, v in (sp or {}).items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_options(v, prefix=f"{key}_"))
        else:
            out[key] = v
    return out


def _freeze(sp: Dict) -> Tuple:
    return tuple(sorted(_flatten_options(sp).items()))


def _sub_options(flat: Dict[str, object], prefix: str) -> Dict[str, object]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in flat.items() if k.startswith(prefix)}


def _validate_mixed(W) -> None:
    if not hasattr(W, "num_sub_spaces") or W.num_sub_spaces() != 2:
        raise ValueError(f"Expected a 2-field MixedFunctionSpace, got {type(W)}")


def _monolithic_direct(op: DPPOperator) -> Callable:
    """Direct solve of the monolithic system, ``(b1, b2) -> (z1, z2)``."""
    mesh = op.mesh
    if mesh.is_tensor_product:
        if fused_direct_supported(op):
            return fused_direct_solve(op)
        return MixedPrecisionDPPDirect(mesh, op.params, device=op.W.device).solve
    if fused_simplicial_direct_supported(op):
        return fused_simplicial_direct_solve(op, rtol=_DIRECT_RTOL, max_it=_DIRECT_MAX_IT)
    # simplicial beyond the K3 gate: machine-tolerance PCG (the monolithic
    # matrix is SPD) with the block-diagonal lumped fast-diag preconditioner
    pc = LumpedDPPPreconditioner(mesh, op.params, device=op.W.device)
    mv = op.stacked_matvec()

    def solve(b1: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x, _, _ = cg(
            mv, torch.stack([b1, b2]), rtol=_DIRECT_RTOL, atol=0.0,
            max_it=_DIRECT_MAX_IT, M_inv=pc,
        )
        return x[0], x[1]

    return solve


def _exact_field_solver(fop: FieldOperator) -> Callable:
    """Exact "LU-class" solve of one BC-eliminated block: the f64
    fast-diag solve on quad/hex meshes, PCG to 1e-13 with the lumped
    fast-diag preconditioner on tri/tet meshes."""
    mesh = fop.mesh
    if mesh.is_tensor_product:
        return FastDiagFieldSolver(mesh, fop.k, fop.beta, fop.mu, device=fop.V.device).solve
    pc = FastDiagFieldSolver(mesh, fop.k, fop.beta, fop.mu, lumped=True, device=fop.V.device)

    def solve(b: torch.Tensor) -> torch.Tensor:
        x, _, _ = cg(fop.matvec, b, rtol=_DIRECT_RTOL, atol=0.0, max_it=1000, M_inv=pc.solve)
        return x

    return solve


def _field_pc(fop: FieldOperator, pc_type: str, trisolve: str, group: int = 0) -> Optional[Callable]:
    """A fieldsplit block's preconditioner: none, jacobi, lu/cholesky or
    ilu (on the ``trisolve_backend`` option ``trisolve``,
    :func:`_trisolve_backend`; partri grouped by ``group``)."""
    if pc_type == "none":
        return None
    if pc_type == "jacobi":
        bdry = fop._mask_arrays[0]
        dc = float(fop.stencil[(1,) * fop.mesh.dim])
        dinv = torch.full(bdry.shape, 1.0 / dc, dtype=torch.float64, device=bdry.device)
        dinv.masked_fill_(bdry, 1.0)
        return lambda r: dinv * r
    if pc_type in ("lu", "cholesky"):
        return _exact_field_solver(fop)
    if pc_type == "ilu":
        backend = _trisolve_backend(trisolve, fop.mesh.node_shape, 1, fop.V.device, group)
        return ILU_BACKENDS[backend].for_field(fop, **_group_kw(backend, group)).apply_grid
    raise ValueError(f"Unsupported block pc_type: {pc_type!r}")


def _block_solver(fop: FieldOperator, sub: Dict[str, object], trisolve: str = "", group: int = 0) -> Callable:
    """Grid -> grid solver of one fieldsplit block from its sub-options
    (``ksp_type`` preonly, gmres or cg; the JAX package's f64 route);
    ``trisolve`` and ``group``: the solve's ``trisolve_backend`` and
    ``partri_group`` options."""
    ksp = str(sub.get("ksp_type", "preonly"))
    pc_type = str(sub.get("pc_type", "ilu"))
    if ksp == "preonly":
        if pc_type in ("lu", "cholesky"):
            return _exact_field_solver(fop)
        pc = _field_pc(fop, pc_type, trisolve, group)
        return pc if pc is not None else (lambda r: r)
    if ksp not in ("gmres", "cg"):
        raise ValueError(f"Unsupported block ksp_type: {ksp!r}")
    kw = dict(
        rtol=float(sub.get("ksp_rtol", 1e-5)),
        atol=float(sub.get("ksp_atol", 1e-50)),
        max_it=int(sub.get("ksp_max_it", 10000)),
    )
    pc = _field_pc(fop, pc_type, trisolve, group)
    if ksp == "cg":
        return lambda b: cg(fop.matvec, b, M_inv=pc, **kw)[0]
    restart = int(sub.get("ksp_gmres_restart", 30))
    return lambda b: gmres(fop.matvec, b, restart=restart, M_inv=pc, **kw).x


def _field_blocks(W: MixedFunctionSpace, p: DPPParameters, flat: Dict[str, object]) -> Tuple[Callable, Callable]:
    """The two fieldsplit block solvers from the ``fieldsplit_{0,1}_``
    sub-options, their ILUs on the solve's ``trisolve_backend``."""
    trisolve, group = _trisolve_option(flat), _partri_group(flat)
    return tuple(
        _block_solver(
            FieldOperator(W.sub(i), k, p.beta, p.mu), _sub_options(flat, f"fieldsplit_{i}_"), trisolve, group
        )
        for i, k in ((0, p.k1), (1, p.k2))
    )


def _fieldsplit_pc(op: DPPOperator, flat: Dict[str, object]) -> Callable:
    """The 2x2 fieldsplit: multiplicative (block Gauss-Seidel,
    ``y2 = B1(r2 - C y1)``) or additive (block Jacobi)."""
    fs_type = str(flat.get("pc_fieldsplit_type", "multiplicative"))
    if fs_type not in ("multiplicative", "additive"):
        raise ValueError(f"Unsupported pc_fieldsplit_type: {fs_type!r}")
    p = op.params
    B0, B1 = _field_blocks(op.W, p, flat)
    if fs_type == "additive":
        return lambda r: torch.stack([B0(r[0]), B1(r[1])])
    C = coupling_apply(op.mesh, p, op.W.device)

    def apply_fs(r: torch.Tensor) -> torch.Tensor:
        y1 = B0(r[0])
        return torch.stack([y1, B1(r[1] - C(y1))])

    return apply_fs


def _monolithic_pc(op: DPPOperator, flat: Dict[str, object]) -> Optional[Callable]:
    """Left preconditioner on stacked fields ``(2, *node_shape)`` from
    PETSc-style options: None for pc none, else ``r -> P r``."""
    pc_type = str(flat.get("pc_type", "none"))
    if pc_type == "none":
        return None
    if pc_type == "jacobi":
        dinv = (1.0 / op.diagonal()).reshape((2,) + op.grid_shape)
        return lambda r: dinv * r
    if pc_type in ("lu", "cholesky"):
        direct = _monolithic_direct(op)
        return lambda r: torch.stack(direct(r[0], r[1]))
    if pc_type == "ilu":
        if int(flat.get("pc_factor_levels", 0) or 0) != 0:
            raise NotImplementedError(
                "Only ILU(0) is implemented (the only level any reference workload uses)"
            )
        group = _partri_group(flat)
        backend = _trisolve_backend(_trisolve_option(flat), op.mesh.node_shape, 2, op.W.device, group)
        cls = ILU_BACKENDS[backend]
        return cls.for_monolithic(op.mesh, op.params, op.W.device, **_group_kw(backend, group)).apply_grid
    if pc_type == "fieldsplit":
        return _fieldsplit_pc(op, flat)
    raise ValueError(f"Unsupported pc_type: {pc_type!r}")


def _inner_ksp_option(flat: Dict[str, object]) -> str:
    """The ``fieldsplit_inner_ksp`` option, the counterpart of the JAX
    package's ``PERPHIL_TPU_INNER_KSP``: what K8's block solves run.

      - ``literal`` (the default): each block's own ``ksp_type``, GMRES(30)
        with the field's ILU(0) for ``FIELDSPLIT_GMRES_ILU_PARAMS``, the JAX
        package's native-f64 route (``_block_solver``);
      - ``pcg``: the TPU kernel's substitution, ILU-PCG at the blocks'
        tolerances (``pallas_gmres.py:1416-1474``).

    Beyond K8's envelope the host route runs the blocks' own solves either
    way, as the JAX package's native route does. K6's exact blocks are PCG
    to 1e-13 in both. Part of the solver caches' key (the options)."""
    option = str(flat.get("fieldsplit_inner_ksp", "literal"))
    if option not in INNER_KSP:
        raise ValueError(f"Unsupported fieldsplit_inner_ksp: {option!r} ({' or '.join(INNER_KSP)})")
    return option


def _fused_pc(flat: Dict[str, object]) -> Optional[str]:
    """The fused GMRES kernel's preconditioner for these options, by the
    JAX package's accelerator predicates (``_build_linear_solver_df``), or
    None where the kernel has no such role. K8 takes blocks whose own
    options are its inner solve's (:data:`INNER_TOLS`, the host route's
    defaults where an option is left out): rtol and atol, and in the
    literal mode (:func:`_inner_ksp_option`) max_it and the restart too."""
    literal = _inner_ksp_option(flat) == "literal"
    pc_type = str(flat.get("pc_type", "none"))
    if pc_type in ("none", "jacobi"):
        return pc_type
    if pc_type == "ilu":
        return None if flat.get("pc_factor_levels") else "ilu"
    if pc_type != "fieldsplit" or str(flat.get("pc_fieldsplit_type", "multiplicative")) != "multiplicative":
        return None

    def block(i: int, default_pc: str) -> Tuple[str, str]:
        return (
            str(flat.get(f"fieldsplit_{i}_ksp_type", "preonly")),
            str(flat.get(f"fieldsplit_{i}_pc_type", default_pc)),
        )

    rtol, atol, max_it, restart = INNER_TOLS["fieldsplit_ilu"]
    kernel = [("ksp_rtol", rtol, 1e-5), ("ksp_atol", atol, 1e-50)]
    if literal:
        kernel += [("ksp_max_it", max_it, 10000), ("ksp_gmres_restart", restart, 30)]
    if all(block(i, "ilu") == ("gmres", "ilu") for i in (0, 1)) and all(
        float(flat.get(f"fieldsplit_{i}_{k}", default)) == want for i in (0, 1) for k, want, default in kernel
    ):
        return "fieldsplit_ilu"  # the blocks' options are the kernel's own
    if all(block(i, "lu") in (("preonly", "lu"), ("preonly", "cholesky")) for i in (0, 1)):
        return "fieldsplit_lu"
    return None


def _krylov_kind(op: DPPOperator, flat: Dict[str, object]) -> str:
    """Which solver serves a Krylov solve, as the JAX package's accelerator
    route picks it: a fused GMRES role (K4-K8), or ``"gmres"`` / ``"cg"``
    (host loops with the K1 matvec and ``_monolithic_pc``). The chunked
    continuation (``_x0_continuation``) never takes K5: the JAX package
    keeps its f64-faithful mode for whole solves, and the continuation's
    small systems run K4."""
    ksp = str(flat.get("ksp_type", "gmres"))
    pc = _fused_pc(flat)
    restart = int(flat.get("ksp_gmres_restart", 30))
    if ksp == "gmres" and restart <= MAX_RESTART and pc is not None and fused_gmres_supported(op, pc, restart):
        if pc == "none" and op.W.dim() <= EF64_MAX_DOF and not flat.get("_x0_continuation"):
            return K5
        return ROLES[pc]
    return ksp


def _krylov_route(op: DPPOperator, flat: Dict[str, object]) -> Callable:
    """The Krylov solve of ``A d = r`` from ``d = 0``,
    ``(r, rtol, atol) -> (d, iterations, residual_norm)``; ``rtol`` and
    ``atol`` default to the options'."""
    kind = _krylov_kind(op, flat)
    rtol = float(flat.get("ksp_rtol", 1e-5))
    atol = float(flat.get("ksp_atol", 1e-50))
    max_it = int(flat.get("ksp_max_it", 10000))
    restart = int(flat.get("ksp_gmres_restart", 30))
    if kind not in ("gmres", "cg"):
        fused = FusedGMRESSolver(
            op, _fused_pc(flat), kind, rtol=rtol, atol=atol, max_it=max_it, restart=restart,
            inner_ksp=_inner_ksp_option(flat),
        )

        def solve_fused(r: torch.Tensor, rtol_: float = rtol, atol_: float = atol):
            res = fused(r, tols=(rtol_, atol_))
            return res.x, res.iterations, res.residual_norm

        return solve_fused
    mv = op.stacked_matvec()
    pc = _monolithic_pc(op, flat)

    def solve_host(r: torch.Tensor, rtol_: float = rtol, atol_: float = atol):
        if kind == "cg":
            return cg(mv, r, rtol=rtol_, atol=atol_, max_it=max_it, M_inv=pc)
        res = gmres(mv, r, rtol=rtol_, atol=atol_, max_it=max_it, restart=restart, M_inv=pc)
        return res.x, res.iterations, res.residual_norm

    return solve_host


def _newton_step_solver(op: DPPOperator, krylov: Callable) -> Callable:
    """``(g1, g2) -> (z1, z2, its, rnorm)`` by ``krylov`` (``r -> (d, its,
    rnorm)``) on the Newton-step system ``A d = b - A x0`` with x0 the BC
    lift: the convergence test is relative to the interior-scale ``||r0||``."""
    bdry = op._mask_arrays[0]

    def solve_krylov(g1: torch.Tensor, g2: torch.Tensor):
        b1, b2 = op.lifted_rhs(g1, g2)
        x01 = torch.where(bdry, g1, 0.0)
        x02 = torch.where(bdry, g2, 0.0)
        r1, r2 = op.residual(x01, x02, b1, b2)
        d, its, rnorm = krylov(torch.stack([r1, r2]))
        return x01 + d[0], x02 + d[1], its, rnorm

    return solve_krylov


def _continuation_solver(op: DPPOperator, krylov: Callable) -> Callable:
    """PETSc's KSPSetInitialGuessNonzero analogue (the ``_x0_continuation``
    option, set by the chunked drivers of ``experiments/profiling.py``):
    ``(g1, g2, x01, x02, atol_abs) -> (z1, z2, its, rnorm)`` from the given
    iterate, with ``rtol = 0`` and ``atol = atol_abs``, on the Newton-step
    system of that iterate (``A d = b - A x``), as the JAX package's host
    route solves it (``perphil_tpu/solvers/solver.py:1049-1078``). The
    other linear routes build their two-argument solve whatever this option
    says, as the JAX package's do, so a five-argument call raises there; so
    do the entry points, which call with two."""

    def solve_from(g1: torch.Tensor, g2: torch.Tensor, x01: torch.Tensor, x02: torch.Tensor, atol_abs: float):
        b1, b2 = op.lifted_rhs(g1, g2)
        r1, r2 = op.residual(x01, x02, b1, b2)
        d, its, rnorm = krylov(torch.stack([r1, r2]), 0.0, float(atol_abs))
        return x01 + d[0], x02 + d[1], its, rnorm

    return solve_from


def _free_device_bytes(device: torch.device) -> Optional[int]:
    """The card's free memory in bytes, or None where no card memory is
    used (the CPU)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


def _trisolve_option(flat: Dict[str, object]) -> str:
    """The ``trisolve_backend`` option: ``partri``, ``wavefront`` or ""
    (left open)."""
    option = str(flat.get("trisolve_backend", ""))
    if option not in ("", *TRISOLVE_BACKENDS):
        raise ValueError(f"Unsupported trisolve_backend: {option!r} (partri or wavefront)")
    return option


def _checked_options(frozen_sp: Tuple) -> Dict[str, object]:
    """The options of a builder's frozen key, with the two that any route
    may read later checked now: ``fieldsplit_inner_ksp`` and
    ``partri_group``."""
    flat = dict(frozen_sp)
    _inner_ksp_option(flat)
    _partri_group(flat)
    return flat


def _partri_group(flat: Dict[str, object]) -> int:
    """The ``partri_group`` option, the counterpart of the JAX package's
    ``PERPHIL_TPU_PARTRI_GROUP``: an int >= 0, the rows of a group of
    partri's grouped 2D pass (``ops/partri.py::GridTriSolve2D``), 0 (the
    default) the tree. It changes only partri's 2D solves with ``ny >= 2
    group``; the 3D plane solves stay on the tree."""
    option = flat.get("partri_group", 0)
    if isinstance(option, bool) or not isinstance(option, (int, np.integer)) or option < 0:
        raise ValueError(f"Unsupported partri_group: {option!r} (an int >= 0)")
    return int(option)


def _group_kw(backend: str, group: int) -> Dict[str, int]:
    """The constructor's ``group`` where the backend is partri."""
    return {"group": group} if backend == "partri" else {}


def _trisolve_backend(
    option: str, node_shape: Tuple[int, ...], nfields: int, device: torch.device, group: int = 0
) -> str:
    """The trisolve of an ILU apply or a lexicographic GS sweep on
    ``nfields`` fields: ``option`` when given; left open, the wavefront on
    the card (partri's apply, issued op by op, was measured 4-20x slower
    than the wavefront kernel on an H100 at 2D N=128/256 and tet nx=16),
    and on the CPU
    the JAX package's default, partri where its maps (``partri_plan``) fit
    the JAX package's cap (``CPU_PARTRI_MAX_BYTES``), else the wavefront, so
    that both packages route a test alike. Partri on the card needs its
    build's peak (``partri_peak``) free. Asking for partri where it does not
    fit raises ``MemoryError``: nothing moves to another backend or device
    unasked. ``group``: partri's grouped 2D pass (:func:`_partri_group`),
    whose maps the plan and peak count."""
    if option == "wavefront":
        return option
    free = _free_device_bytes(device)
    if free is None:
        need, budget = partri_plan(tuple(node_shape), nfields, group=group), CPU_PARTRI_MAX_BYTES
        what = f"of maps, the host budget is {budget}"
    elif not option:
        return "wavefront"
    else:
        need, budget = partri_peak(tuple(node_shape), nfields, group=group), free
        what = f"(maps and build workspace), the card has {free} free"
    if need <= budget:
        return "partri"
    if option == "partri":
        raise MemoryError(
            f"the partri trisolves need {need} bytes {what}; trisolve_backend=wavefront runs them as wavefront sweeps"
        )
    return "wavefront"


def _parity_engine(on_card: bool, option: str) -> str:
    """The parity ILU's engine: ``option`` (``pc_band_execution``) when the
    user gave one, else the band engine on the card and the host engine on
    the CPU, as the JAX package gives its accelerator the band engine."""
    if option not in ("", "device", "host"):
        raise ValueError(f"Unsupported pc_band_execution: {option!r} (device or host)")
    return option or ("device" if on_card else "host")


def _check_band_memory(need_bytes: int, free_bytes: Optional[int]) -> None:
    """Raise ``MemoryError`` when the band engine's plan (``need_bytes``,
    :func:`~perphil_tpu_torch.ops.bandsolve.band_plan`) exceeds the card's
    free memory; ``free_bytes`` None: the CPU twin, no card memory. The solve
    never moves to the host engine on its own: the user asks for it."""
    if free_bytes is not None and need_bytes > free_bytes:
        raise MemoryError(
            f"the band engine needs {need_bytes} bytes of device memory (level-ordered factor and vector), "
            f"{free_bytes} are free; pc_band_execution=host runs this solve on the host engine"
        )


def _build_parity_ilu_solver(W: MixedFunctionSpace, params: DPPParameters, frozen_sp: Tuple) -> Callable:
    """The ordering-parity GMRES+ILU(0) (``pc_factor_mat_ordering_type=rcm``):
    the reference's DMPlex numbering and finite-element fill pattern
    (``ops/ordering.py::parity_system``), factored once on the host by the
    C++ kernels (``ops/_native.py``), then solved by one of two engines
    (:func:`_parity_engine`): the band engine on the card
    (:func:`_build_band_parity_ilu_solver`) or the host engine
    (:func:`_build_host_parity_ilu_solver`). The returned solve's ``engine``
    says which. ``pc_band_defect_correct`` is accepted and changes nothing:
    the band engine's apply is the host engine's f64 arithmetic, so the JAX
    package's double-float correction of its f32 blocks has nothing to
    correct."""
    flat = dict(frozen_sp)
    option = str(flat.get("pc_band_execution", ""))
    engine = _parity_engine(W.device.type == "cuda", option)
    kw = dict(
        rtol=float(flat.get("ksp_rtol", 1e-5)),
        atol=float(flat.get("ksp_atol", 1e-50)),
        max_it=int(flat.get("ksp_max_it", 10000)),
        restart=int(flat.get("ksp_gmres_restart", 30)),
    )
    op = DPPOperator(W, params)
    mesh = W.mesh
    A, perm, Ap = parity_system(mesh, params)
    if engine == "device":
        Fc, _ = _native.native_ilu0(Ap)
        sched = level_schedule(Fc, perm)
        _check_band_memory(plan_of(sched).total_bytes, _free_device_bytes(W.device))
        solve = _build_band_parity_ilu_solver(op, sched, kw)
    else:
        solve = _build_host_parity_ilu_solver(op, A, perm, Ap, kw)
    solve.engine = engine
    return solve


def _build_band_parity_ilu_solver(op: DPPOperator, sched, kw: Dict[str, object]) -> Callable:
    """The band engine: GMRES (``ops/krylov.py::gmres``, the host loop; K1
    matvecs on the card) on the Newton-step system ``A d = b - A x0``, left
    preconditioned by the level-scheduled ILU apply of the factor's schedule
    ``sched`` (``ops/bandsolve.py::BandParityILU``, one ``band_trisolve``
    launch an apply on the card)."""
    band = build_band_parity_ilu(sched, op.W.device)
    mv = op.stacked_matvec()

    def krylov(r: torch.Tensor):
        res = gmres(mv, r, M_inv=band.apply, **kw)
        return res.x, res.iterations, res.residual_norm

    solve = _newton_step_solver(op, krylov)
    solve.pc_apply = band.apply  # the preconditioner alone, for the profiling probes
    return solve


def _build_host_parity_ilu_solver(op: DPPOperator, A, perm, Ap, kw: Dict[str, object]) -> Callable:
    """The host engine: ILU(0)-preconditioned GMRES by the C++ CSR kernels
    (``ops/_native.py``), factored once here (PETSc's PCSetUp), on
    ``(b - A x0)[perm]``; the fields come back on ``W``'s device."""
    native_solve = _native.native_ilu_gmres_solver(Ap, **kw)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.shape[0])
    bdry = op._mask_arrays[0]
    shape = (2,) + tuple(op.grid_shape)

    def solve_host(g1: torch.Tensor, g2: torch.Tensor):
        b = torch.stack(op.lifted_rhs(g1, g2)).reshape(-1).cpu().numpy()
        x0 = torch.stack([torch.where(bdry, g1, 0.0), torch.where(bdry, g2, 0.0)]).reshape(-1).cpu().numpy()
        its, dp, rnorm = native_solve((b - A @ x0)[perm])
        x = torch.from_numpy(x0 + dp[iperm]).reshape(shape).to(op.W.device)
        return x[0], x[1], its, rnorm

    return solve_host


@lru_cache(maxsize=64)
def _build_linear_solver(
    W: MixedFunctionSpace,
    params: DPPParameters,
    frozen_sp: Tuple,
    padding: Tuple[int, ...] = (),
) -> Callable:
    """Build a linear solve ``(g1, g2) -> (z1, z2, its, rnorm)`` for
    boundary-value grids g1, g2.

    With ``padding`` the grids carry phantom nodes at the high end of each
    grid axis (identity rows, zero data): the solve is
    :func:`_parts_solver` of :func:`_linear_parts`, the sharded path's
    solve on one device. A padding of zeros is the unpadded call and its
    cache entry."""
    if padding:
        if any(padding):
            return _parts_solver(_linear_parts(W, params, frozen_sp, tuple(padding)))
        return _build_linear_solver(W, params, frozen_sp)
    flat = _checked_options(frozen_sp)
    if (
        str(flat.get("pc_type", "")) == "ilu"
        and str(flat.get("pc_factor_mat_ordering_type", "natural")) == "rcm"
    ):
        # before ksp_type, as the JAX package routes it: preonly + ilu + rcm
        # runs GMRES there too; and never the fused roles (K7 is the
        # structured lexicographic ILU)
        return _build_parity_ilu_solver(W, params, frozen_sp)
    ksp = str(flat.get("ksp_type", "gmres"))
    op = DPPOperator(W, params)
    if ksp == "preonly":
        pc_type = str(flat.get("pc_type", "lu"))
        if pc_type in ("lu", "cholesky"):
            if (
                str(flat.get("pc_factor_mat_solver_type", "")) == "fastdiag_mixed"
                and not W.mesh.is_tensor_product
            ):
                raise ValueError("fastdiag_mixed needs quad/hex cells")
            # on quad/hex meshes both direct presets take the mixed-precision
            # route: K2 in the envelope, f32 fast-diag + K1 refinement beyond it
            direct = _monolithic_direct(op)
        else:
            pc = _monolithic_pc(op, flat)

            def direct(b1: torch.Tensor, b2: torch.Tensor):
                return (b1, b2) if pc is None else tuple(pc(torch.stack([b1, b2])))

        def solve_preonly(g1: torch.Tensor, g2: torch.Tensor):
            b1, b2 = op.lifted_rhs(g1, g2)
            z1, z2 = direct(b1, b2)
            # preonly reports 1 iteration and residual 0.0 (PETSc semantics)
            return z1, z2, 1, 0.0

        return solve_preonly

    if ksp not in ("gmres", "cg"):
        raise ValueError(f"Unsupported ksp_type: {ksp!r}")
    if flat.get("_x0_continuation"):
        return _continuation_solver(op, _krylov_route(op, flat))
    return _newton_step_solver(op, _krylov_route(op, flat))


def _degree_pc(op, params: DPPParameters, flat: Dict[str, object]) -> Optional[Callable]:
    """The degree-p direct solve (``preonly`` + lu) or GMRES preconditioner
    on blocks, ``(rs, blocks) -> zs`` on the stacked blocks of the (padded)
    DoF lattice that ``blocks`` holds; None: the identity. Qp: the exact
    fast-diag solve, none, jacobi (the diagonal cut to each block), or the
    multiplicative 2x2 block Gauss-Seidel with exact fast-diag blocks
    (``TensorFastDiagDPP.fieldsplit_blocks``); ILU is refused. P2: none or
    jacobi."""
    tensor = isinstance(op, TensorDPPOperator)
    ksp = str(flat.get("ksp_type", "preonly"))
    pc_type = str(flat.get("pc_type", "lu"))
    if tensor and (ksp == "preonly" or pc_type == "fieldsplit"):
        if ksp == "preonly" and pc_type != "lu":
            raise ValueError(f"degree-{op.degree} preonly supports pc_type=lu only")
        direct = TensorFastDiagDPP(op.mesh, params, op.degree, op.padding, device=op.device)
        if ksp == "preonly":
            return direct.solve_blocks
        return lambda rs, blocks: direct.fieldsplit_blocks(rs, blocks, op)
    if pc_type in ("none", ""):
        return None
    if pc_type == "jacobi":
        diagonal = op.diagonal_stacked()

        def jacobi(rs, blocks):
            d = blocks.built(("jacobi", jacobi), lambda: blocks.cut(diagonal, lead=1))
            return {c: r / d[c] for c, r in rs.items()}

        return jacobi
    if not tensor:
        raise ValueError(f"Unsupported pc_type {pc_type!r} for P2 simplex (none/jacobi/preonly+lu)")
    if pc_type == "ilu":
        raise ValueError(
            f"pc_type=ilu has no degree-{op.degree} structured factorization; "
            "use fieldsplit/jacobi or the preonly fast-diag direct solve"
        )
    raise ValueError(f"Unsupported pc_type {pc_type!r} for degree>1")


@lru_cache(maxsize=64)
def _build_tensor_linear_solver(
    W: MixedFunctionSpace,
    params: DPPParameters,
    frozen_sp: Tuple,
    padding: Tuple[int, ...] = (),
) -> Callable:
    """Degree-p (Qp) linear solve on quad/hex meshes on ``W``'s device: the
    exact fast-diagonalisation solve for preonly + lu, GMRES with pc none,
    jacobi or the multiplicative fieldsplit (exact fast-diag blocks)
    otherwise. ``padding`` as in :func:`_build_linear_solver`: the 1D
    factors' inert identity blocks (``TensorDPPOperator.padding``)."""
    if padding and not any(padding):
        return _build_tensor_linear_solver(W, params, frozen_sp)
    return _parts_solver(_linear_parts(W, params, frozen_sp, tuple(padding)))


@lru_cache(maxsize=16)
def _build_simplex_p2_linear_solver(
    W: MixedFunctionSpace,
    params: DPPParameters,
    frozen_sp: Tuple,
    padding: Tuple[int, ...] = (),
) -> Callable:
    """P2 linear solve on tri/tet meshes: GMRES with pc none or jacobi on
    the parity-class stencil operator on ``W``'s device; preonly + lu is the
    host stage, scipy ``splu`` of the assembled CSR (as in the JAX package;
    P2 simplices have no fast-diagonalisation structure), with the solution
    copied to ``W``'s device. ``padding`` as in
    :func:`_build_linear_solver` (phantom rows marked boundary,
    ``P2SimplexDPPOperator.padding``); the host stage refuses it."""
    if padding and not any(padding):
        return _build_simplex_p2_linear_solver(W, params, frozen_sp)
    flat = dict(frozen_sp)
    mesh, dev = W.mesh, W.device
    ksp = str(flat.get("ksp_type", "preonly"))
    pc_type = str(flat.get("pc_type", "lu"))
    if ksp == "preonly" and not padding:
        op = P2SimplexDPPOperator(mesh, params, device=dev)
        shape = op.dof_shape
        if pc_type not in ("lu", "cholesky"):
            raise ValueError(f"P2 simplex preonly supports pc_type=lu, got {pc_type!r}")
        lu = splu(assemble_p2_monolithic(mesh, params).tocsc())

        def solve_direct(g1: torch.Tensor, g2: torch.Tensor):
            b = torch.stack(op.lifted_rhs(g1, g2)).reshape(-1).cpu().numpy()
            x = torch.from_numpy(lu.solve(b)).reshape((2,) + shape).to(dev)
            return x[0], x[1], 1, 0.0

        return solve_direct
    return _parts_solver(_linear_parts(W, params, frozen_sp, tuple(padding)))


class LinearParts(NamedTuple):
    """A linear solve taken apart for blocks of the grid (the sharded entry,
    ``parallel/sharding.py``, and the padded and degree-p single-device
    builders, on the whole grid as one block):

    - ``kind``: ``preonly``, ``gmres``, ``cg``, or ``whole`` (``whole`` is
      the cached single-device solve ``(g1, g2) -> (z1, z2, its, rnorm)``,
      run on the replicated boundary data: the ordering-parity ILU);
    - ``op``: the operator on the padded grid; ``boundary`` its boundary
      rows (the BC lift's ``x0``);
    - ``newton``: Q1: the Krylov solve is on the Newton-step system from the
      BC lift; else (Qp, P2) on ``A x = b`` from ``x0``: each as its
      single-device route;
    - ``operator``: ``operator(blocks, mode)`` is the matvec (``"matvec"``)
      or the lift (``"lift"``) on the one stacked block ``blocks`` holds
      (``parallel/transpose.py``) after the plane exchange: K1's halo form
      (Q1), the Qp operator's bands on a box of p planes a side, the P2
      stencils on a box of 2;
    - ``blocked``: the direct solve (preonly) or the preconditioner on a
      block: ``blocked(blocks)`` is the tensor function on the one block
      ``blocks`` holds, its collectives the plane exchange, the all-to-all
      transposes and all-reduces: the direct solves (Q1: the blocked
      mixed-precision fast-diag on quad/hex, ``cg`` with the blocked lumped
      preconditioner on tri/tet; Qp: the exact fast-diag), Jacobi, and the
      fieldsplit whose blocks are exact, Jacobi, none or Krylov solves with
      such preconditioners; ILU (monolithic or in a fieldsplit block),
      which the JAX package gathers too, is the single-device one on the
      gathered, cropped vector (``blocks.gathered``); None: the identity;
    - ``kw``: the Krylov settings.
    """

    kind: str
    op: object
    boundary: Optional[torch.Tensor]
    newton: bool
    operator: Optional[Callable]
    kw: Dict[str, float]
    blocked: Optional[Callable] = None
    whole: Optional[Callable] = None


def _cropped(fn: Optional[Callable], shape: Tuple[int, ...], padding: Tuple[int, ...]) -> Optional[Callable]:
    """``fn`` on the unpadded stacked grid, applied to a padded one: the
    phantoms cropped away before and zero after."""
    if fn is None or not any(padding):
        return fn
    crop = (slice(None),) + tuple(slice(0, n) for n in shape)

    def padded(r: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(r)
        out[crop] = fn(r[crop].contiguous())
        return out

    return padded


def _halo_apply(op: DPPOperator, blocks, mode: str = "matvec") -> Callable[[torch.Tensor], torch.Tensor]:
    """K1's halo form of ``op`` (padded or not) on the one stacked block
    ``blocks`` holds, after the plane exchange."""
    S, grid, n_phys = op._combined_stencils, op.grid_shape, op.mesh.node_shape
    return blocks.one(lambda xs: blocks.halo_apply(S, xs, mode, grid, n_phys))


def _blockable(flat: Dict[str, object]) -> bool:
    """Whether the monolithic preconditioner of ``flat`` runs on blocks:
    Jacobi, LU/Cholesky (the direct solves), and the fieldsplit without an
    ILU block; ILU stays gathered, as in the JAX package."""
    pc_type = str(flat.get("pc_type", "none"))
    if pc_type in ("jacobi", "lu", "cholesky"):
        return True
    if pc_type == "fieldsplit":
        return all(str(flat.get(f"fieldsplit_{i}_pc_type", "ilu")) != "ilu" for i in (0, 1))
    return False


def _blocked_direct(op: DPPOperator) -> Callable:
    """The monolithic direct solve on blocks, ``blocks -> (b -> z)``: the
    mixed-precision fast-diag (``MixedPrecisionDPPDirect.solve_blocks``) on
    quad/hex meshes at every size, and on tri/tet ``cg`` to 1e-13 with the
    blocked lumped fast-diag preconditioner. Neither takes K2/K3, by
    design: the JAX package's padded builder takes no Pallas direct kernel
    either, but on a divisible lattice its unpadded builder takes K2/K3,
    which its partitioner gathers."""
    mesh, dev = op.mesh, op.W.device
    if mesh.is_tensor_product:
        direct = MixedPrecisionDPPDirect(mesh, op.params, device=dev, padding=op.padding)
        return lambda blocks: blocks.one(lambda bs: direct.solve_blocks(bs, blocks))
    pc = LumpedDPPPreconditioner(mesh, op.params, device=dev)

    def build(blocks):
        mv = _halo_apply(op, blocks)
        M = blocks.one(lambda rs: pc.solve_blocks(rs, blocks, op.padding))
        return lambda b: cg(mv, b, rtol=_DIRECT_RTOL, atol=0.0, max_it=_DIRECT_MAX_IT, M_inv=M,
                            allreduce=blocks.allreduce)[0]

    return build


def _blocked_field_solver(op: DPPOperator, i: int, sub: Dict[str, object]) -> Callable:
    """Fieldsplit block ``i``'s solve on blocks, ``blocks -> (b -> z)`` on
    the field's block: an exact solve (the blocked f64 fast-diag on
    quad/hex, blocked ``cg`` with the lumped preconditioner on tri/tet),
    Jacobi, none, or ``gmres`` / ``cg`` with such a preconditioner; the
    field's matvec is K1's halo form with the other field zero."""
    p, mesh, dev = op.params, op.mesh, op.W.device
    k = p.k1 if i == 0 else p.k2
    fop = FieldOperator(op.W.sub(i), k, p.beta, p.mu, op.padding)
    ksp = str(sub.get("ksp_type", "preonly"))
    pc_type = str(sub.get("pc_type", "ilu"))
    if ksp not in ("preonly", "gmres", "cg"):
        raise ValueError(f"Unsupported block ksp_type: {ksp!r}")
    exact = None
    if pc_type in ("lu", "cholesky"):
        exact = FastDiagFieldSolver(mesh, k, p.beta, p.mu, lumped=not mesh.is_tensor_product, device=dev)
    elif pc_type not in ("jacobi", "none"):
        raise ValueError(f"Unsupported block pc_type: {pc_type!r}")

    def build(blocks):
        full = _halo_apply(op, blocks)

        def mv(z: torch.Tensor) -> torch.Tensor:
            zero = torch.zeros_like(z)
            return full(torch.stack([z, zero] if i == 0 else [zero, z]))[i]

        if pc_type == "jacobi":
            bdry = blocks.own(fop._mask_arrays[0])
            dinv = torch.full(bdry.shape, 1.0 / float(fop.stencil[(1,) * mesh.dim]), dtype=torch.float64,
                              device=bdry.device).masked_fill_(bdry, 1.0)
            pc = lambda r: dinv * r  # noqa: E731
        elif exact is None:
            pc = None
        else:
            solve = blocks.one(lambda bs: exact.solve_blocks(bs, blocks, op.padding))
            if mesh.is_tensor_product:
                pc = solve
            else:
                def pc(b: torch.Tensor) -> torch.Tensor:
                    return cg(mv, b, rtol=_DIRECT_RTOL, atol=0.0, max_it=1000, M_inv=solve,
                              allreduce=blocks.allreduce)[0]
        if ksp == "preonly":
            return pc if pc is not None else (lambda r: r)
        kw = dict(rtol=float(sub.get("ksp_rtol", 1e-5)), atol=float(sub.get("ksp_atol", 1e-50)),
                  max_it=int(sub.get("ksp_max_it", 10000)))
        if ksp == "cg":
            return lambda b: cg(mv, b, M_inv=pc, allreduce=blocks.allreduce, **kw)[0]
        restart = int(sub.get("ksp_gmres_restart", 30))
        return lambda b: gmres(mv, b, restart=restart, M_inv=pc, allreduce=blocks.allreduce, **kw).x

    return build


def _blocked_coupling(op: DPPOperator, blocks) -> Callable[[torch.Tensor], torch.Tensor]:
    """``C y`` on the field's block (:func:`coupling_apply` on blocks, its
    boundary and phantom rows zero): K1's halo form on ``(0, y)``, whose
    first field's interior rows are ``C y``."""
    full = _halo_apply(op, blocks)
    return lambda y: full(torch.stack([torch.zeros_like(y), y]))[0]


def _blocked_field_blocks(op: DPPOperator, flat: Dict[str, object]) -> Tuple[Callable, Callable]:
    """The two fieldsplit block solves on blocks (:func:`_blocked_field_solver`)."""
    return tuple(_blocked_field_solver(op, i, _sub_options(flat, f"fieldsplit_{i}_")) for i in (0, 1))


def _preconditioner(op: DPPOperator, flat: Dict[str, object]) -> Optional[Callable]:
    """The monolithic preconditioner of ``flat`` for ``op``'s (padded) grid,
    ``blocks -> (r -> P r)`` on the stacked block: on blocks where
    :func:`_blockable` takes it, else the unpadded single-device one
    (``_monolithic_pc``: ILU, which the JAX package gathers too) on the
    gathered, cropped vector; None where there is none."""
    if _blockable(flat):
        return _blocked_pc(op, flat)
    pc = _cropped(_monolithic_pc(DPPOperator(op.W, op.params), flat), op.mesh.node_shape, op.padding)
    return None if pc is None else (lambda blocks: blocks.gathered(pc))


def _blocked_pc(op: DPPOperator, flat: Dict[str, object]) -> Callable:
    """The monolithic preconditioner of ``flat`` (:func:`_blockable`) on
    blocks, ``blocks -> (r -> P r)`` on the stacked block."""
    pc_type = str(flat.get("pc_type", "none"))
    if pc_type == "jacobi":
        diag = (1.0 / op.diagonal()).reshape((2,) + op.grid_shape)

        def jacobi(blocks):
            dinv = blocks.own(diag, lead=1)
            return lambda r: dinv * r

        return jacobi
    if pc_type in ("lu", "cholesky"):
        return _blocked_direct(op)
    fs_type = str(flat.get("pc_fieldsplit_type", "multiplicative"))
    if fs_type not in ("multiplicative", "additive"):
        raise ValueError(f"Unsupported pc_fieldsplit_type: {fs_type!r}")
    subs = [_sub_options(flat, f"fieldsplit_{i}_") for i in (0, 1)]
    builds = _blocked_field_blocks(op, flat)
    mesh, p = op.mesh, op.params
    pair = None
    if fs_type == "additive" and mesh.is_tensor_product and all(
            str(sub.get("ksp_type", "preonly")) == "preonly" and str(sub.get("pc_type", "ilu")) in ("lu", "cholesky")
            for sub in subs):
        # both exact blocks on shared transforms: both fields in every transpose
        pair = [FastDiagFieldSolver(mesh, k, p.beta, p.mu, device=op.W.device) for k in (p.k1, p.k2)]

    def build(blocks):
        if pair is not None:
            return blocks.one(field_pair_blocks(*pair, blocks, op.padding))
        B0, B1 = (b(blocks) for b in builds)
        if fs_type == "additive":
            return lambda r: torch.stack([B0(r[0]), B1(r[1])])
        C = _blocked_coupling(op, blocks)

        def apply_fs(r: torch.Tensor) -> torch.Tensor:
            y1 = B0(r[0])
            return torch.stack([y1, B1(r[1] - C(y1))])

        return apply_fs

    return build


@lru_cache(maxsize=64)
def _linear_parts(
    W: MixedFunctionSpace, params: DPPParameters, frozen_sp: Tuple, padding: Tuple[int, ...] = ()
) -> LinearParts:
    """The parts of the linear solve of ``(W, params, options)`` on the grid
    padded by ``padding``: the operator, and the direct solves and the
    preconditioners that :func:`_blockable` takes, on blocks; ILU is the
    unpadded single-device one (``_monolithic_pc``) on the cropped,
    gathered vector. The degree-p parts are built padded, as in the JAX
    package, and run on blocks too: the Qp operator and its fast-diag
    solves, the P2 stencils, Jacobi; where a block is thinner than the
    planes the operator reads (p a side for Qp, 2 for P2;
    ``parallel/halo.py::halo_fits``), they run gathered instead: the whole
    grid's operator, lift and preconditioner or direct solve on the
    gathered vector, cut back to the block."""
    flat = _checked_options(frozen_sp)
    padding = tuple(padding)
    degree = W.spaces[0].degree
    kw = dict(
        rtol=float(flat.get("ksp_rtol", 1e-5)),
        atol=float(flat.get("ksp_atol", 1e-50)),
        max_it=int(flat.get("ksp_max_it", 10000)),
        restart=int(flat.get("ksp_gmres_restart", 30)),
    )
    if degree == 1:
        if str(flat.get("pc_type", "")) == "ilu" and str(flat.get("pc_factor_mat_ordering_type", "natural")) == "rcm":
            if any(padding):
                raise ValueError(
                    "pc_factor_mat_ordering_type=rcm is a dedicated parity path; not available under sharding padding"
                )
            return LinearParts("whole", None, None, False, None, kw, whole=_build_linear_solver(W, params, frozen_sp))
        op = DPPOperator(W, params, padding)
        ksp = str(flat.get("ksp_type", "gmres"))
        if ksp not in ("preonly", "gmres", "cg"):
            raise ValueError(f"Unsupported ksp_type: {ksp!r}")
        bdry = op._mask_arrays[0]
        operator = lambda blocks, mode: _halo_apply(op, blocks, mode)  # noqa: E731
        if ksp == "preonly" and str(flat.get("pc_type", "lu")) in ("lu", "cholesky"):
            if str(flat.get("pc_factor_mat_solver_type", "")) == "fastdiag_mixed" and not W.mesh.is_tensor_product:
                raise ValueError("fastdiag_mixed needs quad/hex cells")
            return LinearParts(ksp, op, bdry, True, operator, kw, _blocked_direct(op))
        return LinearParts(ksp, op, bdry, True, operator, kw, _preconditioner(op, flat))
    mesh, dev = W.mesh, W.device
    ksp = str(flat.get("ksp_type", "preonly"))
    if mesh.is_tensor_product:
        op = TensorDPPOperator(mesh, params, degree, padding, device=dev)
        if ksp not in ("preonly", "gmres"):
            raise ValueError(f"degree-{degree} spaces support preonly/gmres, got {ksp!r}")
    else:
        op = P2SimplexDPPOperator(mesh, params, padding, device=dev)
        if ksp == "preonly":
            raise NotImplementedError(
                "P2 simplex preonly+lu is a host sparse-direct path (scipy splu) with no distribution; "
                "sharded P2 simplex solves support ksp_type=gmres with pc_type none/jacobi"
            )
        if ksp != "gmres":
            raise ValueError(f"P2 simplex spaces support preonly/gmres, got {ksp!r}")
    pc = _degree_pc(op, params, flat)
    width = degree if mesh.is_tensor_product else 2  # the planes a side the operator reads

    def on(blocks, fn):
        """``fn(xs, blocks)`` on the blocks, or, where a block is thinner
        than the operator's halo, the whole grid's ``fn`` on the gathered
        vector, the result cut back: one all-gather an application."""
        if halo_fits(op.dof_shape, blocks.mesh_shape, width):
            return blocks.one(lambda xs: fn(xs, blocks))
        whole = op.whole
        return blocks.gathered(whole.one(lambda xs: fn(xs, whole)))

    operator = lambda blocks, mode: on(blocks, lambda xs, b: op.apply_blocks(xs, b, mode))  # noqa: E731
    blocked = None if pc is None else (lambda blocks: on(blocks, pc))
    return LinearParts(ksp, op, op._bdry, False, operator, kw, blocked)


def parts_on(parts: LinearParts, blocks) -> Tuple[Callable, Callable, torch.Tensor, Optional[Callable]]:
    """``parts`` as tensor functions on the block ``blocks`` holds (the
    joined grid on ``parallel/transpose.py::JoinedBlocks``), built once per
    set of blocks: the matvec, the lift, the block's boundary rows, and the
    direct solve or preconditioner (None: none)."""
    mv, lift, bdry = blocks.built(("operator", parts.operator), lambda: (
        parts.operator(blocks, "matvec"), parts.operator(blocks, "lift"), blocks.own(parts.boundary)))
    fn = None if parts.blocked is None else blocks.built(("parts", parts.blocked), lambda: parts.blocked(blocks))
    return mv, lift, bdry, fn


def _run_parts(
    parts: LinearParts,
    g: torch.Tensor,
    blocks,
    allreduce: Optional[Callable],
) -> Tuple[torch.Tensor, int, float]:
    """Solve ``parts`` on a block: ``g`` the stacked boundary data of the
    one block ``blocks`` holds (``parallel/transpose.py``: the operator,
    the lift and the blocked parts run on it, the gathered ones through its
    ``gathered``), ``allreduce`` the sum over the blocks' ranks (None: one
    block, the whole grid). Returns the block of the solution, the
    iterations and the residual norm, the last two equal on every rank."""
    mv, lift, bdry, fn = parts_on(parts, blocks)
    b = lift(g)
    if parts.kind == "preonly":
        # preonly reports 1 iteration and residual 0.0 (PETSc semantics)
        return (b if fn is None else fn(b)), 1, 0.0
    x0 = torch.where(bdry, g, 0.0)
    kw = parts.kw
    if not parts.newton:
        res = gmres(mv, b, x0=x0, M_inv=fn, allreduce=allreduce, **kw)
        return res.x, res.iterations, res.residual_norm
    r = b - mv(x0)
    if parts.kind == "cg":
        d, its, rnorm = cg(mv, r, rtol=kw["rtol"], atol=kw["atol"], max_it=kw["max_it"], M_inv=fn, allreduce=allreduce)
    else:
        res = gmres(mv, r, M_inv=fn, allreduce=allreduce, **kw)
        d, its, rnorm = res.x, res.iterations, res.residual_norm
    return x0 + d, its, rnorm


def _parts_solver(parts: LinearParts) -> Callable:
    """:func:`_run_parts` on one device over the whole (padded) grid as one
    block (``LoopbackBlocks(())``: no plane moves, the blocked parts'
    whole-grid arithmetic): ``(g1, g2) -> (z1, z2, its, rnorm)``; the
    padded Q1 solves and every degree-p solve but P2's host direct stage."""
    from perphil_tpu_torch.parallel.transpose import LoopbackBlocks

    whole = LoopbackBlocks(())

    def solve(g1: torch.Tensor, g2: torch.Tensor):
        z, its, rnorm = _run_parts(parts, torch.stack([g1, g2]), whole, None)
        return z[0], z[1], its, rnorm

    return solve


def _degree_solver(W: MixedFunctionSpace, params: DPPParameters, frozen_sp: Tuple) -> Callable:
    """The cached linear solve of ``W``'s degree: Q1/P1, Qp or P2."""
    if W.spaces[0].degree == 1:
        return _build_linear_solver(W, params, frozen_sp)
    if W.mesh.is_tensor_product:
        return _build_tensor_linear_solver(W, params, frozen_sp)
    return _build_simplex_p2_linear_solver(W, params, frozen_sp)


def solve_dpp(
    W: MixedFunctionSpace,
    model_params: DPPParameters,
    bcs: Sequence[DirichletBC],
    solver_parameters: Dict = {},
    options_prefix: str = "dpp",
) -> Solution:
    """Solve the monolithic DPP linear system on ``W``'s device; returns a
    ``Solution`` with the iteration count and residual norm."""
    _validate_mixed(W)
    solver_parameters = apply_prefix_overrides(solver_parameters, options_prefix)
    g1, g2 = bc_values_per_field(W, bcs)
    solver = _degree_solver(W, model_params, _freeze(solver_parameters))
    z1, z2, its, rnorm = solver(g1, g2)
    return Solution(Function(W, (z1, z2)), int(its), float(rnorm))


def _ngs_sweeper(
    mesh, params: DPPParameters, device, trisolve: str = "", build_wavefront: bool = True, group: int = 0
) -> Union[ColoredNGSSweeper, GaussSeidelSweeper, PartriGS, None]:
    """The SNES ngs sweep: the pinned-colouring multicolour sweeper on quad
    meshes (the reference's exact Picard counts), the lexicographic
    Gauss-Seidel sweeper elsewhere (on the ``trisolve_backend`` option
    ``trisolve``, :func:`_trisolve_backend`; partri grouped by ``group``).
    With ``build_wavefront``
    false, the wavefront's is None: ``FusedGSSolver`` builds it where its
    twin or the host route sweeps."""
    if mesh.element == "quad":
        return ColoredNGSSweeper(mesh, params, device)
    backend = _trisolve_backend(trisolve, mesh.node_shape, 2, device, group)
    if backend == "wavefront" and not build_wavefront:
        return None
    return GS_BACKENDS[backend].for_monolithic(mesh, params, device, **_group_kw(backend, group))


@lru_cache(maxsize=64)
def _build_nonlinear_solver(
    W: MixedFunctionSpace,
    params: DPPParameters,
    frozen_sp: Tuple,
) -> Callable:
    """Build a Picard solve ``(g1, g2) -> (z1, z2, its, fnorm)`` for
    boundary-value grids g1, g2 (``snes_type`` ngs, block_gs, nrichardson).
    With ``_x0_continuation`` the ngs solve is the continuation
    variant ``(g1, g2, x01, x02, atol_abs) -> (z1, z2, its, fnorm)``: from
    the given iterate, stopping on ``fnorm <= atol_abs`` or ``snes_max_it``
    (``perphil_tpu/solvers/solver.py:1869-1895``); the sweeps are
    memoryless given the iterate, so a chunked solve is the whole one."""
    flat = _checked_options(frozen_sp)
    continuation = bool(flat.get("_x0_continuation"))
    snes = str(flat.get("snes_type", "ngs"))
    rtol = float(flat.get("snes_rtol", 1e-8))
    atol = float(flat.get("snes_atol", 1e-50))
    max_it = int(flat.get("snes_max_it", 50))
    op = DPPOperator(W, params)
    mesh = W.mesh
    bdry = op._mask_arrays[0]

    def lift(g1: torch.Tensor, g2: torch.Tensor):
        b = torch.stack(op.lifted_rhs(g1, g2))
        x0 = torch.stack([torch.where(bdry, g1, 0.0), torch.where(bdry, g2, 0.0)])
        return b, x0

    if snes == "ngs":
        # PETSc's default SNES ngs is a colouring-based pointwise secant
        # Gauss-Seidel; the fieldsplit keys of the Picard presets are inert
        sweeper = _ngs_sweeper(
            mesh, params, W.device, _trisolve_option(flat), build_wavefront=False, group=_partri_group(flat)
        )
        if isinstance(sweeper, ColoredNGSSweeper):
            fused = FusedNGSSolver(op, sweeper, rtol, atol, max_it)

            def run(b: torch.Tensor, x0: torch.Tensor, rtol_: float, atol_: float):
                if W.device.type == "cuda" and fused.plan is None:
                    return ngs_host_loop(op, sweeper, b, x0, rtol_, atol_, max_it)
                return fused(b, x0, tols=(rtol_, atol_))

        else:
            # the wavefront: the whole solve in one fused_gs launch within
            # its plan (the twin on the CPU); the card beyond the plan: the
            # host loop on the solver's sweeper, which only the twin and
            # that loop build; partri: the host loop
            fused = FusedGSSolver(op, None, rtol, atol, max_it) if sweeper is None else None

            def run(b: torch.Tensor, x0: torch.Tensor, rtol_: float, atol_: float):
                if fused is None:
                    return gs_host_loop(op, sweeper, b, x0, rtol_, atol_, max_it)
                if W.device.type == "cuda" and fused.plan is None:
                    return gs_host_loop(op, fused.sweeper, b, x0, rtol_, atol_, max_it)
                return fused(b, x0, tols=(rtol_, atol_))

        if continuation:

            def solve_ngs_from(g1: torch.Tensor, g2: torch.Tensor, x01: torch.Tensor, x02: torch.Tensor,
                               atol_abs: float):
                res = run(lift(g1, g2)[0], torch.stack([x01, x02]), 0.0, float(atol_abs))
                return res.x[0], res.x[1], res.iterations, res.residual_norm

            return solve_ngs_from

        def solve_ngs(g1: torch.Tensor, g2: torch.Tensor):
            res = run(*lift(g1, g2), rtol, atol)
            return res.x[0], res.x[1], res.iterations, res.residual_norm

        return solve_ngs

    mv = op.stacked_matvec()
    if snes == "block_gs":
        # exact alternating field solves: the fixed-stress split the delayed
        # form encodes
        p = params
        B0, B1 = _field_blocks(W, p, flat)
        C = coupling_apply(mesh, p, W.device)

        def solve_block_gs(g1: torch.Tensor, g2: torch.Tensor):
            b, x0 = lift(g1, g2)

            def step(z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
                z1 = B0(b[0] - C(z[1]))
                return torch.stack([z1, B1(b[1] - C(z1))])

            res = picard_loop(step, lambda z: b - mv(z), x0, rtol, atol, max_it)
            return res.x[0], res.x[1], res.iterations, res.residual_norm

        return solve_block_gs

    if snes == "nrichardson":
        # DOCUMENTED DEVIATION from PETSc (as in the JAX package): PETSc's
        # nrichardson without an inner npc is unpreconditioned and diverges
        # on this system; the ksp/pc options serve as its preconditioner, so
        # its counts are not PETSc's
        damping = float(flat.get("snes_linesearch_damping", 1.0))
        pc = _monolithic_pc(op, flat)

        def solve_richardson(g1: torch.Tensor, g2: torch.Tensor):
            b, x0 = lift(g1, g2)

            def step(z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
                return z + damping * (pc(r) if pc is not None else r)

            res = picard_loop(step, lambda z: b - mv(z), x0, rtol, atol, max_it)
            return res.x[0], res.x[1], res.iterations, res.residual_norm

        return solve_richardson

    raise ValueError(f"Unsupported snes_type: {snes!r}")


@lru_cache(maxsize=64)
def _nonlinear_parts(W: MixedFunctionSpace, params: DPPParameters, frozen_sp: Tuple) -> Optional[Callable]:
    """The Picard solve of ``(W, params, options)`` on blocks of the node
    grid (the sharded entry, ``parallel/sharding.py``; the grid divisible by
    the mesh): ``blocks -> solve``, ``solve(g) -> (x, its, fnorm)`` on the
    one stacked block of boundary data ``blocks`` holds
    (``parallel/transpose.py``), from the lift on blocks (K1's halo form),
    every norm the blocks' tree sums reduced over the ranks:

      - ngs on quad meshes: the Picard iteration on blocks
        (``fused_ngs.blocked_ngs`` on a ``NgsSweep``: a colour step of
        every held block a launch, the norm and the stop test on the card,
        the iterations issued in batches between read-backs);
      - block_gs: the blocked exact field solves and the coupling on
        blocks;
      - nrichardson: the preconditioner of :func:`_preconditioner` (on
        blocks, or ILU on the gathered vector).

    None for ngs on tri/hex/tet meshes: the lexicographic sweep is
    sequential and runs whole on the gathered data, as in the JAX
    package."""
    flat = _checked_options(frozen_sp)
    snes = str(flat.get("snes_type", "ngs"))
    rtol = float(flat.get("snes_rtol", 1e-8))
    atol = float(flat.get("snes_atol", 1e-50))
    max_it = int(flat.get("snes_max_it", 50))
    mesh, p = W.mesh, params
    if snes == "ngs" and mesh.element != "quad":
        return None
    if snes not in ("ngs", "block_gs", "nrichardson"):
        raise ValueError(f"Unsupported snes_type: {snes!r}")
    op = DPPOperator(W, p)
    grid = op.grid_shape
    sweeper = ColoredNGSSweeper(mesh, p, W.device) if snes == "ngs" else None
    if snes == "block_gs":
        fields = _blocked_field_blocks(op, flat)
    elif snes == "nrichardson":
        damping = float(flat.get("snes_linesearch_damping", 1.0))
        pc_build = _preconditioner(op, flat)

    def build(blocks):
        c = blocks.coords[0]
        bdry = blocks.cut(op._mask_arrays[0])[c]
        lift = _halo_apply(op, blocks, "lift")
        if sweeper is not None:
            sweep = NgsSweep(sweeper, grid, blocks)

            def solve_ngs(g: torch.Tensor):
                x0 = torch.where(bdry, g, 0.0)
                res = blocked_ngs(sweep, {c: lift(g)}, {c: x0}, rtol, atol, max_it)
                return res.x[c], res.iterations, res.residual_norm

            return solve_ngs
        mv = _halo_apply(op, blocks)
        if snes == "block_gs":
            B0, B1 = (f(blocks) for f in fields)
            C = _blocked_coupling(op, blocks)

            def step(b: torch.Tensor, z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
                z1 = B0(b[0] - C(z[1]))
                return torch.stack([z1, B1(b[1] - C(z1))])

        else:
            pc = None if pc_build is None else pc_build(blocks)

            def step(b: torch.Tensor, z: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
                return z + damping * (pc(r) if pc is not None else r)

        norm = blocked_norm(blocks)

        def solve(g: torch.Tensor):
            b = lift(g)
            res = picard_loop(lambda z, r: step(b, z, r), lambda z: b - mv(z), torch.where(bdry, g, 0.0), rtol, atol,
                              max_it, norm=lambda r: norm({c: r}))
            return res.x, res.iterations, res.residual_norm

        return solve

    return build


def ngs_on_one_rank_whole(W: MixedFunctionSpace, frozen_sp: Tuple, world: int) -> bool:
    """The route of the sharded Picard ngs on a world of one rank: True
    where it runs the single-device solve (``_build_nonlinear_solver``: one
    ``fused_ngs`` launch), False where it runs the blocked iteration
    (``_nonlinear_parts``). The rule: the single-device solve wherever the
    fused kernel's plan places the grid (2D quad N <= 255), the blocked
    iteration beyond it, where the single-device route is the host loop
    (``ngs_host_loop``: a norm read back every iteration). Measured on one
    NCCL rank of an H100 at 700 W, in turns (``chip_smoke.py`` phase 14,
    ``tools/profile_kernels.py --only ngs-blocked``): 2D N=64 ``fused_ngs``
    0.021 s, the blocked iteration 0.11-0.18 s; N=128 0.085 s against
    0.35-0.39 s (the blocked iteration's launches, ~64 µs an iteration
    from a graph, against the fused kernel's ~17 µs)."""
    flat = _checked_options(frozen_sp)
    return (world == 1 and str(flat.get("snes_type", "ngs")) == "ngs" and W.mesh.element == "quad"
            and fused_ngs_plan(W.mesh.node_shape, 1) is not None)


def linear_on_one_rank_whole(world: int) -> bool:
    """The route of the sharded linear solve (``parallel/sharding.py::
    sharded_solve_dpp``, and so the sharded ``ksponly``): True where it runs
    the single-device solve (:func:`_degree_solver`: K2-K8, the mixed
    route, the degree-p solves on the grid as one block; no collective),
    False where it runs the blocked route (:func:`_linear_parts` on the
    rank's block). The rule: a world of one rank runs the single-device
    solve, as the JAX package does on a one-device mesh (its padding is
    empty there and it calls ``solve_dpp``'s builder). Measured on one NCCL
    rank of an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 14
    (e), the two routes in turns, host wall of a warm solve, two runs): 2D
    N=64 SS-GMRES 0.003-0.004 s (K6) against 0.039-0.052 s, plain GMRES
    0.056-0.059 s (K4) against 6.14-7.01 s (the distributed host loop);
    128^3 hex ``TPU_DIRECT_PARAMS`` 0.041-0.079 s against the blocked
    route's 0.049-0.095 s (the same mixed fast-diag, the blocked one with
    its moves on groups of one: apart by less than the runs' spread)."""
    return world == 1


def solve_dpp_nonlinear(
    W: MixedFunctionSpace,
    model_params: DPPParameters,
    bcs: Sequence[DirichletBC],
    solver_parameters: Dict = {},
    options_prefix: str = "dpp_nonlinear",
) -> Solution:
    """Picard-style nonlinear solve on ``W``'s device (SNES ``ngs``,
    ``block_gs``, ``nrichardson`` or ``ksponly``); returns a ``Solution``
    with the SNES iteration count and the final function norm."""
    _validate_mixed(W)
    solver_parameters = apply_prefix_overrides(solver_parameters, options_prefix)
    g1, g2 = bc_values_per_field(W, bcs)
    flat = _flatten_options(solver_parameters)
    degree = W.spaces[0].degree
    if str(flat.get("snes_type", "ngs")) == "ksponly":
        # PETSc semantics: SNESKSPONLY reports iteration 1 and the true
        # residual norm after the one linear solve, not the KSP's
        ksp_opts = {k: v for k, v in flat.items() if not k.startswith("snes_")}
        if degree > 1:
            solver = _build_tensor_linear_solver(W, model_params, _freeze(ksp_opts))
            op = TensorDPPOperator(W.mesh, model_params, degree, device=W.device)
        else:
            solver = _build_linear_solver(W, model_params, _freeze(ksp_opts))
            op = DPPOperator(W, model_params)
        z1, z2, _, _ = solver(g1, g2)
        b1, b2 = op.lifted_rhs(g1, g2)
        return Solution(Function(W, (z1, z2)), 1, float(_norm(torch.stack(op.residual(z1, z2, b1, b2)))))
    if degree > 1:
        raise ValueError(
            f"solve_dpp_nonlinear supports degree-{degree} spaces only with "
            "snes_type='ksponly'; the ngs/nrichardson/block_gs solves are "
            "degree-1 (use the linear solve_dpp path for Qp systems)"
        )
    solver = _build_nonlinear_solver(W, model_params, _freeze(solver_parameters))
    z1, z2, its, fnorm = solver(g1, g2)
    return Solution(Function(W, (z1, z2)), int(its), float(fnorm))
