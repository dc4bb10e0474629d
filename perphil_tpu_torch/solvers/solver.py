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
                                            (f32 fast-diag, K1 residuals)
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
                                          the dense-band ILU apply
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
    preset's inner tolerances, inside it -> K8 (inner ILU-PCG)
  - gmres otherwise                      -> ``krylov.gmres`` (K1 matvec,
                                            ``_monolithic_pc``)
  - cg                                   -> ``krylov.cg`` (K1 matvec)

The host preconditioners follow the JAX package's native-f64 route: f64
fast-diag exact blocks, literal inner Krylov solves, ``StructuredILU0``
(its kernel on the card). The RHS lift is K1 in lift mode. Every other
option path raises ``NotImplementedError`` naming the ROADMAP slice that
ports it.

Picard (``solve_dpp_nonlinear``; ``snes_type``, the JAX package's native-f64
solves), from the BC lift, stopping on ``||F|| <= max(snes_rtol ||F0||,
snes_atol)`` or ``snes_max_it``:

  - ngs on quad meshes, the pinned-colouring multicolour sweep inside the
    kernel's plan                        -> ``fused_ngs`` (one launch)
  - ngs on quad meshes beyond it         -> ``ngs_host_loop`` (K1 residuals)
  - ngs on tri/hex/tet meshes            -> ``GaussSeidelSweeper`` (one
                                            ``structured_ilu_apply[gs]`` and
                                            one K1 residual an iteration)
  - block_gs                             -> exact alternating field solves
  - nrichardson                          -> damped Richardson with
                                            ``_monolithic_pc`` (the JAX
                                            package's documented deviation)
  - ksponly                              -> one linear solve, then the true
                                            residual norm; iteration 1

Solvers are cached on ``(W, params, frozen options)``; ``W`` carries the
device. No builder reads the environment.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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
from perphil_tpu_torch.ops.bandsolve import band_plan, build_band_parity_ilu, factor_bandwidth
from perphil_tpu_torch.ops.direct import FastDiagFieldSolver, LumpedDPPPreconditioner
from perphil_tpu_torch.ops.fused_direct import (
    fused_direct_solve,
    fused_direct_supported,
    fused_simplicial_direct_solve,
    fused_simplicial_direct_supported,
)
from perphil_tpu_torch.ops.fused_gmres import (
    EF64_MAX_DOF,
    K5,
    MAX_RESTART,
    ROLES,
    FusedGMRESSolver,
    fused_gmres_supported,
)
from perphil_tpu_torch.ops.fused_ngs import FusedNGSSolver, ngs_host_loop, picard_loop
from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper, GaussSeidelSweeper, StructuredILU0
from perphil_tpu_torch.ops.krylov import _norm, cg, gmres
from perphil_tpu_torch.ops.mixed import MixedPrecisionDPPDirect
from perphil_tpu_torch.ops.ordering import parity_system
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


def _field_pc(fop: FieldOperator, pc_type: str) -> Optional[Callable]:
    """A fieldsplit block's preconditioner: none, jacobi, lu/cholesky or
    ilu (``StructuredILU0``: the kernel on the card, the sweep on the CPU)."""
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
        return StructuredILU0.for_field(fop).apply_grid
    raise ValueError(f"Unsupported block pc_type: {pc_type!r}")


def _block_solver(fop: FieldOperator, sub: Dict[str, object]) -> Callable:
    """Grid -> grid solver of one fieldsplit block from its sub-options
    (``ksp_type`` preonly, gmres or cg; the JAX package's f64 route)."""
    ksp = str(sub.get("ksp_type", "preonly"))
    pc_type = str(sub.get("pc_type", "ilu"))
    if ksp == "preonly":
        if pc_type in ("lu", "cholesky"):
            return _exact_field_solver(fop)
        pc = _field_pc(fop, pc_type)
        return pc if pc is not None else (lambda r: r)
    if ksp not in ("gmres", "cg"):
        raise ValueError(f"Unsupported block ksp_type: {ksp!r}")
    kw = dict(
        rtol=float(sub.get("ksp_rtol", 1e-5)),
        atol=float(sub.get("ksp_atol", 1e-50)),
        max_it=int(sub.get("ksp_max_it", 10000)),
    )
    pc = _field_pc(fop, pc_type)
    if ksp == "cg":
        return lambda b: cg(fop.matvec, b, M_inv=pc, **kw)[0]
    restart = int(sub.get("ksp_gmres_restart", 30))
    return lambda b: gmres(fop.matvec, b, restart=restart, M_inv=pc, **kw).x


def _fieldsplit_pc(op: DPPOperator, flat: Dict[str, object]) -> Callable:
    """The 2x2 fieldsplit: multiplicative (block Gauss-Seidel,
    ``y2 = B1(r2 - C y1)``) or additive (block Jacobi)."""
    fs_type = str(flat.get("pc_fieldsplit_type", "multiplicative"))
    if fs_type not in ("multiplicative", "additive"):
        raise ValueError(f"Unsupported pc_fieldsplit_type: {fs_type!r}")
    p = op.params
    B0 = _block_solver(FieldOperator(op.W.sub(0), p.k1, p.beta, p.mu), _sub_options(flat, "fieldsplit_0_"))
    B1 = _block_solver(FieldOperator(op.W.sub(1), p.k2, p.beta, p.mu), _sub_options(flat, "fieldsplit_1_"))
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
        return StructuredILU0.for_monolithic(op.mesh, op.params, op.W.device).apply_grid
    if pc_type == "fieldsplit":
        return _fieldsplit_pc(op, flat)
    raise ValueError(f"Unsupported pc_type: {pc_type!r}")


def _fused_pc(flat: Dict[str, object]) -> Optional[str]:
    """The fused GMRES kernel's preconditioner for these options, by the
    JAX package's accelerator predicates (``_build_linear_solver_df``), or
    None where the kernel has no such role."""
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

    if all(block(i, "ilu") == ("gmres", "ilu") for i in (0, 1)) and all(
        float(flat.get(f"fieldsplit_{i}_ksp_{k}", d)) == d
        for i in (0, 1)
        for k, d in (("rtol", 1e-8), ("atol", 1e-12))
    ):
        return "fieldsplit_ilu"  # the inner tolerances are the kernel's own
    if all(block(i, "lu") in (("preonly", "lu"), ("preonly", "cholesky")) for i in (0, 1)):
        return "fieldsplit_lu"
    return None


def _krylov_kind(op: DPPOperator, flat: Dict[str, object]) -> str:
    """Which solver serves a Krylov solve, as the JAX package's accelerator
    route picks it: a fused GMRES role (K4-K8), or ``"gmres"`` / ``"cg"``
    (host loops with the K1 matvec and ``_monolithic_pc``)."""
    ksp = str(flat.get("ksp_type", "gmres"))
    pc = _fused_pc(flat)
    restart = int(flat.get("ksp_gmres_restart", 30))
    if ksp == "gmres" and restart <= MAX_RESTART and pc is not None and fused_gmres_supported(op, pc, restart):
        return K5 if pc == "none" and op.W.dim() <= EF64_MAX_DOF else ROLES[pc]
    return ksp


def _krylov_route(op: DPPOperator, flat: Dict[str, object]) -> Callable:
    """The Krylov solve of ``A d = r`` from ``d = 0``,
    ``r -> (d, iterations, residual_norm)``."""
    kind = _krylov_kind(op, flat)
    kw = dict(
        rtol=float(flat.get("ksp_rtol", 1e-5)),
        atol=float(flat.get("ksp_atol", 1e-50)),
        max_it=int(flat.get("ksp_max_it", 10000)),
    )
    if kind not in ("gmres", "cg"):
        run = FusedGMRESSolver(op, _fused_pc(flat), kind, restart=int(flat.get("ksp_gmres_restart", 30)), **kw)
    else:
        mv = op.stacked_matvec()
        pc = _monolithic_pc(op, flat)
        if kind == "cg":
            return lambda r: cg(mv, r, M_inv=pc, **kw)
        kw["restart"] = int(flat.get("ksp_gmres_restart", 30))

        def run(r: torch.Tensor):
            return gmres(mv, r, M_inv=pc, **kw)

    def solve(r: torch.Tensor):
        res = run(r)
        return res.x, res.iterations, res.residual_norm

    return solve


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


def _free_device_bytes(device: torch.device) -> Optional[int]:
    """The card's free memory in bytes, or None where no card memory is
    used (the CPU)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


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
            f"the band engine needs {need_bytes} bytes of device memory (packed blocks and build workspace), "
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
    the band blocks are f64, so the JAX package's double-float correction of
    its f32 blocks has nothing to correct."""
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
        nv = mesh.num_vertices
        _check_band_memory(band_plan(nv, factor_bandwidth(Fc, nv), mesh.dim).total_bytes,
                           _free_device_bytes(W.device))
        solve = _build_band_parity_ilu_solver(op, perm, Fc, kw)
    else:
        solve = _build_host_parity_ilu_solver(op, A, perm, Ap, kw)
    solve.engine = engine
    return solve


def _build_band_parity_ilu_solver(op: DPPOperator, perm, Fc, kw: Dict[str, object]) -> Callable:
    """The band engine: GMRES (``ops/krylov.py::gmres``, the host loop; K1
    matvecs on the card) on the Newton-step system ``A d = b - A x0``, left
    preconditioned by the dense-band block ILU apply
    (``ops/bandsolve.py::BandParityILU``, ``band_trisolve`` on the card)."""
    band = build_band_parity_ilu(Fc, perm, op.mesh.num_vertices, op.grid_shape, op.W.device)
    mv = op.stacked_matvec()

    def krylov(r: torch.Tensor):
        res = gmres(mv, r, M_inv=band.apply, **kw)
        return res.x, res.iterations, res.residual_norm

    return _newton_step_solver(op, krylov)


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
) -> Callable:
    """Build a linear solve ``(g1, g2) -> (z1, z2, its, rnorm)`` for
    boundary-value grids g1, g2."""
    flat = dict(frozen_sp)
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
        raise NotImplementedError(
            "the chunked continuation (_x0_continuation) is ported in ROADMAP slice 10 "
            "(experiments and tooling)"
        )
    return _newton_step_solver(op, _krylov_route(op, flat))


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
    solver = _build_linear_solver(W, model_params, _freeze(solver_parameters))
    z1, z2, its, rnorm = solver(g1, g2)
    return Solution(Function(W, (z1, z2)), int(its), float(rnorm))


def _ngs_sweeper(mesh, params: DPPParameters, device) -> Union[ColoredNGSSweeper, GaussSeidelSweeper]:
    """The SNES ngs sweep: the pinned-colouring multicolour sweeper on quad
    meshes (the reference's exact Picard counts), the lexicographic
    Gauss-Seidel sweeper elsewhere."""
    if mesh.element == "quad":
        return ColoredNGSSweeper(mesh, params, device)
    return GaussSeidelSweeper.for_monolithic(mesh, params, device)


@lru_cache(maxsize=64)
def _build_nonlinear_solver(
    W: MixedFunctionSpace,
    params: DPPParameters,
    frozen_sp: Tuple,
) -> Callable:
    """Build a Picard solve ``(g1, g2) -> (z1, z2, its, fnorm)`` for
    boundary-value grids g1, g2 (``snes_type`` ngs, block_gs, nrichardson)."""
    flat = dict(frozen_sp)
    if flat.get("_x0_continuation"):
        raise NotImplementedError(
            "the chunked continuation (_x0_continuation) is ported in ROADMAP slice 10 "
            "(experiments and tooling)"
        )
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
        sweeper = _ngs_sweeper(mesh, params, W.device)
        if isinstance(sweeper, ColoredNGSSweeper):
            fused = FusedNGSSolver(op, sweeper, rtol, atol, max_it)

            def solve_colored(g1: torch.Tensor, g2: torch.Tensor):
                b, x0 = lift(g1, g2)
                if W.device.type == "cuda" and fused.plan is None:
                    res = ngs_host_loop(op, sweeper, b, x0, rtol, atol, max_it)
                else:
                    res = fused(b, x0)
                return res.x[0], res.x[1], res.iterations, res.residual_norm

            return solve_colored
        mv = op.flat_matvec()

        def solve_lexicographic(g1: torch.Tensor, g2: torch.Tensor):
            b, x0 = (t.reshape(-1) for t in lift(g1, g2))
            res = picard_loop(lambda x, r: sweeper.sweep(x, b), lambda x: b - mv(x), x0, rtol, atol, max_it)
            x = res.x.reshape((2,) + tuple(mesh.node_shape))
            return x[0], x[1], res.iterations, res.residual_norm

        return solve_lexicographic

    mv = op.stacked_matvec()
    if snes == "block_gs":
        # exact alternating field solves: the fixed-stress split the delayed
        # form encodes
        p = params
        B0 = _block_solver(FieldOperator(W.sub(0), p.k1, p.beta, p.mu), _sub_options(flat, "fieldsplit_0_"))
        B1 = _block_solver(FieldOperator(W.sub(1), p.k2, p.beta, p.mu), _sub_options(flat, "fieldsplit_1_"))
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
    if str(flat.get("snes_type", "ngs")) == "ksponly":
        # PETSc semantics: SNESKSPONLY reports iteration 1 and the true
        # residual norm after the one linear solve, not the KSP's
        ksp_opts = {k: v for k, v in flat.items() if not k.startswith("snes_")}
        z1, z2, _, _ = _build_linear_solver(W, model_params, _freeze(ksp_opts))(g1, g2)
        op = DPPOperator(W, model_params)
        b1, b2 = op.lifted_rhs(g1, g2)
        return Solution(Function(W, (z1, z2)), 1, float(_norm(torch.stack(op.residual(z1, z2, b1, b2)))))
    solver = _build_nonlinear_solver(W, model_params, _freeze(solver_parameters))
    z1, z2, its, fnorm = solver(g1, g2)
    return Solution(Function(W, (z1, z2)), int(its), float(fnorm))
