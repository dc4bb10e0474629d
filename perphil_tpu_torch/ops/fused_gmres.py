"""K4-K8: the whole restarted GMRES(m) solve in one kernel launch, on small
meshes, with the preconditioner inside the kernel.

Counterpart of ``perphil_tpu/ops/pallas_gmres.py``:

  - **K4** :func:`fused_gmres_df` with pc ``none`` or ``jacobi``, the TPU's
    double-float cycle kernel;
  - **K5** :func:`fused_gmres_ef64`, the TPU's f64-faithful kernel for
    unpreconditioned systems of at most 512 DoF;
  - **K6** pc ``fieldsplit_lu``: the multiplicative 2x2 fieldsplit whose
    blocks are inner PCGs to 1e-13 with a fast-diag preconditioner (the
    consistent eigenbasis on quad/hex meshes, the lumped one on tri/tet);
  - **K7** pc ``ilu``: monolithic ILU(0) as wavefront sweeps;
  - **K8** pc ``fieldsplit_ilu``: K6's frame whose blocks are each field's
    own solve, GMRES(30) left-preconditioned by the field's ILU(0) to
    1e-8 / 1e-12 (``inner_ksp="literal"``, the default), or the TPU kernel's
    ILU(0)-PCG at those tolerances (``inner_ksp="pcg"``).

K6-K8 are ``pc_type`` branches of the TPU's one cycle kernel
(``_build_cycle``); here all five roles run one native-f64 kernel,
``csrc/fused_gmres.cu``, whose arithmetic is :func:`krylov.gmres` with the
plain matvec (``fused_dpp_apply_plain``) and the preconditioner of
:meth:`FusedGMRESSolver.plain`. A launch counts under the role's name
(:data:`ROLES`). Vectors are stacked ``(2, *node_shape)`` f64 tensors.

The fieldsplit roles' inner block solves run on every block of the
kernel's cluster, their dots on the cluster tree (bit-equal to
:func:`krylov.tree_sum`); K8's ILU(0) sweeps run on its first block (2D
fields: a line pipeline, ``csrc/field_sweep.cuh``, planned by
:func:`ilu.line_plan`; 3D fields: the ring of ``csrc/ilu_sweep.cuh``), K6's
fast-diag transform is spread over the blocks.

  - K6 and K8's ``"pcg"`` mode: the TPU kernel's PCG from zero, ``z0 = M
    rhs``, stopping on ``||r|| <= max(rtol ||rhs||, atol)`` or a non-finite
    norm (``pallas_gmres.py:1416-1474``). It stands in for the presets'
    inner ``preonly`` + LU (K6, to 1e-13) and GMRES + ILU (K8, at matched
    tolerances); the outer count is 4 either way.
  - K8's ``"literal"`` mode: :func:`krylov.gmres` itself on the field's
    operator with its ILU(0) (:data:`INNER_TOLS`: rtol, atol, max_it,
    restart), what the JAX package's native-f64 route runs
    (``_block_solver``). Its basis, (restart + 1) n values, and each block's
    Givens state live in device scratch behind the frame's
    (:func:`work_doubles`), so the shared-memory plan is the PCG mode's.

The envelope is what the launcher can place (``plan_geometry`` in
``csrc/fused_gmres_kernel.cuh``), mirrored on the host by
:func:`fused_gmres_plan`: at most 32 leaves a thread on a cluster of 16
blocks of 512 threads (262,144 values, :func:`launch_geometry`), and for the
fieldsplit roles their slices and K6's line buffers within the dynamic
shared memory every launch plans with (:data:`SMEM_BUDGET`, the header's
``kGmresSmemBudget``: the H100's 227 KB a block less the kernel's static
shared memory). The basis, the matvec's input copy and the ILU sweep's z go
to device memory where shared memory is short, so they bound nothing. The
routing is decided once, on the host, by this gate; a launch the launcher
refuses raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator, FieldOperator, coupling_apply, dpp_stencils
from perphil_tpu_torch.ops.direct import FastDiagFieldSolver
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain, pack_weights
from perphil_tpu_torch.ops.fused_direct import _check_device, _grid_args
from perphil_tpu_torch.ops.ilu import (
    IluPlan, StructuredILU0, build_field_system, ilu_plan, line_plan, schedule_shape,
)
from perphil_tpu_torch.ops.krylov import DEFAULT_DTOL, KrylovResult, gmres, tree_sum
from perphil_tpu_torch.ops.stencil import compile_stencils

K4 = "fused_gmres_df"
K5 = "fused_gmres_ef64"
K6 = "fused_gmres_df[fieldsplit_lu]"
K7 = "fused_gmres_df[ilu]"
K8 = "fused_gmres_df[fieldsplit_ilu]"
PC_KINDS = {"none": 0, "jacobi": 1, "fieldsplit_lu": 2, "ilu": 3, "fieldsplit_ilu": 4}
#: the role (launch-count name) of each preconditioner; K5 is pc none's
#: other role
ROLES = {"none": K4, "jacobi": K4, "fieldsplit_lu": K6, "ilu": K7, "fieldsplit_ilu": K8}
#: the fieldsplit roles' inner block solve (rtol, atol, max_it, restart): K6's
#: PCG (``pallas_gmres.py:1414``; no restart), K8's GMRES(30) + ILU(0) at the
#: preset's block options (``FIELDSPLIT_GMRES_ILU_PARAMS``; its ``"pcg"``
#: mode runs PCG at the same rtol, atol and max_it, ``pallas_gmres.py:1402``)
INNER_TOLS = {"fieldsplit_lu": (1e-13, 0.0, 1000, 0), "fieldsplit_ilu": (1e-8, 1e-12, 50000, 30)}
#: K8's inner block solves: the blocks' own GMRES + ILU, or the TPU's PCG
INNER_KSP = ("literal", "pcg")
#: the kernel keeps the m + 1 <= 32 basis rows' coefficients in shared memory
MAX_RESTART = 31
#: systems the K5 role serves (pc none): at most this many DoF
EF64_MAX_DOF = 512

#: dynamic shared memory every launch plans with, in bytes (the launcher's
#: ``kGmresSmemBudget``, read from its header)
SMEM_BUDGET = _cuda.header_constant("fused_gmres.cuh", "kGmresSmemBudget")
#: shared memory of one block, static and dynamic, in bytes (the H100's 227 KB)
MAX_SMEM_PER_BLOCK = _cuda.header_constant("ilu_sweep.cuh", "kMaxSmemPerBlock")
_WORK_PER_NODE = 10  # f64 scratch per node for pc >= 2 (the kernel's layout)
#: f64 of one block's inner GMRES Givens state (``kInnerStateDoubles``)
INNER_STATE_DOUBLES = _cuda.header_constant("fused_gmres.cuh", "kInnerStateDoubles")
_XCHG_DOUBLES = 4096  # the reductions' exchange between blocks (two regions)
_THREADS = 512  # threads of a block
#: doubles of a launch's result (``csrc/fused_gmres.cuh::kResultSlots``)
RESULT_SLOTS = _cuda.header_constant("fused_gmres.cuh", "kResultSlots")
#: blocks of one thread block cluster at most (the card's non-portable size)
MAX_BLOCKS = 16
#: leaves of a reduction tree a thread may own (``csrc/fused_gmres.cuh``)
MAX_LEAVES = 32


def static_smem(pc_type: str, dim: int) -> int:
    """The static shared memory of ``pc_type``'s kernel in ``dim``
    dimensions, in bytes, from the built library (the card's runtime): the
    launcher refuses a kernel that leaves less than :data:`SMEM_BUDGET` of
    :data:`MAX_SMEM_PER_BLOCK`."""
    nbytes = _cuda.library().perphil_fused_gmres_static_smem(PC_KINDS[pc_type], dim)
    if nbytes < 0:
        raise RuntimeError(f"no static shared memory for pc {pc_type!r} in {dim}D ({nbytes})")
    return nbytes


class LaunchGeometry(NamedTuple):
    """How one launch spreads ``2n`` values: ``blocks`` of 512 threads in
    one cluster, ``leaves`` values a thread."""

    blocks: int
    leaves: int


def launch_geometry(num_values: int) -> LaunchGeometry:
    """The launcher's choice (``csrc/fused_gmres.cuh::gmres_blocks``) for
    vectors of ``num_values`` f64: pad to ``Lt``, the power of two that is
    at least 512 and ``num_values``; take ``min(16, Lt / 512)`` blocks; a
    thread owns ``Lt / (512 blocks)`` leaves. Raises where that exceeds the
    kernel's per-thread tree."""
    if num_values < 1:
        raise ValueError("num_values must be positive")
    padded = max(_THREADS, _next_pow2(num_values))
    blocks = min(MAX_BLOCKS, padded // _THREADS)
    leaves = padded // (_THREADS * blocks)
    if leaves > MAX_LEAVES:
        raise ValueError(f"{num_values} values on {blocks} blocks: {leaves} leaves a thread, at most {MAX_LEAVES}")
    return LaunchGeometry(blocks, leaves)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class KernelGeometry(NamedTuple):
    """What a launch ran with: blocks of the cluster, and what lived in
    shared memory (the basis slice, the ILU sweep's z, the matvec's input
    copy, the inner PCG's copy of p and K6's eigenbases), within
    :data:`SMEM_BUDGET`; K8's line pipeline's warps (0: the ring, or no
    field sweep)."""

    blocks: int
    basis_smem: bool
    ilu_z_smem: bool
    input_smem: bool
    p_smem: bool
    s_smem: bool
    line_warps: int = 0


class SmemPlan(NamedTuple):
    """The launcher's use of dynamic shared memory (``plan_geometry`` in
    ``csrc/fused_gmres_kernel.cuh``), in bytes and flags."""

    ilu: Optional[IluPlan]
    input_smem: bool
    p_smem: bool
    s_smem: bool
    pc_bytes: int
    basis_smem: bool
    bytes: int
    line_warps: int = 0


def _slice_len(num_values: int, blocks: int) -> int:
    piece = 4 * blocks
    return 4 * (num_values // piece) + min(num_values % piece, 4)


def plan_smem(
    node_shape: Tuple[int, ...], pc_type: str, budget: int, restart: int = 30,
    ilu_shape: Optional[Tuple[int, int, int, int]] = None, distinct: Optional[Tuple[bool, ...]] = None,
) -> SmemPlan:
    """Mirror of the launcher's plan for ``budget`` bytes: the fieldsplit
    roles' slices (5 vectors of a block's share of one field) and K6's two
    line buffers come first and must fit; then the ILU stage (``ilu_shape``:
    nlow, nup, levels, rows of the widest level; K8 on a 2D field the line
    pipeline's edge lines and rings instead, :func:`ilu.line_plan`, with
    ``ilu`` None, where they fit beside the slices);
    the matvec's input copy
    (2n doubles), and in the same region the inner PCG's copy of p (n
    doubles) and K6's eigenbases (x first; ``distinct[a]``: axis a's matrix
    equals no earlier one's, by default where its length is new); then the
    basis slice."""
    n = int(np.prod(node_shape))
    L, blocks = 2 * n, launch_geometry(2 * n).blocks
    fields = pc_type.startswith("fieldsplit")
    pc_min = 5 * 8 * _slice_len(n, blocks) if fields else 0
    sbytes = 0
    if pc_type == "fieldsplit_lu":
        axes = [m - 2 for m in reversed(node_shape)]  # x first
        nint = int(np.prod(axes))
        lines = max(-(-(nint // m) // blocks) for m in axes)
        pc_min += 16 * lines * max(axes)
        if distinct is None:
            distinct = tuple(m not in axes[:a] for a, m in enumerate(axes))
        sbytes = sum(8 * m * m for m, new in zip(axes, distinct) if new)
    ilu, used, lines = None, 0, None
    if pc_type == "fieldsplit_ilu":
        lines = line_plan(tuple(node_shape))
        if lines is not None and lines.bytes + (pc_min + 15) // 16 * 16 > budget:
            lines = None  # the pipeline's rings leave the slices no room: the ring sweep, which shrinks to fit
    if lines is not None:
        used = lines.bytes
    elif pc_type in ("ilu", "fieldsplit_ilu"):
        nlow, nup, nlev, max_rows = ilu_shape
        ilu = ilu_plan(nlow, nup, L if pc_type == "ilu" else n, nlev, max_rows, budget - pc_min)
        used = ilu.bytes
    pc_min = (pc_min + 15) // 16 * 16
    if used + pc_min > budget:
        raise ValueError("the fieldsplit roles' slices do not fit")
    x = pc_min

    def grow(need: int) -> bool:
        nonlocal x
        need = (need + 15) // 16 * 16
        if used + max(x, need) > budget:
            return False
        x = max(x, need)
        return True

    input_smem = grow(8 * L)
    p_smem = fields and grow(pc_min + 8 * n)
    s_smem = pc_type == "fieldsplit_lu" and grow(pc_min + sbytes)
    used += x
    basis = used + (restart + 1) * 8 * _slice_len(L, blocks) <= budget
    return SmemPlan(ilu, input_smem, p_smem, s_smem, x, basis,
                    used + (restart + 1) * 8 * _slice_len(L, blocks) * basis, 0 if lines is None else lines.warps)


def fused_gmres_plan(node_shape: Tuple[int, ...], pc_type: str, restart: int = 30) -> Optional[SmemPlan]:
    """The launcher's plan for ``pc_type`` on a grid of ``node_shape`` nodes
    (``plan_geometry`` at :data:`SMEM_BUDGET`), or None where the launcher
    refuses it: more than :data:`MAX_LEAVES` leaves a thread, or the
    fieldsplit roles' slices and K6's line buffers beyond the budget. The ILU
    roles' schedule comes from the shape (:func:`ilu.schedule_shape`), with
    the offset counts each role's sweeps are built for."""
    if pc_type not in PC_KINDS or len(node_shape) not in (2, 3):
        return None
    try:
        launch_geometry(2 * int(np.prod(node_shape)))
        ilu_shape = None
        if pc_type in ("ilu", "fieldsplit_ilu"):
            ilu_shape = schedule_shape(node_shape, 2 if pc_type == "ilu" else 1)
        return plan_smem(node_shape, pc_type, SMEM_BUDGET, restart, ilu_shape)
    except ValueError:
        return None


def fused_gmres_supported(op: DPPOperator, pc_type: str = "none", restart: int = 30) -> bool:
    """Whether the fused kernel covers this operator and preconditioner: the
    launcher can place it (:func:`fused_gmres_plan`)."""
    return fused_gmres_plan(tuple(op.mesh.node_shape), pc_type, restart) is not None


def work_doubles(n: int, blocks: int, inner_restart: int) -> int:
    """f64 of the kernel's scratch for a fieldsplit or ILU role on ``n``
    nodes (``PcData::work``): the frame's 10 n, then with a literal inner
    GMRES (``inner_restart`` > 0) its basis, ``(inner_restart + 1) n``, and
    each of the ``blocks`` blocks' Givens state."""
    extra = (inner_restart + 1) * n + blocks * INNER_STATE_DOUBLES if inner_restart else 0
    return _WORK_PER_NODE * n + extra


def _tree_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return tree_sum((u * v).reshape(-1))


class FusedGMRESSolver(nn.Module):
    """GMRES(``restart``) on ``A x = b`` from ``x0``, left-preconditioned
    by ``pc_type`` (a key of :data:`PC_KINDS`), the whole solve in one
    launch. ``role`` is the name a launch counts under: ``ROLES[pc_type]``
    by default, or K5 for pc none. ``inner_ksp`` (:data:`INNER_KSP`): K8's
    block solves, the blocks' own GMRES + ILU (``"literal"``) or the TPU
    kernel's PCG (``"pcg"``); K6's are PCG either way.

    Buffers, by preconditioner: ``dinv`` (jacobi), the inverse diagonal of
    the BC-eliminated operator; ``ilu`` (ilu), the monolithic
    ``StructuredILU0``; ``field_ilu`` (fieldsplit_ilu), one per field on a
    shared level schedule; ``field_fd`` (fieldsplit_lu), the per-field
    ``FastDiagFieldSolver`` (1D eigenbases, mode scales ``sc``).
    """

    def __init__(
        self,
        op: DPPOperator,
        pc_type: str = "none",
        role: Optional[str] = None,
        rtol: float = 1.0e-5,
        atol: float = 1.0e-50,
        max_it: int = 10000,
        restart: int = 30,
        dtol: float = DEFAULT_DTOL,
        inner_ksp: str = "literal",
    ):
        super().__init__()
        if inner_ksp not in INNER_KSP:
            raise ValueError(f"inner_ksp {inner_ksp!r} is not one of {INNER_KSP}")
        if pc_type not in PC_KINDS:
            raise ValueError(f"pc_type {pc_type!r} is not one of {sorted(PC_KINDS)}")
        role = ROLES[pc_type] if role is None else role
        if role != ROLES[pc_type] and not (role == K5 and pc_type == "none"):
            raise ValueError(f"role {role!r} with pc_type={pc_type!r}: K5 runs pc none only")
        if not 1 <= restart <= MAX_RESTART:
            raise ValueError(f"restart {restart} outside 1..{MAX_RESTART}")
        if not fused_gmres_supported(op, pc_type, restart):
            raise ValueError(f"mesh {op.mesh} with pc_type={pc_type!r} is outside the fused GMRES envelope")
        mesh, p = op.mesh, op.params
        self.node_shape = tuple(mesh.node_shape)
        self.device = op.W.device
        self.pc_type, self.role, self.inner_ksp = pc_type, role, inner_ksp
        self.rtol, self.atol, self.dtol = float(rtol), float(atol), float(dtol)
        self.max_it, self.restart = int(max_it), int(restart)
        self.inner_solves = self.inner_iterations = 0
        #: the last launch's inner block solves (iterations, solves): the
        #: fieldsplit roles
        self.launch_inner: Tuple[int, int] = (0, 0)
        #: what the last launch ran with (:class:`KernelGeometry`)
        self.last_geometry: Optional[KernelGeometry] = None
        self.stencils = dpp_stencils(mesh, p)
        dinv = None
        if pc_type == "jacobi":
            dinv = (1.0 / op.diagonal()).reshape((2,) + self.node_shape).contiguous()
        self.register_buffer("dinv", dinv)
        self.ilu = StructuredILU0.for_monolithic(mesh, p, self.device) if pc_type == "ilu" else None
        self.field_ilu = self.field_fd = self.mass = None
        self.line_sweep = False
        self.coef = 0.0
        self.register_buffer("sc", None)
        if pc_type.startswith("fieldsplit"):
            ks = (p.k1, p.k2)
            self.field_ops = [FieldOperator(op.W.sub(f), ks[f], p.beta, p.mu) for f in (0, 1)]
            self.coupling = coupling_apply(mesh, p, self.device)
            self.coef = -(p.beta / p.mu)
            M_st = np.asarray(compile_stencils(mesh)[1], np.float64).ravel()
            self.mass = np.zeros(27)  # the kernel's layout: zero-padded to 27
            self.mass[: M_st.size] = M_st
            if pc_type == "fieldsplit_ilu":
                self.field_ilu = nn.ModuleList(
                    StructuredILU0(build_field_system(mesh, k, p.beta, p.mu), self.device) for k in ks
                )
                #: the field sweeps run as the line pipeline (the launcher's plan), on tables by row
                self.line_sweep = fused_gmres_plan(self.node_shape, pc_type, restart).line_warps > 0
                if self.line_sweep:
                    for ilu in self.field_ilu:
                        ilu.line_tables()
            else:
                self.field_fd = nn.ModuleList(
                    FastDiagFieldSolver(
                        mesh, k, p.beta, p.mu, lumped=not mesh.is_tensor_product, device=self.device
                    )
                    for k in ks
                )
                self.sc = torch.stack([fd.mode_scale.reshape(-1) for fd in self.field_fd]).contiguous()
                # equal eigenbases (a cube, a square) go to the kernel as one
                # pointer, which it copies to shared memory once
                mats = self.field_fd[0].mats
                first = [next(b for b in range(a + 1) if mats[b].shape == S.shape and torch.equal(mats[b], S))
                         for a, S in enumerate(mats)]
                self._axes = tuple(mats[first[a]].data_ptr() for a in (0, 1, len(mats) - 1))
                #: per axis (x first), whether its eigenbasis equals no earlier axis's
                self.distinct_axes = tuple(first[a] == a for a in range(len(mats)))

    # -- the plain twin ---------------------------------------------------

    def _inner_pc(self, f: int) -> Callable[[torch.Tensor], torch.Tensor]:
        if self.field_ilu is not None:
            return self.field_ilu[f].plain_grid
        return self.field_fd[f].solve

    def inner_tols(self) -> Tuple[float, float, int, int]:
        """The inner block solve's (rtol, atol, max_it, restart); restart 0
        is PCG (K6, K8's ``"pcg"`` mode), zeros for the other roles."""
        tols = INNER_TOLS.get(self.pc_type, (0.0, 0.0, 0, 0))
        return tols[:3] + (0,) if self.inner_ksp == "pcg" else tols

    def _inner_gmres(self, f: int, rhs: torch.Tensor) -> torch.Tensor:
        """K8's literal inner block solve: the field's own GMRES with its
        ILU(0) from zero, the JAX package's native ``_block_solver``."""
        rtol, atol, max_it, restart = self.inner_tols()
        res = gmres(
            self.field_ops[f].matvec, rhs, rtol=rtol, atol=atol, max_it=max_it,
            restart=restart, M_inv=self._inner_pc(f),
        )
        self.inner_iterations += res.iterations
        self.inner_solves += 1
        return res.x

    def _inner_pcg(self, f: int, rhs: torch.Tensor) -> torch.Tensor:
        """The TPU kernel's inner block solve (``pallas_gmres.py:1416-1474``)."""
        rtol, atol, max_it, _ = self.inner_tols()
        A, M = self.field_ops[f].matvec, self._inner_pc(f)
        rn0 = float(torch.sqrt(_tree_dot(rhs, rhs)))
        t_rel = rn0 * rtol
        tol = t_rel if t_rel > atol else atol
        z = M(rhs)
        rz = _tree_dot(z, rhs)
        x, r, p = torch.zeros_like(rhs), rhs, z
        done, its = not rn0 > tol, 0
        while not done and its < max_it:
            Ap = A(p)
            alpha = rz / _tree_dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = _tree_dot(z, r)
            beta = rz_new / rz
            p = z + beta * p
            rz = rz_new
            rn = float(torch.sqrt(_tree_dot(r, r)))
            its += 1
            done = not rn > tol or not np.isfinite(rn)
        self.inner_iterations += its
        self.inner_solves += 1
        return x

    def plain_pc(self) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        """The preconditioner the kernel applies, in plain PyTorch, on
        stacked ``(2, *node_shape)`` tensors (None for pc none)."""
        if self.pc_type == "none":
            return None
        if self.pc_type == "jacobi":
            dinv = self.dinv
            return lambda r: dinv * r
        if self.pc_type == "ilu":
            return lambda r: self.ilu.plain(r.reshape(-1)).reshape(r.shape)

        block = self._inner_gmres if self.inner_tols()[3] else self._inner_pcg

        def fieldsplit(v: torch.Tensor) -> torch.Tensor:
            y1 = block(0, v[0])
            return torch.stack([y1, block(1, v[1] - self.coupling(y1))])

        return fieldsplit

    def tolerances(self, tols: Optional[Tuple[float, float]] = None) -> Tuple[float, float]:
        """``(rtol, atol)`` of a call: ``tols`` where the caller gives them
        (the chunked continuation's ``(0, atol)``), else the solver's own."""
        return (self.rtol, self.atol) if tols is None else (float(tols[0]), float(tols[1]))

    def plain(
        self, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tols: Optional[Tuple[float, float]] = None
    ) -> KrylovResult:
        """Plain PyTorch twin: ``krylov.gmres`` with the plain matvec and
        :meth:`plain_pc`. Afterwards ``inner_solves`` and
        ``inner_iterations`` count the fieldsplit roles' inner block solves."""
        self.inner_solves = self.inner_iterations = 0
        rtol, atol = self.tolerances(tols)

        def mv(z: torch.Tensor) -> torch.Tensor:
            return torch.stack(fused_dpp_apply_plain(z[0], z[1], *self.stencils, mode="matvec"))

        return gmres(
            mv, b, x0, rtol=rtol, atol=atol, max_it=self.max_it,
            restart=self.restart, M_inv=self.plain_pc(), dtol=self.dtol,
        )

    # -- the kernel -------------------------------------------------------

    def _pc_args(self) -> Tuple:
        """The launcher's preconditioner pointers: dinv, the packed factor
        sides F0L, F0U, F1L, F1U, the sides by row L0L, L0U, L1L, L1U (K8's
        line pipeline; null where the field keeps the ring), level_ptr,
        level_rows, offset table (host), Sx, Sy, Sz, sc; then noffs, nlev
        and the rows of the widest level."""
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        first = second = sched = None
        if self.ilu is not None:
            first = sched = self.ilu
        elif self.field_ilu is not None:
            first, second = self.field_ilu
            sched = first
        packed = [
            None if f is None else side
            for f in (first, second)
            for side in ((None, None) if f is None else (f.packed_lower, f.packed_upper))
        ]
        lines = [None] * 4
        if self.field_ilu is not None and self.line_sweep:
            lines = [t.data_ptr() for f in self.field_ilu for t in f.line_tables()]
        axes = (None, None, None) if self.field_fd is None else self._axes
        return (
            ptr(self.dinv), *(ptr(t) for t in packed), *lines,
            None if sched is None else sched.level_ptr.data_ptr(),
            None if sched is None else sched.level_rows.data_ptr(),
            None if sched is None else sched.meta.ctypes.data,
            *axes, ptr(self.sc),
            0 if sched is None else len(sched.deltas),
            0 if sched is None else sched.num_levels,
            0 if sched is None else sched.max_level_rows,
        )

    def launch_args(
        self, b: torch.Tensor, x0: Optional[torch.Tensor], result: torch.Tensor,
        tols: Optional[Tuple[float, float]] = None,
    ) -> Tuple[tuple, torch.Tensor]:
        """The launcher's arguments (all but the stream) for stacked
        ``(2, *node_shape)`` f64 CUDA tensors, and the output ``x``; the
        scratch they point to lives as long as the returned tuple. ``tols``:
        the call's ``(rtol, atol)`` (:meth:`tolerances`)."""
        if x0 is None:
            x0 = torch.zeros_like(b)
        shape = (2,) + self.node_shape
        for name, t in (("b", b), ("x0", x0)):
            _cuda.require_cuda_tensor(t, name, torch.float64, self.device)
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        x = torch.empty_like(b)
        basis = torch.empty((self.restart + 1) * b.numel(), dtype=torch.float64, device=b.device)
        rtol_in, atol_in, max_in, restart_in = self.inner_tols()
        work = None
        if PC_KINDS[self.pc_type] >= 2:
            blocks = launch_geometry(b.numel()).blocks
            work = torch.empty(work_doubles(b[0].numel(), blocks, restart_in), dtype=torch.float64, device=b.device)
        xchg = torch.empty(_XCHG_DOUBLES, dtype=torch.float64, device=b.device)
        w = pack_weights(*self.stencils)
        (dinv, F0L, F0U, F1L, F1U, L0L, L0U, L1L, L1U, lptr, lrows, meta, Sx, Sy, Sz, sc, noffs, nlev,
         max_rows) = self._pc_args()
        args = (
            b.data_ptr(), x0.data_ptr(), x.data_ptr(), basis.data_ptr(),
            None if work is None else work.data_ptr(), xchg.data_ptr(), result.data_ptr(),
            w.ctypes.data,
            None if self.mass is None else self.mass.ctypes.data, dinv, F0L, F0U, F1L, F1U, L0L, L0U, L1L, L1U,
            lptr, lrows, meta,
            Sx, Sy, Sz, sc, *_grid_args(self.node_shape), PC_KINDS[self.pc_type], noffs, nlev,
            *self.tolerances(tols), self.dtol, self.max_it, self.restart,
            self.coef, rtol_in, atol_in, max_in, restart_in, DEFAULT_DTOL, max_rows,
        )
        return (args, (x0, basis, work, xchg, w)), x

    def launch(
        self, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tols: Optional[Tuple[float, float]] = None
    ) -> KrylovResult:
        """Run the kernel on stacked ``(2, *node_shape)`` f64 CUDA tensors;
        reads the iteration count and residual norm back."""
        result = torch.empty(RESULT_SLOTS, dtype=torch.float64, device=b.device)
        (args, _keep), x = self.launch_args(b, x0, result, tols)
        _cuda.launch(self.role, "perphil_fused_gmres", b.device, *args)
        return self.read_result(x, result)

    def read_result(self, x: torch.Tensor, result: torch.Tensor) -> KrylovResult:
        """The solve's outcome from a launch's ``result``; sets
        ``last_geometry``."""
        its, rnorm, converged, *geo, inner_its, inner_solves, line_warps = result[:RESULT_SLOTS].tolist()
        self.last_geometry = KernelGeometry(int(geo[0]), *(bool(v) for v in geo[1:6]), int(line_warps))
        self.launch_inner = (int(inner_its), int(inner_solves))
        return KrylovResult(x, int(its), rnorm, bool(converged))

    def forward(
        self, b: torch.Tensor, x0: Optional[torch.Tensor] = None, tols: Optional[Tuple[float, float]] = None
    ) -> KrylovResult:
        _check_device(self.device, b)
        return self.plain(b, x0, tols) if b.device.type == "cpu" else self.launch(b, x0, tols)


def k8_probe_library(define: str = "PERPHIL_K8_PROBE"):
    """K8 as it stood before its 2D field sweeps became a line pipeline:
    ``csrc/profile/fused_gmres_k8_ring.cu`` built alone, every field sweep on
    the ring with the ring's plan; with ``define``
    ``PERPHIL_K8_LINE_SLOTS=k`` instead the pipeline with k lines a lane.
    Its launcher ``perphil_fused_gmres_k8_probe`` takes
    ``perphil_fused_gmres``'s arguments (pc fieldsplit_ilu only); its
    launches are counted nowhere (:func:`launch_k8_probe`)."""
    return _cuda.variant_library(
        "profile/fused_gmres_k8_ring.cu", define,
        {"perphil_fused_gmres_k8_probe": _cuda._SIGNATURES["perphil_fused_gmres"]},
    )


def launch_k8_probe(solver: FusedGMRESSolver, dll, b: torch.Tensor, x0: Optional[torch.Tensor] = None) -> KrylovResult:
    """One solve of ``solver`` (pc fieldsplit_ilu) on the probe ``dll``
    (:func:`k8_probe_library`); sets ``solver.last_geometry`` and
    ``launch_inner`` as :meth:`FusedGMRESSolver.launch` does, counts
    nothing."""
    if solver.pc_type != "fieldsplit_ilu":
        raise ValueError("the K8 probe runs pc fieldsplit_ilu only")
    result = torch.empty(RESULT_SLOTS, dtype=torch.float64, device=b.device)
    (args, _keep), x = solver.launch_args(b, x0, result)
    err = dll.perphil_fused_gmres_k8_probe(*args, torch.cuda.current_stream(b.device).cuda_stream)
    _cuda.check(err, "perphil_fused_gmres_k8_probe")
    return solver.read_result(x, result)


def fused_gmres_df(
    op: DPPOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    dtol: float = DEFAULT_DTOL,
    pc_type: str = "none",
) -> KrylovResult:
    """K4 (pc none/jacobi), K6, K7 or K8 (by ``pc_type``) in one launch."""
    return FusedGMRESSolver(op, pc_type, None, rtol, atol, max_it, restart, dtol)(b, x0)


def fused_gmres_ef64(
    op: DPPOperator,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    dtol: float = DEFAULT_DTOL,
) -> KrylovResult:
    """K5: unpreconditioned GMRES in one launch (the JAX package's
    f64-faithful parity mode; here native f64, the same kernel as K4)."""
    return FusedGMRESSolver(op, "none", K5, rtol, atol, max_it, restart, dtol)(b, x0)
