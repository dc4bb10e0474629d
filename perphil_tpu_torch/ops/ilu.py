"""Structured ILU(0) and Gauss-Seidel: wavefront sweeps and parallel-prefix trisolves.

Counterpart of ``perphil_tpu/ops/ilu.py`` for PETSc's ``pc_type: ilu``
(``pc_factor_levels: 0``) in the natural, lexicographic field-major order.

Every row of the structured system holds the same static offset list
(block shift times the 3^d geometric stencil offsets); entries outside the
grid are masked. With the level function

    level(field, x, y, z) = x + 2 y + 4 z + field * (max|level step| + 1)

every row depends only on rows of strictly lower levels, so each level is a
data-parallel batch. The factorisation runs once on the host (numpy,
vectorised per level). The application ``z = U^{-1} L^{-1} r`` is two
wavefront sweeps: the lower offsets over the levels in order, then the
upper offsets over the reversed levels and a divide by the diagonal.

:class:`StructuredILU0` applies it in native f64. On a CUDA tensor it
launches ``csrc/ilu_apply.cu`` (counted as ``structured_ilu_apply``; in the
JAX package this apply is XLA, not Pallas); on a CPU tensor it runs the
plain sweep, the order the kernel keeps bit for bit. The fused GMRES
kernel (K7, K8) runs the same sweep on the same buffers.

The sweepers of the SNES ``ngs`` Picard solve live here too:

  - :class:`GaussSeidelSweeper`: one forward lexicographic Gauss-Seidel
    sweep of the monolithic system on the same level schedule (the JAX
    package's wavefront ``_leveled_clip_sweep(..., scale_diag=True)``); on a
    CUDA tensor the ILU sweep of ``csrc/ilu_apply.cu`` in its Gauss-Seidel
    mode (counted as ``structured_ilu_apply[gs]``);
  - :class:`ColoredNGSSweeper`: the pinned-colouring multicolour secant
    sweep (quad meshes), whose whole Picard solve is one kernel
    (``ops/fused_ngs.py``).

The same applies and sweeps also run as parallel-prefix trisolves
(:class:`PartriILU`, :class:`PartriGS`, per field a :class:`DirTriSolve`
over ``ops/partri.py``), the JAX package's default backend: torch ops on
either device, the same functions with other bits, built and called like
the wavefront classes. :data:`ILU_BACKENDS` and :data:`GS_BACKENDS` map
each ``trisolve_backend`` to its class (the solvers pick by their option,
``solvers/solver.py``). :func:`partri_plan` gives the bytes of the maps,
:func:`partri_peak` those of a build at its peak.

Not ported: the double-float defect-corrected apply (a TPU workaround for
emulated f64).
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from perphil_tpu_torch.config import DeviceLike, resolve_device
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import dpp_stencils
from perphil_tpu_torch.ops.ordering import ngs_parity_coloring
from perphil_tpu_torch.ops.partri import GridTriSolve2D, GridTriSolve3D, apply_varcoef_stencil
from perphil_tpu_torch.ops.stencil import compile_stencils

KERNEL = "structured_ilu_apply"
GS_KERNEL = "structured_ilu_apply[gs]"
#: the kernels' fixed offset tables hold at most this many offsets per side
MAX_SIDE_OFFSETS = 40

_LAMBDA = (1, 2, 4)  # level weights per coordinate (x, y, z)


#: the ring's deepest plan (``csrc/ilu_sweep.cuh::kIluMaxStages``)
_RING_MAX_STAGES = 8


class IluPlan(NamedTuple):
    """How a sweep lays out its shared memory (``ilu_sweep.cuh::IluPlan``):
    ``cap`` rows of the widest level a stage holds (0: no stage, the direct
    loop), ``slots`` doubles a row of a stage, ring ``stages``, whether z
    lives in shared memory, whether the level bounds do, and the region's
    bytes."""

    cap: int
    slots: int
    stages: int
    z_smem: bool
    lp_smem: bool
    bytes: int


class SweepGeometry(NamedTuple):
    """What a launch of ``structured_ilu_apply`` ran with: ring stages (0:
    the direct loop), z in shared memory, dynamic bytes, and the dynamic
    shared memory the kernel could have had (the plan's budget)."""

    stages: int
    z_smem: bool
    bytes: int
    budget: int


def ilu_plan(nlow: int, nup: int, nrows: int, nlev: int, max_rows: int, budget: int) -> IluPlan:
    """The launcher's plan (``ilu_sweep.cuh::ilu_plan``) for a factor of
    ``nrows`` rows with ``nlow``/``nup`` offsets a side and ``nlev`` levels,
    the widest ``max_rows`` rows, in ``budget`` bytes: the level bounds
    (where they take at most a quarter), a ring as deep as leaves room for z
    (8 stages at most, 2 at least), and z where it still fits."""
    slots, used, cap, stages, z_smem, lp_smem = max(nlow, nup) + 2, 0, 0, 0, False, False
    lp = 8 * ((nlev + 2) // 2)
    if lp <= budget // 4:
        lp_smem, used = True, lp

    def ring(st: int) -> int:
        return st * max_rows * slots * 8 + 8 * ((st * max_rows + 1) // 2)

    zbytes = 8 * (nrows + 1)
    keep = zbytes if used + ring(2) + zbytes <= budget else 0
    for st in range(_RING_MAX_STAGES, 1, -1):
        if max_rows > 0 and used + ring(st) + keep <= budget:
            cap, stages, used = max_rows, st, used + ring(st)
            break
    if cap > 0 and used + zbytes <= budget:
        z_smem, used = True, used + zbytes
    return IluPlan(cap, slots, stages, z_smem, lp_smem, (used + 15) // 16 * 16)


#: K8's line pipeline on 2D fields (``csrc/field_sweep.cuh``): lines a lane
#: owns, the narrowest field it takes, warps at most
LINE_SLOTS = _cuda.header_constant("field_sweep.cuh", "kLineSlots")
LINE_MIN_NX = _cuda.header_constant("field_sweep.cuh", "kLineMinNx")
LINE_MAX_WARPS = _cuda.header_constant("field_sweep.cuh", "kLineMaxWarps")
_LINE_ROWS_AHEAD = _cuda.header_constant("field_sweep.cuh", "kLineRowsAhead")
_LINE_ROW_BYTES = _cuda.header_constant("field_sweep.cuh", "kLineRowBytes")


class LinePlan(NamedTuple):
    """K8's line pipeline for one 2D field: its ``warps`` and its shared
    memory in ``bytes`` (the edge lines and the warps' rings of row stages,
    rounded to 16)."""

    warps: int
    bytes: int


def line_plan(node_shape: Tuple[int, ...], slots: int = LINE_SLOTS) -> Optional[LinePlan]:
    """The launcher's choice (``field_sweep.cuh::line_warps`` /
    ``line_bytes``) for a field of ``node_shape`` nodes, ``slots`` lines a
    lane: ``ceil(ny / (32 slots))`` warps, two edge lines of ``nx`` doubles
    for each warp but the last, and each lane's ring of row stages (64 bytes
    a row, ``max(1, 8 // slots)`` steps of ``slots`` rows); None where the
    field keeps the ring
    (3D, fewer than :data:`LINE_MIN_NX` nodes a line, one line, more than
    :data:`LINE_MAX_WARPS` warps)."""
    if len(node_shape) != 2:
        return None
    ny, nx = node_shape
    warps = -(-ny // (32 * slots))
    if nx < LINE_MIN_NX or ny < 2 or warps > LINE_MAX_WARPS:
        return None
    ahead = max(1, _LINE_ROWS_AHEAD // slots)
    ring = warps * ahead * slots * 32 * _LINE_ROW_BYTES
    return LinePlan(warps, (16 * (warps - 1) * nx + ring + 15) // 16 * 16)


def _fma(a: float, b: float, c: float) -> np.float64:
    """``a b + c`` rounded once (exact rational arithmetic, then the
    correctly rounded double)."""
    return np.float64(float(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))))


def line_div(acc: np.float64, d: np.float64, r: np.float64) -> np.float64:
    """The line pipeline's divide (``csrc/field_sweep.cuh::line_div``) on
    the host: ``acc / d`` correctly rounded from ``r = RN(1 / d)``, ``q =
    RN(acc r)`` corrected by two FMAs; zero as ``acc r``, a quotient far
    from 1 or non-finite by the plain divide. Equal to ``acc / d`` bit for
    bit (``tests/test_torch_line_sweep.py``)."""
    if acc == 0.0:
        return acc * r
    q = acc * r
    q = _fma(_fma(-q, d, acc), r, q)
    return q if 2.0**-960 <= abs(q) <= 2.0**960 else acc / d


def line_sweep_replay(ilu: "StructuredILU0", r: np.ndarray, slots: int = LINE_SLOTS) -> np.ndarray:
    """K8's line pipeline (``csrc/field_sweep.cuh``) replayed on the host in
    numpy f64: ``U^{-1} L^{-1} r`` for a 2D field's :class:`StructuredILU0`,
    each warp's lanes and slots step by step, a lane's value passed to the
    lane above a step later, a warp's top line through its edge line, the
    entries read from :meth:`StructuredILU0.line_tables` as the kernel reads
    them, and every edge rule of the kernel's. Asserts on the way
    that each row is computed once, that every value a row reads was
    computed before it (an edge value before the warp above reads it) and is
    the column the plain sweep reads at that level (a column outside the
    grid or not yet computed: the rule's zero). Warps run one after the
    other: a warp waits only on the one below."""
    ny, nx = ilu.node_shape
    plan = line_plan((ny, nx), slots)
    assert plan is not None, "the field takes the ring"
    steps, nrows = nx + 2 * (ny - 1), ilu.nrows
    level = np.add.outer(2 * np.arange(ny), np.arange(nx)).ravel()  # x + 2y, flat y * nx + x
    lower, upper_t = (t.cpu().numpy() for t in ilu.line_tables())
    sides = {False: (lower, [ilu.deltas[t] for t in ilu.lower]), True: (upper_t, [ilu.deltas[t] for t in ilu.upper])}

    def sweep(upper: bool, rhs: np.ndarray) -> np.ndarray:
        F, deltas = sides[upper]
        items = 6 if upper else 4
        out, done = np.zeros(nrows), np.zeros(nrows, dtype=int)
        zero = (0.0, -1)  # a register's value and the row that computed it (-1: the rule's zero)
        edge = [dict() for _ in range(plan.warps)]

        def expected(row: int, q: int) -> int:
            col = min(max(row + deltas[q], 0), nrows)
            if col == nrows or (level[col] >= level[row] if not upper else level[col] <= level[row]):
                return -1
            return col

        for w in range(plan.warps):
            j0 = 32 * slots * w
            lines = [[j0 + 32 * k + lane for k in range(slots)] for lane in range(32)]
            jlast = min(ny, j0 + 32 * slots) - 1
            t0, t1 = (2 * j0 - 1 if j0 > 0 else 0), min(steps, nx + 2 * jlast)
            h = [[[zero] * 3 for _ in range(slots)] for _ in range(32)]  # h1, h2, h3
            own = [[zero] * slots for _ in range(32)]
            first = [[zero] * slots for _ in range(32)]
            for s in range(t0, t1):
                sent = [[own[lane][k] for k in range(slots)] for lane in range(32)]
                for lane in range(32):
                    for k in range(slots):
                        if lane > 0:
                            got = sent[lane - 1][k]
                        elif k > 0:
                            got = sent[31][k - 1]
                        elif w > 0:
                            at = s - 2 * j0 + 1
                            got = zero
                            if 0 <= at < nx:
                                assert at in edge[w - 1], "an edge value read before it was written"
                                got = edge[w - 1][at]
                        else:
                            got = zero
                        h[lane][k] = [got, h[lane][k][0], h[lane][k][1]]
                for lane in range(32):
                    for k in range(slots):
                        jj, (h1, h2, h3) = lines[lane][k], h[lane][k]
                        p = s - 2 * jj
                        if not (0 <= p < nx and jj < ny):
                            continue
                        o, fi = own[lane][k], first[lane][k]
                        if not upper:
                            a = [(h3 if p >= 1 else (h2 if jj == 1 else zero)) if jj >= 1 else (fi if p >= 1 else zero),
                                 h2 if jj >= 1 else (fi if p >= 1 else zero),
                                 (h1 if p < nx - 1 else fi) if jj >= 1 else (fi if p >= 1 else zero),
                                 o if p >= 1 else zero]
                        else:
                            a = [o if p >= 1 else zero,
                                 fi if p == nx - 1 else (h1 if jj >= 1 else zero),
                                 h2 if jj >= 1 else zero,
                                 h3 if jj >= 1 and p >= 1 else zero]
                        lv = steps - 1 - s if upper else s
                        y, x = (ny - 1 - jj, nx - 1 - p) if upper else (jj, p)
                        row = x + y * nx
                        assert level[row] == lv
                        acc = np.float64(rhs[row])
                        for q in range(4):
                            assert a[q][1] == expected(row, q), (upper, row, q, a[q][1])
                            acc = acc - np.float64(F[items * row + q]) * np.float64(a[q][0])
                        if upper:
                            acc = line_div(acc, np.float64(F[items * row + 4]), np.float64(F[items * row + 5]))
                        own[lane][k] = (acc, row)
                        if p == 0:
                            first[lane][k] = (acc, row)
                        out[row] = acc
                        done[row] += 1
                        if k == slots - 1 and lane == 31 and w < plan.warps - 1:
                            edge[w][p] = (acc, row)
        assert (done == 1).all(), "a row computed other than once"
        return out

    return sweep(True, sweep(False, np.asarray(r, dtype=np.float64)))


def _geom_offsets(d: int) -> List[Tuple[int, ...]]:
    """All 3^d stencil offsets in coordinate order (x, y[, z])."""
    rng = (-1, 0, 1)
    if d == 2:
        return [(dx, dy) for dy in rng for dx in rng]
    return [(dx, dy, dz) for dz in rng for dy in rng for dx in rng]


@dataclass
class StructuredSystem:
    """A block-structured sparse matrix with static per-row offset lists.

    :param mesh: the structured mesh (geometry / strides).
    :param nfields: 1 (single block) or 2 (monolithic DPP).
    :param vals: (nrows, noffs) float array of entries.
    :param deltas: global flat column deltas per offset.
    :param valid: (nrows, noffs) bool mask of structurally-present entries.
    :param levels: the wavefront levels, each an array of rows.
    """

    mesh: StructuredMesh
    nfields: int
    vals: np.ndarray
    deltas: np.ndarray
    blocks: np.ndarray
    geoms: np.ndarray
    valid: np.ndarray
    levels: List[np.ndarray]

    @property
    def n_nodes(self) -> int:
        return self.mesh.num_vertices

    @property
    def nrows(self) -> int:
        return self.n_nodes * self.nfields

    @property
    def center_index(self) -> int:
        return int(np.where((self.blocks == 0) & (self.geoms == 0).all(axis=1))[0][0])


def _build_system(mesh: StructuredMesh, block_stencils, nfields: int) -> StructuredSystem:
    """``block_stencils``: {(row_field, col_field): stencil ndarray}."""
    d = mesh.dim
    shape = mesh.node_shape  # slowest-first
    n = mesh.num_vertices
    geoms = _geom_offsets(d)
    blocks = list(range(-(nfields - 1), nfields))  # {-1,0,1} or {0}
    # strides in coordinate order (x fastest)
    strides = [1]
    for ax in range(1, d):
        strides.append(strides[-1] * shape[d - ax])
    strides = np.array(strides)

    pos = np.stack(
        [g.ravel() for g in np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")][::-1],
        axis=1,
    )  # (n, d) coordinate-ordered positions
    bdry = mesh.boundary_mask().ravel()

    noffs = len(blocks) * len(geoms)
    nrows = n * nfields
    vals = np.zeros((nrows, noffs))
    valid = np.zeros((nrows, noffs), dtype=bool)
    deltas = np.zeros(noffs, dtype=np.int64)
    blk_arr = np.zeros(noffs, dtype=np.int64)
    geom_arr = np.zeros((noffs, d), dtype=np.int64)

    for t, (bd, g) in enumerate(((bd, g) for bd in blocks for g in geoms)):
        deltas[t] = bd * n + int(np.dot(g, strides))
        blk_arr[t] = bd
        geom_arr[t] = g
        gnp = np.asarray(g)
        geo_ok = ((pos + gnp) >= 0).all(axis=1) & ((pos + gnp) < pos.max(axis=0) + 1).all(axis=1)
        col_idx = np.clip(pos + gnp, 0, np.asarray(shape[::-1]) - 1)
        col_bdry = bdry[col_idx @ strides]
        for f in range(nfields):
            cf = f + bd
            if cf < 0 or cf >= nfields:
                continue
            st = block_stencils.get((f, cf))
            if st is None:
                continue
            rows = slice(f * n, (f + 1) * n)
            # stencil indexed slowest-first: reverse the geometric offset
            w = float(st[tuple(int(o) + 1 for o in reversed(g))])
            v = np.where(geo_ok, w, 0.0)
            # symmetric BC elimination: zero bc rows and bc cols
            v = np.where(bdry | col_bdry, 0.0, v)
            if bd == 0 and (gnp == 0).all():
                v = np.where(bdry, 1.0, v)  # unit diagonal at bc rows
            vals[rows, t] = v
            valid[rows, t] = geo_ok

    lam = np.asarray(_LAMBDA[:d])
    sched = pos @ lam
    shift = int(np.abs(np.asarray(geoms) @ lam).max()) + 1
    levels_key = np.concatenate([sched + f * shift for f in range(nfields)])
    order = np.argsort(levels_key, kind="stable")
    boundaries = np.flatnonzero(np.diff(levels_key[order])) + 1
    levels = [lv.astype(np.int64) for lv in np.split(order, boundaries)]

    return StructuredSystem(
        mesh=mesh, nfields=nfields, vals=vals, deltas=deltas, blocks=blk_arr,
        geoms=geom_arr, valid=valid, levels=levels,
    )


def schedule_shape(node_shape: Tuple[int, ...], nfields: int) -> Tuple[int, int, int, int]:
    """(offsets a side below and above the diagonal, levels, rows of the
    widest level) of the ILU(0) that :func:`_build_system` lays out for
    ``nfields`` fields on a grid of ``node_shape`` nodes, from the shape
    alone: a node's level key is ``x + 2 y (+ 4 z)``, field f's shifted by
    ``f * shift``; every one of the ``(2 nfields - 1) 3^d`` offsets but the
    diagonal lies on one side."""
    d = len(node_shape)
    counts = np.ones(1, dtype=np.int64)  # nodes of one field per level key
    for lam, m in zip(_LAMBDA, reversed(node_shape)):  # x first
        step = np.zeros(lam * (m - 1) + 1, dtype=np.int64)
        step[::lam] = 1
        counts = np.convolve(counts, step)
    shift = sum(_LAMBDA[:d]) + 1
    keys = np.zeros(counts.size + shift * (nfields - 1), dtype=np.int64)
    for f in range(nfields):
        keys[f * shift : f * shift + counts.size] += counts
    side = ((2 * nfields - 1) * 3**d - 1) // 2
    return side, side, int(np.count_nonzero(keys)), int(keys.max())


def monolithic_stencils(mesh: StructuredMesh, params: DPPParameters) -> dict:
    """{(row field, column field): stencil} of the field-major 2-field DPP
    matrix: the weights of its interior rows (:func:`_build_system` zeroes
    the entries that point at boundary columns)."""
    K_st, M_st = compile_stencils(mesh)
    p = params
    S1 = (p.k1 / p.mu) * K_st + (p.beta / p.mu) * M_st
    S2 = (p.k2 / p.mu) * K_st + (p.beta / p.mu) * M_st
    C = -(p.beta / p.mu) * M_st
    return {(0, 0): S1, (1, 1): S2, (0, 1): C, (1, 0): C}


def build_monolithic_system(mesh: StructuredMesh, params: DPPParameters) -> StructuredSystem:
    """Field-major 2-field DPP matrix in structured form."""
    return _build_system(mesh, monolithic_stencils(mesh, params), 2)


def build_field_system(mesh: StructuredMesh, k: float, beta: float, mu: float) -> StructuredSystem:
    """One block ``(k/mu) K + (beta/mu) M`` in structured form."""
    K_st, M_st = compile_stencils(mesh)
    S = (k / mu) * K_st + (beta / mu) * M_st
    return _build_system(mesh, {(0, 0): S}, 1)


def _factorization_tables(sys: StructuredSystem):
    """Lower-offset order, offset-difference map and per-k upper-update lists."""
    deltas = sys.deltas
    noffs = deltas.shape[0]
    order_lower = [t for t in np.argsort(deltas) if deltas[t] < 0]
    # m[k][j] = the offset whose (block, geom) is offset j's minus offset k's, or -1
    key = {(int(b), tuple(int(x) for x in g)): t for t, (b, g) in enumerate(zip(sys.blocks, sys.geoms))}
    mmap = -np.ones((noffs, noffs), dtype=np.int64)
    for k in range(noffs):
        for j in range(noffs):
            db = int(sys.blocks[j] - sys.blocks[k])
            dg = tuple(int(x) for x in (sys.geoms[j] - sys.geoms[k]))
            mmap[k, j] = key.get((db, dg), -1)
    uppers_of = {
        k: [j for j in range(noffs) if deltas[j] > deltas[k] and mmap[k, j] >= 0]
        for k in order_lower
    }
    return order_lower, mmap, uppers_of


def ilu0_factorize(sys: StructuredSystem) -> np.ndarray:
    """In-pattern incomplete LU with no fill outside the structural pattern,
    level-vectorised on the host (the JAX package's numpy path, which it
    keeps bit-identical to its C++ one). Returns a new (nrows, noffs) array
    holding L (unit diagonal implied, entries at lower offsets) and U
    (diagonal + upper offsets), like PETSc's combined factor storage."""
    order_lower, mmap, uppers_of = _factorization_tables(sys)
    vals = sys.vals.copy()
    deltas = sys.deltas
    center = sys.center_index
    nrows = sys.nrows
    for R in sys.levels:
        for k in order_lower:
            a_ik = vals[R, k]
            nz = a_ik != 0.0
            if not nz.any():
                continue
            pivot_rows = np.clip(R + deltas[k], 0, nrows - 1)
            piv = vals[pivot_rows, center]
            piv_safe = np.where(piv != 0.0, piv, 1.0)
            f = np.where(nz, a_ik / piv_safe, 0.0)
            vals[R, k] = f
            for j in uppers_of[k]:
                upd = f * vals[pivot_rows, mmap[k, j]]
                # restrict fill to the structural pattern
                vals[R, j] = np.where(sys.valid[R, j], vals[R, j] - upd, 0.0)
    return vals


def _pack_by_level(by_level: np.ndarray, offs: Sequence[int], ptr: np.ndarray) -> np.ndarray:
    """``by_level[offs]`` (rows in level order) packed level by level: level
    lv's block starts at ``len(offs) * ptr[lv]`` and holds ``[q][r]``, q the
    offsets in the given order, r the level's rows."""
    side = by_level[list(offs)]
    blocks = [side[:, ptr[lv] : ptr[lv + 1]].ravel() for lv in range(len(ptr) - 1)]
    return np.concatenate(blocks) if offs else np.zeros(0)


# ---------------------------------------------------------------------------
# parallel-prefix (scan-tree) trisolves: ops/partri.py on the grid
# ---------------------------------------------------------------------------

#: the host budget of the partri maps: the JAX package's cap
#: (``perphil_tpu/ops/ilu.py::_PARTRI_MAX_BYTES``), kept on the CPU so that
#: both packages take the same route there; on the card the budget is its
#: free memory, against :func:`partri_peak` (``solvers/solver.py``)
CPU_PARTRI_MAX_BYTES = 6 * 1024**3


def _grouped(node_shape: Tuple[int, ...], group: int) -> bool:
    """Whether partri's 2D solves on this grid take the grouped pass
    (``GridTriSolve2D``: unbatched, ``ny >= 2 group``)."""
    return len(node_shape) == 2 and group > 0 and node_shape[0] >= 2 * group


def partri_plan(node_shape: Tuple[int, ...], nfields: int, itemsize: int = 8, group: int = 0) -> int:
    """Bytes of the composed maps of the parallel-prefix trisolves of one
    ILU apply (or GS sweep) on ``nfields`` fields of a ``node_shape`` grid:
    ~2 maps a row (2D, ``nx^2`` each) or a plane (3D, ``(ny nx)^2`` each) a
    directional solve, two directional solves a field (the JAX package's
    ``_partri_fits`` formula); the grouped 2D pass (``group`` > 0) keeps one
    map a group of ``group`` rows, ``ceil(ny / group)``."""
    if len(node_shape) == 2:
        ny, nx = node_shape
        maps = -(-ny // group) if _grouped(node_shape, group) else 2 * ny
        per = maps * nx * nx * itemsize
    else:
        nz, ny, nx = node_shape
        per = 2 * nz * (ny * nx) ** 2 * itemsize
    return 2 * nfields * per


def partri_peak(node_shape: Tuple[int, ...], nfields: int, itemsize: int = 8, group: int = 0) -> int:
    """Bytes of device memory a :class:`PartriILU` (or :class:`PartriGS`)
    build and its applies hold at their peak: the maps (:func:`partri_plan`)
    plus the workspace of the directional solve built last, while the
    others' maps are kept. That solve holds its dense couplings, their row
    solves, the first tree level's products and copies next to its growing
    maps: measured 3.1-3.7 map sets (one map a row) in 2D and 4.9-5.7 (one
    map a plane) in 3D, on the CPU at 2D N=32/33 and tet nx=8/9 and on an
    H100 at 2D N=128/256 and tet nx=16; counted as 5 and 7, a set of
    margin. Add 64 values a row for the entry grids, the row scans and an
    apply's vectors. The grouped 2D pass (``group``) keeps its maps in place
    of the tree's; its build holds the dense couplings and the row maps (two
    of the tree's sets) and the groups' products, within the same
    workspace."""
    n = int(np.prod(node_shape))
    per_set = partri_plan(node_shape, 1, itemsize) // 4
    return partri_plan(node_shape, nfields, itemsize, group) + (5 if len(node_shape) == 2 else 7) * per_set \
        + 64 * nfields * n * itemsize


def _grid_entries(sys: StructuredSystem, values: np.ndarray, f: int, bd: int, device: torch.device):
    """Per-offset entry grids of one (row field, block) pair of ``values``
    (nrows, noffs): {coordinate-ordered geom offset: node_shape f64 grid}."""
    n = sys.n_nodes
    key = {(int(b), tuple(int(x) for x in g)): t for t, (b, g) in enumerate(zip(sys.blocks, sys.geoms))}
    out = {}
    for g in _geom_offsets(sys.mesh.dim):
        t = key.get((bd, g))
        if t is not None:
            out[g] = torch.tensor(values[f * n : (f + 1) * n, t].reshape(sys.mesh.node_shape), device=device)
    return out


def _flip_all(a: torch.Tensor) -> torch.Tensor:
    return torch.flip(a, dims=tuple(range(a.ndim)))


def _is_lower_geom(g, shape) -> bool:
    """Lexicographic comparison via strides: flat delta < 0 <=> lower."""
    d = len(shape)
    strides = [1]
    for ax in range(1, d):
        strides.append(strides[-1] * shape[d - ax])
    return int(np.dot(g, strides)) < 0


class _Stencil(nn.Module):
    """Varying-coefficient stencil weights as one buffer ``w`` (noffs,
    *node_shape) and their offsets; :meth:`grids` gives the
    ``apply_varcoef_stencil`` dict."""

    def __init__(self, entries: dict):
        super().__init__()
        self.offsets = tuple(entries)
        self.register_buffer("w", torch.stack([entries[g] for g in self.offsets]))

    def grids(self) -> dict:
        return dict(zip(self.offsets, self.w.unbind(0)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_varcoef_stencil(x, self.grids())


class DirTriSolve(nn.Module):
    """Directional triangular solve ``(D? + A) x = r`` on one field's grid.

    ``entries`` maps coordinate-ordered geometric offsets (the strictly
    lower or upper part) to raw matrix-entry grids; ``diag`` is the diagonal
    grid (None: unit). ``reverse=True`` solves in anti-lexicographic order
    (upper solves) by flipping every axis. ``group``: the 2D solve's grouped
    pass (:class:`GridTriSolve2D`); 3D stays on the tree."""

    def __init__(self, dim: int, entries: dict, diag: Optional[torch.Tensor], reverse: bool, group: int = 0):
        super().__init__()
        self.reverse = bool(reverse)
        if reverse:
            entries = {tuple(-int(o) for o in g): _flip_all(w) for g, w in entries.items()}
            diag = _flip_all(diag) if diag is not None else None
        self.register_buffer("diag", diag)

        def nrm(g: Tuple[int, ...]) -> torch.Tensor:
            w = -entries[g]
            return w / diag if diag is not None else w

        if dim == 2:
            self.solver = GridTriSolve2D(nrm((-1, 0)), nrm((-1, -1)), nrm((0, -1)), nrm((1, -1)), group)
        else:
            plane = GridTriSolve2D(nrm((-1, 0, 0)), nrm((-1, -1, 0)), nrm((0, -1, 0)), nrm((1, -1, 0)))
            bz = {(dx, dy): nrm((dx, dy, -1)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)}
            self.solver = GridTriSolve3D(plane, bz)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        if self.reverse:
            r = _flip_all(r)
        c = r / self.diag if self.diag is not None else r
        x = self.solver.apply(c)
        return _flip_all(x) if self.reverse else x


def _split_entries(sys: StructuredSystem, values: np.ndarray, f: int, device: torch.device):
    """Field f's own block: (diagonal grid, strictly lower entries, strictly
    upper entries)."""
    shape = sys.mesh.node_shape
    center = (0,) * sys.mesh.dim
    ent = _grid_entries(sys, values, f, 0, device)
    low = {g: w for g, w in ent.items() if _is_lower_geom(g, shape)}
    upp = {g: w for g, w in ent.items() if not _is_lower_geom(g, shape) and g != center}
    return ent[center], low, upp


class PartriILU(nn.Module):
    """ILU(0) application ``z = U^{-1} L^{-1} r`` by parallel-prefix
    triangular solves (field-major natural order; ``ops/partri.py``).

    For the monolithic two-field system the lower factor visits every field-0
    row before the field-1 rows, so L^{-1} is field 0's grid solve, then
    field 1's with the cross-block contribution subtracted; U^{-1} mirrors it
    bottom-up. ``factors``: the (nrows, noffs) ILU(0) factor.

    The partri backend (:data:`ILU_BACKENDS`): torch ops on either device,
    built and applied like :class:`StructuredILU0`. ``group``: the 2D
    solves' grouped pass (the ``partri_group`` option)."""

    trisolve_backend = "partri"

    def __init__(self, sys: StructuredSystem, factors: np.ndarray, device: DeviceLike = None, group: int = 0):
        super().__init__()
        self.device = dev = resolve_device(device)
        self.group = int(group)
        d = sys.mesh.dim
        self.nfields, self.shape, self.n = sys.nfields, tuple(sys.mesh.node_shape), sys.n_nodes
        self.nrows = sys.nrows
        lower, upper = [], []
        for f in range(sys.nfields):
            diag, low, upp = _split_entries(sys, factors, f, dev)
            lower.append(DirTriSolve(d, low, None, reverse=False, group=group))
            upper.append(DirTriSolve(d, upp, diag, reverse=True, group=group))
        self.lower_solve, self.upper_solve = nn.ModuleList(lower), nn.ModuleList(upper)
        if sys.nfields == 2:
            self.cross_lower = _Stencil(_grid_entries(sys, factors, 1, -1, dev))  # field-1 rows
            self.cross_upper = _Stencil(_grid_entries(sys, factors, 0, +1, dev))  # field-0 rows

    @classmethod
    def for_system(cls, sys: StructuredSystem, device: DeviceLike = None, group: int = 0):
        """Factored here (the host ILU(0) of :class:`StructuredILU0`)."""
        return cls(sys, ilu0_factorize(sys), device, group)

    @classmethod
    def for_monolithic(cls, mesh: StructuredMesh, params: DPPParameters, device: DeviceLike = None, group: int = 0):
        return cls.for_system(build_monolithic_system(mesh, params), device, group)

    @classmethod
    def for_field(cls, fop, group: int = 0):
        """Of a ``FieldOperator`` block, on its space's device."""
        return cls.for_system(build_field_system(fop.mesh, fop.k, fop.beta, fop.mu), fop.V.device, group)

    def apply_flat(self, r: torch.Tensor) -> torch.Tensor:
        """``z = U^{-1} (L^{-1} r)`` on a flat f64 tensor on the build's device."""
        _check_device(r, self.device)
        n = self.n
        if self.nfields == 1:
            return self.upper_solve[0](self.lower_solve[0](r.reshape(self.shape))).reshape(r.shape)
        y1 = self.lower_solve[0](r[:n].reshape(self.shape))
        y2 = self.lower_solve[1](r[n:].reshape(self.shape) - self.cross_lower(y1))
        z2 = self.upper_solve[1](y2)
        z1 = self.upper_solve[0](y1 - self.cross_upper(z2))
        return torch.cat([z1.reshape(-1), z2.reshape(-1)])

    def apply_grid(self, r: torch.Tensor) -> torch.Tensor:
        """Grid (or stacked grids) in, the same shape out."""
        return self.apply_flat(r.reshape(-1)).reshape(r.shape)

    forward = apply_grid


def _check_device(t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, solve built for {device}")


class PartriGS(nn.Module):
    """One forward pointwise Gauss-Seidel sweep by parallel-prefix solves:
    ``x_new = (D + L)^{-1} (b - U x_old)`` in lexicographic field-major order
    (the wavefront sweep's algebra). ``values``: the (nrows, noffs) matrix.

    The partri backend (:data:`GS_BACKENDS`), built and swept like
    :class:`GaussSeidelSweeper`; ``group`` as :class:`PartriILU`'s."""

    trisolve_backend = "partri"

    def __init__(self, sys: StructuredSystem, values: np.ndarray, device: DeviceLike = None, group: int = 0):
        super().__init__()
        self.device = dev = resolve_device(device)
        self.group = int(group)
        d = sys.mesh.dim
        self.nfields, self.shape, self.n = sys.nfields, tuple(sys.mesh.node_shape), sys.n_nodes
        self.nrows = sys.nrows
        ld, upper = [], []
        for f in range(sys.nfields):
            diag, low, upp = _split_entries(sys, values, f, dev)
            ld.append(DirTriSolve(d, low, diag, reverse=False, group=group))
            upper.append(_Stencil(upp))
        self.ld_solve, self.upper_entries = nn.ModuleList(ld), nn.ModuleList(upper)
        if sys.nfields == 2:
            self.cross_lower = _Stencil(_grid_entries(sys, values, 1, -1, dev))
            self.cross_upper = _Stencil(_grid_entries(sys, values, 0, +1, dev))

    @classmethod
    def for_system(cls, sys: StructuredSystem, device: DeviceLike = None, group: int = 0):
        return cls(sys, sys.vals, device, group)

    @classmethod
    def for_monolithic(cls, mesh: StructuredMesh, params: DPPParameters, device: DeviceLike = None, group: int = 0):
        return cls.for_system(build_monolithic_system(mesh, params), device, group)

    def sweep(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One forward sweep from ``x`` on flat f64 tensors on the build's device."""
        _check_device(x, self.device)
        _check_device(b, self.device)
        n, shape = self.n, self.shape
        if self.nfields == 1:
            c = b.reshape(shape) - self.upper_entries[0](x.reshape(shape))
            return self.ld_solve[0](c).reshape(x.shape)
        x1, x2 = x[:n].reshape(shape), x[n:].reshape(shape)
        c1 = b[:n].reshape(shape) - self.upper_entries[0](x1) - self.cross_upper(x2)
        y1 = self.ld_solve[0](c1)
        c2 = b[n:].reshape(shape) - self.upper_entries[1](x2) - self.cross_lower(y1)
        y2 = self.ld_solve[1](c2)
        return torch.cat([y1.reshape(-1), y2.reshape(-1)])


def _clip_sweep(rhs: torch.Tensor, plan: list, nrows: int, z0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One wavefront sweep (the JAX package's ``_leveled_clip_sweep``): per
    level, ``acc = rhs[rows] - v[t] * z[col]`` over the plan's offsets in
    its order (each product and difference rounded apart), then ``acc /
    diag`` where the plan has one; ``z`` starts at ``z0`` (zero by default)
    and a column past the last row reads zero."""
    z = rhs.new_zeros(nrows + 1)
    if z0 is not None:
        z[:nrows] = z0
    for rows, cols, V, diag in plan:
        acc = rhs[rows]
        prods = V * z[cols]
        for t in range(prods.shape[0]):
            acc = acc - prods[t]
        if diag is not None:
            acc = acc / diag
        z[rows] = acc
    return z[:nrows]


class _LevelSchedule(nn.Module):
    """What a structured system's level-scheduled sweeps share: its offsets
    (``deltas``, ``center``, the ``lower`` and ``upper`` sides), the
    wavefront schedule in CSR form (``level_ptr`` (nlev + 1,), ``level_rows``
    (nrows,) int32) and the kernels' int32 offset table ``meta``:
    ``[nlow, nup, center, low_t[40], up_t[40], delta[noffs]]``."""

    def __init__(self, sys: StructuredSystem, device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)
        self.nrows, self.n_nodes = sys.nrows, sys.n_nodes
        self.node_shape = tuple(sys.mesh.node_shape)
        self.deltas = tuple(int(x) for x in sys.deltas)
        self.center = sys.center_index
        self.lower = tuple(t for t, d in enumerate(self.deltas) if d < 0)
        self.upper = tuple(t for t, d in enumerate(self.deltas) if d > 0)
        if max(len(self.lower), len(self.upper)) > MAX_SIDE_OFFSETS:
            raise ValueError(f"at most {MAX_SIDE_OFFSETS} offsets per side")
        self._ptr = np.cumsum([0] + [len(lv) for lv in sys.levels]).astype(np.int32)
        self._rows = np.concatenate(sys.levels).astype(np.int32)
        self.register_buffer("level_ptr", torch.tensor(self._ptr, device=self.device))
        self.register_buffer("level_rows", torch.tensor(self._rows, device=self.device))
        meta = np.zeros(3 + 2 * MAX_SIDE_OFFSETS + len(self.deltas), np.int32)
        meta[:3] = len(self.lower), len(self.upper), self.center
        meta[3 : 3 + len(self.lower)] = self.lower
        meta[3 + MAX_SIDE_OFFSETS : 3 + MAX_SIDE_OFFSETS + len(self.upper)] = self.upper
        meta[3 + 2 * MAX_SIDE_OFFSETS :] = self.deltas
        self.meta = meta
        #: rows of the widest level: the kernels size their prefetch stage by it
        self.max_level_rows = int(np.diff(self._ptr).max())
        #: what the last launch chose (:class:`SweepGeometry`)
        self.last_geometry: Optional[SweepGeometry] = None

    @property
    def num_levels(self) -> int:
        return int(self.level_ptr.numel()) - 1

    def _tables(self, M: torch.Tensor, offs: Sequence[int], with_diag: bool) -> list:
        """Per level the plain sweep's gather table: (rows, cols, the values
        of ``M`` (noffs, nrows) at ``offs``[, the diagonal])."""
        ptr, nrows = self._ptr.tolist(), self.nrows
        d = torch.tensor([self.deltas[t] for t in offs], device=self.device)
        sel = M[list(offs)]
        plan = []
        for lv in range(len(ptr) - 1):
            rows = self.level_rows[ptr[lv] : ptr[lv + 1]].long()
            cols = torch.clamp(rows[None, :] + d[:, None], 0, nrows)
            plan.append((rows, cols, sel[:, rows], M[self.center, rows] if with_diag else None))
        return plan

    def _geometry(self, geometry: np.ndarray) -> None:
        self.last_geometry = SweepGeometry(
            int(geometry[0]), bool(geometry[1]), int(geometry[2]), int(geometry[3])
        )

    def _check_flat(self, t: torch.Tensor, name: str) -> None:
        _cuda.require_cuda_tensor(t, name, torch.float64, self.device)
        if tuple(t.shape) != (self.nrows,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({self.nrows},)")

    def _on_device(self, *ts: torch.Tensor) -> bool:
        """True for CUDA tensors (launch), False for CPU ones (the plain
        sweep); raises on another device than the schedule's."""
        for t in ts:
            if t.device != self.device:
                raise ValueError(f"tensor on {t.device}, sweep built for {self.device}")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"the sweeps run on cpu or cuda, got {self.device}")
        return self.device.type == "cuda"


class StructuredILU0(_LevelSchedule):
    """ILU(0) application ``z = U^{-1} L^{-1} r`` in native f64.

    The wavefront backend (:data:`ILU_BACKENDS`): the kernel on a CUDA
    tensor, the plain sweep on a CPU one.

    Buffers: ``factors`` (noffs, nrows), the f64 factor by offset (the plain
    sweep's); ``packed_lower`` and ``packed_upper``, the same entries packed
    by level (the kernels': a level's rows lie scattered in ``factors``);
    ``level_ptr`` (nlev + 1,) and ``level_rows`` (nrows,) int32, the
    wavefront schedule in CSR form. ``meta`` holds the kernels' int32 offset
    table: ``[nlow, nup, center, low_t[40], up_t[40], delta[noffs]]``.
    """

    trisolve_backend = "wavefront"

    def __init__(self, sys: StructuredSystem, device: DeviceLike = None):
        super().__init__(sys, device)
        fac = ilu0_factorize(sys)
        dev = self.device
        self.register_buffer("factors", torch.tensor(np.ascontiguousarray(fac.T), device=dev))
        # each side packed by level for the kernels (upper: then the diagonal)
        by_level = fac.T[:, self._rows]
        for name, offs in (("packed_lower", self.lower), ("packed_upper", self.upper + (self.center,))):
            self.register_buffer(name, torch.tensor(_pack_by_level(by_level, offs, self._ptr), device=dev))
        self._plan: Optional[Tuple[list, list]] = None

    @classmethod
    def for_monolithic(cls, mesh: StructuredMesh, params: DPPParameters, device: DeviceLike = None):
        return cls(build_monolithic_system(mesh, params), device)

    @classmethod
    def for_field(cls, fop):
        """Of a ``FieldOperator`` block, on its space's device."""
        return cls(build_field_system(fop.mesh, fop.k, fop.beta, fop.mu), fop.V.device)

    def line_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The factor laid out by row for K8's line pipeline
        (``csrc/field_sweep.cuh``), built at first call and kept as the
        buffers ``line_lower`` (nrows x 4: a row's lower entries in stored
        order) and ``line_upper`` (nrows x 6: its upper entries in stored
        order, the diagonal and the diagonal's reciprocal, correctly rounded,
        for the kernel's divide), flat f64 on the schedule's device. The
        entries are ``factors``' own."""
        if getattr(self, "line_lower", None) is None:
            fac = self.factors.cpu().numpy()
            upper = np.zeros((6, self.nrows))
            upper[:5] = fac[list(self.upper) + [self.center]]
            with np.errstate(divide="ignore"):
                upper[5] = 1.0 / upper[4]
            for name, side in (("line_lower", fac[list(self.lower)]), ("line_upper", upper)):
                self.register_buffer(name, torch.tensor(np.ascontiguousarray(side.T).ravel(), device=self.device))
        return self.line_lower, self.line_upper

    def _level_plan(self) -> Tuple[list, list]:
        """Per level, the plain sweeps' gather tables: (rows, cols, factor
        values[, diagonal]) for the lower and the upper offsets (built at
        first use; only the plain sweep reads them)."""
        if self._plan is None:
            self._plan = (
                self._tables(self.factors, self.lower, False),
                self._tables(self.factors, self.upper, True),
            )
        return self._plan

    def plain(self, r: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch twin on a flat ``(nrows,)`` f64 tensor (any device)."""
        lower, upper = self._level_plan()
        return _clip_sweep(_clip_sweep(r, lower, self.nrows), upper[::-1], self.nrows)

    def plain_grid(self, r: torch.Tensor) -> torch.Tensor:
        """:meth:`plain` on a grid (or stacked grids): the same shape out."""
        return self.plain(r.reshape(-1)).reshape(r.shape)

    def launch(self, r: torch.Tensor) -> torch.Tensor:
        """Run ``csrc/ilu_apply.cu`` on a flat ``(nrows,)`` f64 CUDA tensor."""
        self._check_flat(r, "r")
        z = torch.empty_like(r)
        y = torch.empty_like(r)
        geometry = np.zeros(4, np.int32)
        _cuda.launch(
            KERNEL, "perphil_structured_ilu_apply", r.device,
            r.data_ptr(), z.data_ptr(), y.data_ptr(), self.packed_lower.data_ptr(),
            self.packed_upper.data_ptr(), self.level_ptr.data_ptr(), self.level_rows.data_ptr(),
            self.meta.ctypes.data,
            len(self.deltas), self.nrows, self.num_levels, self.max_level_rows,
            geometry.ctypes.data,
        )
        self._geometry(geometry)
        return z

    def apply_flat(self, r: torch.Tensor) -> torch.Tensor:
        """``z = U^{-1} (L^{-1} r)`` on a flat f64 tensor: the kernel on a
        CUDA tensor, the plain sweep on a CPU one."""
        return self.launch(r) if self._on_device(r) else self.plain(r)

    def apply_grid(self, r: torch.Tensor) -> torch.Tensor:
        """Grid (or stacked grids) in, the same shape out."""
        return self.apply_flat(r.reshape(-1)).reshape(r.shape)

    forward = apply_grid


class GaussSeidelSweeper(_LevelSchedule):
    """Forward pointwise Gauss-Seidel sweeps over the BC-eliminated monolithic
    system in lexicographic field-major order (the SNES ``ngs`` solve on
    tri/hex/tet meshes; counterpart of ``perphil_tpu/ops/ilu.py``'s
    ``GaussSeidelSweeper`` on its wavefront path). Every dependency of a row
    lies on an earlier level, so the level schedule sweeps in row order.

    The wavefront backend (:data:`GS_BACKENDS`).

    Buffers: ``vals`` (noffs, nrows), the matrix by offset (the plain
    sweep's); ``packed``, the same entries packed by level for the kernel:
    per level ``[q][r]``, q the off-centre offsets in stored order, then the
    diagonal.
    """

    trisolve_backend = "wavefront"

    def __init__(self, sys: StructuredSystem, device: DeviceLike = None):
        super().__init__(sys, device)
        self.offsets = tuple(t for t in range(len(self.deltas)) if t != self.center)
        dev = self.device
        self.register_buffer("vals", torch.tensor(np.ascontiguousarray(sys.vals.T), device=dev))
        packed = _pack_by_level(sys.vals.T[:, self._rows], self.offsets + (self.center,), self._ptr)
        self.register_buffer("packed", torch.tensor(packed, device=dev))
        self._plan: Optional[list] = None

    @classmethod
    def for_monolithic(cls, mesh: StructuredMesh, params: DPPParameters, device: DeviceLike = None):
        return cls(build_monolithic_system(mesh, params), device)

    def plain(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch twin on flat ``(nrows,)`` f64 tensors (any device):
        per level ``(b - sum_{t != center} a_t z[col]) / a_center`` with
        ``z`` read in place (the JAX package's ``_leveled_clip_sweep`` with
        ``scale_diag``)."""
        if self._plan is None:
            self._plan = self._tables(self.vals, self.offsets, True)
        return _clip_sweep(b, self._plan, self.nrows, x)

    def launch(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Run the ILU sweep of ``csrc/ilu_apply.cu`` in its Gauss-Seidel
        mode on flat ``(nrows,)`` f64 CUDA tensors."""
        self._check_flat(x, "x")
        self._check_flat(b, "b")
        z = torch.empty_like(x)
        geometry = np.zeros(4, np.int32)
        _cuda.launch(
            GS_KERNEL, "perphil_gs_sweep", x.device,
            x.data_ptr(), b.data_ptr(), z.data_ptr(), self.packed.data_ptr(), self.level_ptr.data_ptr(),
            self.level_rows.data_ptr(), self.meta.ctypes.data,
            len(self.deltas), self.nrows, self.num_levels, self.max_level_rows, geometry.ctypes.data,
        )
        self._geometry(geometry)
        return z

    def sweep(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One forward sweep from ``x``: ``x_i <- (b_i - sum_{j != i} a_ij
        x_j) / a_ii`` in row order, on flat f64 tensors: the kernel on CUDA
        tensors, the plain sweep on CPU ones."""
        return self.launch(x, b) if self._on_device(x, b) else self.plain(x, b)


#: the ILU apply of each ``trisolve_backend`` (same constructors and apply methods)
ILU_BACKENDS = {"partri": PartriILU, "wavefront": StructuredILU0}
#: the lexicographic Gauss-Seidel sweeper of each ``trisolve_backend``
GS_BACKENDS = {"partri": PartriGS, "wavefront": GaussSeidelSweeper}
TRISOLVE_BACKENDS = tuple(ILU_BACKENDS)


class ColoredNGSSweeper(nn.Module):
    """The multicolour secant Gauss-Seidel sweep of PETSc's SNES ``ngs``
    under the pinned colouring draw (``ops/ordering.py::
    ngs_parity_coloring``), on quad meshes: counterpart of
    ``perphil_tpu/ops/ilu.py``'s ``ColoredNGSSweeper``. Per colour in
    ascending order every DoF of the colour steps at once by the residual
    at the current iterate over the diagonal (the secant slope of the linear
    DPP residual).

    The residual is the kernel's arithmetic (``csrc/fused_ngs.cu``), so
    ``ops/fused_ngs.py`` takes this sweep as its twin: a row of field f at
    an interior node is ``b - (0.0 + sum w[f][t] x[tap t])`` over field 0's
    nine taps then field 1's (:attr:`weights`), boundary neighbours masked
    to zero; a boundary row is the identity row, ``b - x``.

    Buffers: ``masks`` (ncolors, 2, *node_shape) bool; ``diagonal`` (2,
    *node_shape), the operator's diagonal (1 on boundary rows);
    ``boundary`` (*node_shape) bool.
    """

    def __init__(self, mesh: StructuredMesh, params: DPPParameters, device: DeviceLike = None):
        super().__init__()
        if mesh.element != "quad":
            raise ValueError(f"ColoredNGSSweeper is pinned for quad meshes, got {mesh.element!r}")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.shape = (2,) + tuple(mesh.node_shape)
        S1, S2, C = (np.asarray(S, dtype=np.float64) for S in dpp_stencils(mesh, params))
        #: per row field, its 18 taps: field 0's nine (offsets row-major), then field 1's
        self.weights = np.stack([np.concatenate([S1.ravel(), C.ravel()]), np.concatenate([C.ravel(), S2.ravel()])])
        #: the interior rows' diagonals, per field
        self.diag = (float(S1[1, 1]), float(S2[1, 1]))
        #: per DoF its colour, field-major flat (``ngs_parity_coloring``)
        self.colors = ngs_parity_coloring(mesh)
        self.ncolors = int(self.colors.max()) + 1
        dev = self.device
        self._taps = [torch.tensor(w, device=dev).reshape(2, 1, 1) for w in self.weights.T]
        masks = np.stack([self.colors == c for c in range(self.ncolors)]).reshape((self.ncolors,) + self.shape)
        self.register_buffer("masks", torch.tensor(masks, device=dev))
        bdry = torch.tensor(mesh.boundary_mask(), device=dev)
        self.register_buffer("boundary", bdry)
        diagonal = torch.stack([torch.full(bdry.shape, d, dtype=torch.float64, device=dev) for d in self.diag])
        self.register_buffer("diagonal", diagonal.masked_fill_(bdry, 1.0))

    def residual(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``b - A x`` on stacked ``(2, *node_shape)`` f64 tensors."""
        ny, nx = self.shape[1:]
        xi = torch.where(self.boundary, 0.0, x)
        acc = x.new_zeros((2, ny - 2, nx - 2))  # both fields' rows: tap t reads field t // 9
        for t, w in enumerate(self._taps):
            dy, dx = (t % 9) // 3 - 1, t % 3 - 1
            acc = acc + w * xi[t // 9, 1 + dy : ny - 1 + dy, 1 + dx : nx - 1 + dx]
        r = b - x
        r[:, 1:-1, 1:-1] = b[:, 1:-1, 1:-1] - acc
        return r

    def sweep_stacked(self, x: torch.Tensor, b: torch.Tensor, r: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One NGS iteration on stacked tensors; ``r``, when given, is the
        residual at ``x`` and serves colour 0."""
        for c in range(self.ncolors):
            if c > 0 or r is None:
                r = self.residual(x, b)
            x = torch.where(self.masks[c], x + r / self.diagonal, x)
        return x

    def sweep(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One NGS iteration on flat field-major ``(2 n,)`` f64 tensors (the
        JAX package's interface): ascending colours, each colour's DoFs
        stepping at once by the residual at the current iterate."""
        for t in (x, b):
            if t.device != self.device:
                raise ValueError(f"tensor on {t.device}, sweeper built for {self.device}")
        return self.sweep_stacked(x.reshape(self.shape), b.reshape(self.shape)).reshape(-1)
