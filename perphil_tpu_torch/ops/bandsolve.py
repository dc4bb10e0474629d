"""The ordering-parity ILU apply on the card: a level-scheduled sweep over
the sparse ILU(0) factor.

Counterpart of ``perphil_tpu/ops/bandsolve.py``, the device engine of
``pc_factor_mat_ordering_type=rcm`` (the published 3D tet "GMRES + ILU PC"
column, ``petsc_perf_breakdown_3d.csv``). The ILU(0) factorisation is
sequential and stays on the host (``ops/_native.py``, PETSc's division of
labour); the applies run on the card.

What an apply computes is the host engine's ``ilu_apply``
(``csrc/csr_solver.cpp``; its numpy twin ``ordering.host_ilu_apply``) on
the combined two-field factor ``F`` of the permuted system, bit for bit:
forward ``y[i] = r[i] - F[i,k] y[k]`` over the row's strictly lower
entries, backward ``x[i] = (y[i] - F[i,k] x[k]) / F[i,i]`` over its strictly
upper ones, each in the row's CSR order, every product, difference and
quotient rounded on its own. The JAX package covers the per-field factors
with dense band blocks for the TPU's matrix unit (a ``lax.scan``, no
Pallas); the port keeps the sparse factor, which at tet nx=40 is 49 MB
where one dense band factor alone reads 1.15 GB.

The sweep's schedule (:func:`level_schedule`, built once a solver on the
host): each row's level in a sweep is 1 + the largest level among the rows
it reads (:func:`sweep_levels`, Kahn's pass a level at a time), so the rows
of a level are independent and a level schedule changes no row's
arithmetic. The factor is stored in level order: row ``i`` is dealt to
block ``i mod blocks``; a block's rows of a level, sorted by their entry
count (so that a warp's 32 rows are of similar length) and cut into slices
of 32 rows (one warp), are a segment, stored contiguously in one blob
(values, diagonals, columns, rows words), its entries padded to the
segment's widest row, entry-major (``[slice][k][lane]``: a warp's reads
coalesce). A lane reads only its row's own entries; the twin's padding
entries hold 0.0 and read the vector's zero slot ``n``.

The kernel (``csrc/band_trisolve.cu``, :func:`level_apply`, counted as
``band_trisolve``) runs both sweeps in one launch: on one block with the
vector in its shared memory, or on a cluster of 16 blocks with the vector
spread over their shared memory (row ``i`` in block ``i mod 16``) or in
device memory; a block barrier or an mbarrier exchange between levels; a
producer warp streams each level's segment into a shared-memory ring by one
bulk copy, up to three levels ahead. :func:`level_apply_plain` is its twin,
a PyTorch level loop over the same blob, and the CPU path. :func:`band_plan`
gives the device memory before anything is allocated; the solver checks it
against the card's free memory (``solvers/solver.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn
from torch.nn.functional import pad

from perphil_tpu_torch.config import DeviceLike, resolve_device
from perphil_tpu_torch.ops import _cuda

KERNEL = "band_trisolve"
WARP = 32
_SOURCE = "band_trisolve.cu"
#: the launcher's limits, read from its source
MAX_WIDTH = _cuda.header_constant(_SOURCE, "kLevelMaxWidth")
MAX_STAGES = _cuda.header_constant(_SOURCE, "kLevelMaxStages")
MAX_CLUSTER = _cuda.header_constant(_SOURCE, "kLevelMaxCluster")
SMEM_BUDGET = _cuda.header_constant(_SOURCE, "kLevelSmemBudget")
RULE_BLOCKS = _cuda.header_constant(_SOURCE, "kLevelRuleBlocks")
_HEADER_BYTES = _cuda.header_constant(_SOURCE, "kLevelHeader")
#: a lane's row index takes the low ROW_BITS bits of its ``rows`` word, its
#: entry count in the sweep the bits above
ROW_BITS = _cuda.header_constant(_SOURCE, "kLevelRowBits")
#: what the caching allocator may add to a buffer: a large one takes a
#: segment rounded up to 2 MiB, the rest of which it keeps when too small to
#: split off
_ALLOC_SLACK = 2 << 20
_BUFFERS = 4  # blob, desc, perm, vec
#: the block counts a placement takes (a cluster beyond one): powers of two
BLOCK_COUNTS = tuple(1 << k for k in range(MAX_CLUSTER.bit_length()))


def _ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The concatenated ``arange(s, s + n)`` of each start and length."""
    total = int(lengths.sum())
    return np.repeat(starts - np.cumsum(lengths) + lengths, lengths) + np.arange(total)


def sweep_levels(F: sp.csr_matrix, lower: bool) -> np.ndarray:
    """Each row's level (int64) in one sweep over the combined factor: 0
    for a row that reads no other row, else 1 + the largest level among
    the rows it reads (the columns of its strictly lower entries forward,
    of its strictly upper ones backward). Kahn's pass, one level at a
    time: a level's rows release their dependents, and those whose last
    dependency that was form the next level."""
    n = F.shape[0]
    rows = np.repeat(np.arange(n), np.diff(F.indptr))
    keep = F.indices < rows if lower else F.indices > rows
    waiting = np.bincount(rows[keep], minlength=n)
    # the dependents of each row: the sweep's triangle by column (CSC)
    T = sp.csr_matrix((np.ones(int(waiting.sum()), np.int8), F.indices[keep],
                       np.concatenate([[0], np.cumsum(waiting)])), shape=(n, n)).tocsc()
    tptr, dependents = T.indptr.astype(np.int64), T.indices.astype(np.int64)
    level = np.full(n, -1, dtype=np.int64)
    frontier = np.flatnonzero(waiting == 0)
    depth = 0
    while frontier.size:
        level[frontier] = depth
        at = _ranges(tptr[frontier], tptr[frontier + 1] - tptr[frontier])
        released, times = np.unique(dependents[at], return_counts=True)
        waiting[released] -= times
        frontier = released[waiting[released] == 0]
        depth += 1
    if (level < 0).any():
        raise ValueError("the factor's dependencies have a cycle: not triangular")
    return level


class LevelSchedule(NamedTuple):
    """Both sweeps of the combined factor in level order, as the kernel and
    its twin read them. ``blob`` (uint8) holds the segments, one block's
    slices of one level each: its entries' values (f64, ``slots = 32 m w``
    of them, entry k of lane t of slice j at ``32 (j w + k) + t``), its
    lanes' diagonals (f64, ``32 m``), the entries' columns (int32) and the
    lanes' rows words (int32: the row, and its entry count in the sweep
    above ``ROW_BITS``; -1 for padding). ``desc`` is int32 ``(levels,
    blocks, 4)``: per level (the forward sweep's ``nlev[0]``, then the
    backward one's) and block, ``[offset / 16 B, m, w, 0]``. Row ``i`` is
    dealt to block ``i mod blocks``. ``perm`` maps a permuted row to its
    natural (stacked) index. ``stage_bytes`` is the largest segment (a ring
    stage), ``stages`` the ring's depth, ``shared_vector`` whether the
    vector lives in shared memory (one block's, or spread over the
    cluster's: row ``i`` in block ``i mod blocks``) or in device memory."""

    n: int
    nnz: int
    nlev: Tuple[int, int]
    blocks: int
    shared_vector: bool
    stages: int
    stage_bytes: int
    blob: np.ndarray
    desc: np.ndarray
    perm: np.ndarray

    @property
    def slots(self) -> int:
        """Padded entries over both sweeps."""
        m, w = self.desc[..., 1].astype(np.int64), self.desc[..., 2].astype(np.int64)
        return int((WARP * m * w).sum())

    @property
    def slices(self) -> int:
        return int(self.desc[..., 1].sum())


def smem_bytes(n: int, levels: int, stages: int, stage_bytes: int, shared_vector: bool, blocks: int) -> int:
    """The launcher's dynamic shared memory (``level_smem_bytes``): the
    ring's mbarriers, the block's descriptors, the ring, and the block's
    share of the vector where it lives in shared memory."""
    head = -(-(_HEADER_BYTES + 16 * levels) // 128) * 128
    return head + stages * stage_bytes + (8 * -(-n // blocks) if shared_vector else 0)


def ring_stages(n: int, levels: int, stage_bytes: int, shared_vector: bool, blocks: int) -> int:
    """The deepest ring (2..``MAX_STAGES`` stages) whose shared memory fits
    the launcher's budget; 0 where none does."""
    for stages in range(MAX_STAGES, 1, -1):
        if smem_bytes(n, levels, stages, stage_bytes, shared_vector, blocks) <= SMEM_BUDGET:
            return stages
    return 0


def _sweep_layout(F: sp.csr_matrix, entry_row: np.ndarray, diag_pos: np.ndarray, level: np.ndarray, lower: bool,
                  blocks: int):
    """One sweep's segments (``entry_row``: each stored entry's row;
    ``level``: :func:`sweep_levels`): ``(blob, desc, levels)``, offsets
    local to the sweep."""
    n = F.shape[0]
    count = diag_pos - F.indptr[:-1] if lower else F.indptr[1:] - diag_pos - 1
    if n >= 1 << ROW_BITS:
        raise ValueError(f"{n} rows: the kernel takes fewer than {1 << ROW_BITS}")
    if count.max(initial=0) > MAX_WIDTH:
        raise ValueError(f"a row has {int(count.max())} entries in a sweep, the kernel takes {MAX_WIDTH}")
    nlev = int(level.max()) + 1
    seg = level * blocks + np.arange(n) % blocks  # segments in (level, block) order
    order = np.lexsort((-count, seg))  # a segment's longest rows first
    seg_s, cnt_s = seg[order], count[order]
    size = np.bincount(seg, minlength=nlev * blocks)
    start = np.concatenate([[0], np.cumsum(size)])[:-1]
    rank = np.arange(n) - start[seg_s]
    j, lane = rank // WARP, rank % WARP  # slice within its segment, lane
    m = -(-size // WARP)
    w = np.where(size > 0, cnt_s[np.minimum(start, n - 1)], 0)  # a segment's first row is its longest
    slots, lanes = WARP * m * w, WARP * m
    off = np.concatenate([[0], np.cumsum(12 * (slots + lanes))])
    blob = np.zeros(int(off[-1]), dtype=np.uint8)
    f64, i32 = blob.view(np.float64), blob.view(np.int32)
    o8, o4 = off[:-1] // 8, off[:-1] // 4
    # padding first: diagonals 1.0, columns n, rows -1 (values stay 0.0)
    f64[_ranges(o8 + slots, lanes)] = 1.0
    i32[_ranges(o4 + 2 * (slots + lanes), slots)] = n
    i32[_ranges(o4 + 3 * slots + 2 * lanes, lanes)] = -1
    # each row's lane: its diagonal and rows word; where its entries start
    at = WARP * j + lane
    f64[o8[seg_s] + slots[seg_s] + at] = F.data[diag_pos[order]]
    i32[o4[seg_s] + 3 * slots[seg_s] + 2 * lanes[seg_s] + at] = order | (cnt_s << ROW_BITS)
    val_at, col_at = np.empty(n, dtype=np.int64), np.empty(n, dtype=np.int64)
    val_at[order] = o8[seg_s] + WARP * j * w[seg_s] + lane
    col_at[order] = o4[seg_s] + 2 * (slots[seg_s] + lanes[seg_s]) + WARP * j * w[seg_s] + lane
    # each entry of the sweep, in CSR order: k-th of its row at 32 k past the row's start
    keep = F.indices < entry_row if lower else F.indices > entry_row
    erow = entry_row[keep]
    k = WARP * (np.arange(erow.size) - np.repeat(np.cumsum(count) - count, count))
    f64[val_at[erow] + k] = F.data[keep]
    i32[col_at[erow] + k] = F.indices[keep]
    desc = np.stack([off[:-1] // 16, m, w, np.zeros_like(m)], axis=1).reshape(nlev, blocks, 4)
    return blob, desc, nlev


def level_schedule(F: sp.csr_matrix, perm: np.ndarray, blocks: Optional[int] = None,
                   shared_vector: Optional[bool] = None) -> LevelSchedule:
    """The factor ``F`` (the combined ILU(0) factor of the permuted system,
    sorted indices, every diagonal stored) and the permutation ``perm``
    (natural index of each permuted row) in level order, on the plan's
    placement: one block with the vector in its shared memory where the
    vector and the ring fit the budget, else a cluster of ``RULE_BLOCKS``
    (``kLevelRuleBlocks``) with the vector spread over their shared memory,
    else the same cluster with the vector in device memory (the rule
    measured fastest, ``tools/profile_kernels.py --only band``).
    ``blocks`` asks for another block count and ``shared_vector`` for the
    vector's place (in shared memory where it fits, unless ``False``), for
    measurements; a placement that does not fit raises ``ValueError``."""
    F = F.tocsr()
    if not F.has_sorted_indices:
        F = F.sorted_indices()
    n = F.shape[0]
    rows = np.repeat(np.arange(n), np.diff(F.indptr))
    on_diag = np.flatnonzero(F.indices == rows)
    if on_diag.size != n or not np.array_equal(rows[on_diag], np.arange(n)):
        raise ValueError("every row of the factor must store its diagonal")
    levels = (sweep_levels(F, True), sweep_levels(F, False))
    if blocks is None:
        for count, shared in ((1, True), (RULE_BLOCKS, True), (RULE_BLOCKS, False)):
            sched = _schedule(F, perm, rows, on_diag, levels, count, shared)
            if sched is not None:
                return sched
        raise ValueError(f"the schedule fits no placement (a segment beyond {RULE_BLOCKS} blocks' ring)")
    if blocks not in BLOCK_COUNTS:
        raise ValueError(f"blocks {blocks} is not one of {BLOCK_COUNTS}")
    sched = None
    if shared_vector is not False:
        sched = _schedule(F, perm, rows, on_diag, levels, blocks, True)
    if sched is None and not shared_vector:
        sched = _schedule(F, perm, rows, on_diag, levels, blocks, False)
    if sched is None:
        where = "shared memory" if shared_vector else "a ring"
        raise ValueError(f"the schedule on {blocks} block(s) does not fit {where}")
    return sched


def _schedule(F, perm, rows, on_diag, levels, blocks: int, shared_vector: bool) -> Optional[LevelSchedule]:
    """The schedule on ``blocks`` blocks, the vector in shared memory or
    not; None where the ring (and the vector's share) do not fit."""
    n = F.shape[0]
    if shared_vector and 8 * -(-n // blocks) >= SMEM_BUDGET:
        return None
    (bl, desc_l, nl), (bu, desc_u, nu) = (_sweep_layout(F, rows, on_diag, lev, lower, blocks)
                                          for lev, lower in zip(levels, (True, False)))
    desc_u = desc_u.copy()
    desc_u[..., 0] += bl.size // 16
    desc = np.concatenate([desc_l, desc_u]).astype(np.int32)
    stage_bytes = int((384 * desc[..., 1].astype(np.int64) * (desc[..., 2] + 1)).max())
    stages = ring_stages(n, nl + nu, stage_bytes, shared_vector, blocks)
    if stages == 0:
        return None
    return LevelSchedule(n, int(F.nnz), (nl, nu), blocks, shared_vector, stages, stage_bytes,
                         np.concatenate([bl, bu]), desc, np.ascontiguousarray(perm, dtype=np.int32))


def segment_arrays(blob: torch.Tensor, desc_row) -> Tuple[torch.Tensor, ...]:
    """One segment of ``blob`` (uint8) as ``(vals (m, w, 32), diag (m, 32),
    cols (m, w, 32), rows (m, 32))`` views, from its descriptor ``[offset /
    16, m, w, 0]``."""
    off, m, w = (int(x) for x in desc_row[:3])
    slots, lanes = WARP * m * w, WARP * m
    at = 16 * off
    vals = blob[at : at + 8 * slots].view(torch.float64).view(m, w, WARP)
    diag = blob[at + 8 * slots : at + 8 * (slots + lanes)].view(torch.float64).view(m, WARP)
    at += 8 * (slots + lanes)
    cols = blob[at : at + 4 * slots].view(torch.int32).view(m, w, WARP)
    rows = blob[at + 4 * slots : at + 4 * (slots + lanes)].view(torch.int32).view(m, WARP)
    return vals, diag, cols, rows


class BandPlan(NamedTuple):
    """What the band engine holds on the card: ``factor_bytes`` for the
    level-ordered factor (12 B a padded entry and a lane, the descriptors,
    the permutation) and ``workspace_bytes`` (the vector's ``n`` doubles in
    device memory, and up to 2 MiB a buffer that the caching allocator may
    add), nothing else at the build's peak."""

    levels: int
    blocks: int
    factor_bytes: int
    workspace_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.factor_bytes + self.workspace_bytes


def band_plan(n: int, slots: int, slices: int, levels: int, blocks: int) -> BandPlan:
    """The band engine's device memory for ``n`` rows, ``slots`` padded
    entries and ``slices`` slices of 32 lanes over both sweeps, ``levels``
    levels on ``blocks`` blocks (:func:`plan_of` reads them off a
    schedule)."""
    factor = 12 * slots + 12 * WARP * slices + 16 * levels * blocks + 4 * n
    return BandPlan(levels, blocks, factor, 8 * n + _BUFFERS * _ALLOC_SLACK)


def plan_of(sched: LevelSchedule) -> BandPlan:
    """:func:`band_plan` of a schedule."""
    return band_plan(sched.n, sched.slots, sched.slices, sum(sched.nlev), sched.blocks)


def traffic(sched: LevelSchedule) -> Tuple[int, int]:
    """``(bytes, flops)`` one apply needs: every entry of the factor with
    its column read once (f64 + int32), ``r`` and ``perm`` read and ``z``
    written once; a multiply and a subtraction for each off-diagonal
    entry, a division a row. The bound of ``band_trisolve``."""
    return 12 * sched.nnz + 20 * sched.n, 2 * (sched.nnz - sched.n) + sched.n


class BandParityILU(nn.Module):
    """The parity ILU apply, built once a solver (PCSetUp): :meth:`apply`
    maps the stacked natural-order residual ``(2, *grid)`` to ``P^T U^-1
    L^-1 P r``. Buffers: the level-ordered factor ``blob`` (uint8), its
    descriptors ``desc`` (int32), the permutation ``perm`` (int32) and the
    kernel's vector ``vec`` (``n`` f64, where it lives in device memory)."""

    def __init__(self, sched: LevelSchedule, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.n, self.nlev = sched.n, tuple(sched.nlev)
        self.blocks, self.shared_vector = sched.blocks, sched.shared_vector
        self.stages, self.stage_bytes = sched.stages, sched.stage_bytes
        for name in ("blob", "desc", "perm"):
            self.register_buffer(name, torch.from_numpy(getattr(sched, name)).to(dev))
        self.register_buffer("vec", torch.zeros(sched.n, dtype=torch.float64, device=dev))
        self._desc_host = sched.desc
        self._twin: Optional[Tuple[int, list]] = None

    def levels(self) -> List[Tuple[bool, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Per level, its blocks' segments side by side, for the twin:
        ``(upper, rows, entries (rows, width), columns (rows, width),
        diagonals)``, padding lanes left out and each segment's entries
        padded to the level's widest (0.0 at column ``n``); built at first
        use and kept while the buffers stay where they are."""
        key = self.blob.data_ptr()
        if self._twin is None or self._twin[0] != key:
            out, mask = [], (1 << ROW_BITS) - 1
            for lev, per_block in enumerate(self._desc_host):
                parts = []
                width = int(per_block[:, 2].max())
                for row in per_block:
                    if row[1] == 0:
                        continue
                    vals, diag, cols, words = segment_arrays(self.blob, row)
                    m, w = vals.shape[:2]
                    words = words.reshape(-1).long()
                    ok = words >= 0
                    a = vals.permute(0, 2, 1).reshape(m * WARP, w)[ok]
                    c = cols.permute(0, 2, 1).reshape(m * WARP, w)[ok].long()
                    parts.append((words[ok] & mask, pad(a, (0, width - w)), pad(c, (0, width - w), value=self.n),
                                  diag.reshape(-1)[ok]))
                if parts:
                    out.append((lev >= self.nlev[0], *(torch.cat(t) for t in zip(*parts))))
            self._twin = (key, out)
        return self._twin[1]

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """``z = P^T U^-1 L^-1 P r`` on stacked natural fields ``(2, *grid)``."""
        return level_apply(self, r.reshape(-1)).view(r.shape)

    forward = apply


def level_apply_plain(band: BandParityILU, r: torch.Tensor) -> torch.Tensor:
    """The kernel's twin (plain PyTorch, any device): the vector takes ``r``
    through the permutation (its slot ``n`` 0.0), then each level in
    order updates its rows, ``s = s - a[:, k] * y[c[:, k]]`` for each
    ``k`` (a padding entry, 0.0 times the zero slot, leaves ``s`` as it is),
    divided by the diagonal in the backward sweep, and ``z`` takes the
    vector back through the permutation."""
    n = band.n
    perm = band.perm.long()
    vec = r.new_zeros(n + 1)
    vec[:n] = r[perm]
    for upper, rows, a, c, d in band.levels():
        s = vec[rows]
        for k in range(a.shape[1]):
            s = s - a[:, k] * vec[c[:, k]]
        if upper:
            s = s / d
        vec[rows] = s
    z = torch.empty_like(r)
    z[perm] = vec[:n]
    return z


def launch_args(band: BandParityILU, r: torch.Tensor, z: torch.Tensor, desc: Optional[torch.Tensor] = None,
                nlev: Optional[Tuple[int, int]] = None) -> tuple:
    """The launcher's arguments (``desc``/``nlev`` another schedule's
    levels, for measurements)."""
    desc = band.desc if desc is None else desc
    nl, nu = band.nlev if nlev is None else nlev
    return (
        r.data_ptr(), z.data_ptr(), band.vec.data_ptr(), band.blob.data_ptr(), desc.data_ptr(),
        band.perm.data_ptr(), band.n, nl, nu, band.blocks, int(band.shared_vector), band.stages, band.stage_bytes,
    )


def level_apply(band: BandParityILU, r: torch.Tensor) -> torch.Tensor:
    """:func:`level_apply_plain`'s function on the flat ``(n,)`` f64 ``r``:
    on CUDA tensors one launch of ``csrc/band_trisolve.cu`` (counted as
    ``band_trisolve``), on CPU tensors the twin."""
    if tuple(r.shape) != (band.n,):
        raise ValueError(f"r has shape {tuple(r.shape)}, expected ({band.n},)")
    if r.device.type == "cpu" and band.blob.device.type == "cpu":
        return level_apply_plain(band, r)
    dev = band.blob.device
    _cuda.require_cuda_tensor(band.blob, "the factor", torch.uint8, dev)
    r = r.contiguous()
    _cuda.require_cuda_tensor(r, "r", torch.float64, dev)
    z = torch.empty_like(r)
    _cuda.launch(KERNEL, "perphil_band_trisolve", dev, *launch_args(band, r, z))
    return z


def build_band_parity_ilu(sched: LevelSchedule, device: DeviceLike = None) -> BandParityILU:
    """The device apply of the host-factored parity system from its
    schedule (:func:`level_schedule` of the combined ILU(0) factor of ``Ap
    = A[perm][:, perm]``, ``ordering.parity_system``,
    ``_native.native_ilu0``)."""
    return BandParityILU(sched, device)


__all__ = [
    "KERNEL",
    "BandPlan",
    "BandParityILU",
    "LevelSchedule",
    "band_plan",
    "build_band_parity_ilu",
    "launch_args",
    "level_apply",
    "level_apply_plain",
    "level_schedule",
    "plan_of",
    "ring_stages",
    "segment_arrays",
    "smem_bytes",
    "sweep_levels",
    "traffic",
]
