"""K1: the fused two-field DPP stencil apply, with the box boundary folded in.

Counterpart of ``perphil_tpu/ops/pallas_kernels.py::fused_dpp_apply``:

    y1 = S1 * z1 + C * z2,   y2 = C * z1 + S2 * z2

over the 3^d offsets (S_i = (k_i/mu) K + (beta/mu) M, C = -(beta/mu) M). The
TPU kernel is f32-only and leaves the boundary masking to XLA; this one takes
f32 and f64 and folds the masking in, in one of two modes:

  - ``"matvec"``: ``DPPOperator.matvec`` — interior-masked input, identity
    boundary rows;
  - ``"lift"``: ``DPPOperator.lifted_rhs`` — boundary-only input,
    ``-A[int, bd] g`` on the interior and ``g`` on the boundary.

On a CUDA tensor :func:`fused_dpp_apply` (two grids) and
:func:`fused_dpp_apply_stacked` (one ``(2, *grid)`` tensor) launch the kernel
in ``csrc/dpp_apply.cu``; on a CPU tensor they run the plain twin
:func:`fused_dpp_apply_plain`.

:func:`fused_dpp_apply_halo_planes` is K1's halo form, for one block of a
grid that is decomposed over ranks or padded with phantom nodes: it reads
the owned block and the ghost planes its neighbours sent where they lie
(read as stencil neighbours, never written), writes the owned block, and
takes a node as a boundary (identity) row when its global index is 0 or at
least ``n_phys - 1`` on some axis. :func:`fused_dpp_apply_halo` is the same
kernel on a whole extended box. :func:`halo_plan` is their launch: K1's
tiles over the owned stencil rows, the z chunk chosen to fill the card
(:func:`fill_chunk`). Their twins are :func:`fused_dpp_apply_halo_planes_plain`
and :func:`fused_dpp_apply_halo_plain`. With no ghost, no offset and no
padding the halo form is the whole-grid apply.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Tuple

import numpy as np
import torch

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.stencil import apply_stencil

KERNEL = "fused_dpp_apply"
HALO_KERNEL = "fused_dpp_apply_halo"
MODES = {"matvec": 0, "lift": 1}


@lru_cache(maxsize=32)
def box_boundary(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """Boolean grid marking the first and last node of every axis."""
    mask = torch.zeros(shape, dtype=torch.bool, device=device)
    for ax in range(len(shape)):
        mask.narrow(ax, 0, 1).fill_(True)
        mask.narrow(ax, shape[ax] - 1, 1).fill_(True)
    return mask


def pack_weights(S1: np.ndarray, S2: np.ndarray, C: np.ndarray) -> np.ndarray:
    """The kernels' host weight block: 81 doubles, [S1 | S2 | C], each a
    flattened ``(3,)*d`` stencil zero-padded to 27."""
    w = np.zeros((3, 27), dtype=np.float64)
    for row, st in zip(w, (S1, S2, C)):
        flat = np.asarray(st, dtype=np.float64).ravel()
        row[: flat.size] = flat
    return w


@lru_cache(maxsize=64)
def _packed(*stencils: bytes) -> np.ndarray:
    w = pack_weights(*(np.frombuffer(st) for st in stencils))
    w.flags.writeable = False
    return w


def packed_weights(S1, S2, C) -> np.ndarray:
    """:func:`pack_weights`, packed once per stencil set (read-only): the
    wrappers' weights, keyed by the stencils' values."""
    return _packed(*(np.ascontiguousarray(st, dtype=np.float64).tobytes() for st in (S1, S2, C)))


def fused_dpp_apply_plain(
    z1: torch.Tensor, z2: torch.Tensor, S1, S2, C, mode: str = "matvec"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K1 (any device)."""
    bdry = box_boundary(tuple(z1.shape), z1.device)
    keep = ~bdry if mode == "matvec" else bdry
    z1m = torch.where(keep, z1, 0.0)
    z2m = torch.where(keep, z2, 0.0)
    y1 = apply_stencil(z1m, S1) + apply_stencil(z2m, C)
    y2 = apply_stencil(z1m, C) + apply_stencil(z2m, S2)
    if mode == "lift":
        y1, y2 = -y1, -y2
    return torch.where(bdry, z1, y1), torch.where(bdry, z2, y2)


def _check(z: torch.Tensor, grids: int) -> None:
    if z.dim() - grids not in (2, 3) or (grids and z.shape[0] != 2):
        raise ValueError(f"need {'a stacked (2, *grid)' if grids else 'a'} 2D/3D grid, got {tuple(z.shape)}")
    if z.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_dpp_apply takes float32/float64, got {z.dtype}")
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_dpp_apply runs on cpu or cuda, got {z.device}")


def _launch(z: torch.Tensor, ptrs: Tuple[int, int, int, int], grid: Tuple[int, ...], S, mode: str):
    """Launch K1 on ``grid`` (2D or 3D) with the fields at ``ptrs`` (z1, z2
    in; y1, y2 out), of z's dtype and device, and the stencils ``S``."""
    nz, ny, nx = (1,) * (3 - len(grid)) + tuple(grid)
    symbol = "perphil_dpp_apply_f64" if z.dtype == torch.float64 else "perphil_dpp_apply_f32"
    weights = packed_weights(*S).ctypes.data
    _cuda.launch(KERNEL, symbol, z.device, *ptrs, weights, nz, ny, nx, len(grid), MODES[mode])


def fused_dpp_apply(
    z1: torch.Tensor, z2: torch.Tensor, S1, S2, C, mode: str = "matvec"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the BC-eliminated two-field operator (``mode="matvec"``) or
    lift boundary data (``mode="lift"``) on 2D/3D f32 or f64 node grids.

    :param S1, S2, C: ``(3,)*d`` host stencils (numpy), passed to the kernel
        by value (:func:`packed_weights`).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    if z1.shape != z2.shape:
        raise ValueError(f"need two equal 2D/3D grids, got {tuple(z1.shape)}, {tuple(z2.shape)}")
    _check(z1, 0)
    if z1.device.type == "cpu":
        return fused_dpp_apply_plain(z1, z2, S1, S2, C, mode)
    for name, t in (("z1", z1), ("z2", z2)):
        _cuda.require_cuda_tensor(t, name, z1.dtype, z1.device)
    y1 = torch.empty_like(z1)
    y2 = torch.empty_like(z2)
    ptrs = (z1.data_ptr(), z2.data_ptr(), y1.data_ptr(), y2.data_ptr())
    _launch(z1, ptrs, z1.shape, (S1, S2, C), mode)
    return y1, y2


def fused_dpp_apply_stacked(
    z: torch.Tensor, S1, S2, C, mode: str = "matvec"
) -> torch.Tensor:
    """:func:`fused_dpp_apply` on the two fields stacked in one
    ``(2, *grid)`` tensor, into one such tensor: no stack or concatenation
    around the kernel."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    _check(z, 1)
    if z.device.type == "cpu":
        return torch.stack(fused_dpp_apply_plain(z[0], z[1], S1, S2, C, mode))
    _cuda.require_cuda_tensor(z, "z", z.dtype, z.device)
    y = torch.empty_like(z)
    half = z.numel() // 2 * z.element_size()  # the second field's offset, in bytes
    ptrs = (z.data_ptr(), z.data_ptr() + half, y.data_ptr(), y.data_ptr() + half)
    _launch(z, ptrs, z.shape[1:], (S1, S2, C), mode)
    return y


def halo_geometry(box: Tuple[int, ...], ghosts=None, offsets=None, n_phys=None):
    """Normalise and check the geometry ``(ghosts, offsets, n_phys)`` of a
    block of ``box`` nodes, per grid axis (slowest first): the ghost widths
    ``(low, high)``, each 0 or 1 (default none); the global index of the
    first owned node (default 0); the physical node extents of the whole
    grid (default: the owned block is the whole grid). Every owned interior
    node must have both neighbours in the box."""
    d = len(box)
    ghosts = tuple((0, 0) for _ in range(d)) if ghosts is None else tuple(tuple(int(v) for v in g) for g in ghosts)
    offsets = (0,) * d if offsets is None else tuple(int(o) for o in offsets)
    owned = tuple(n - lo - hi for n, (lo, hi) in zip(box, ghosts))
    n_phys = tuple(o + n for o, n in zip(offsets, owned)) if n_phys is None else tuple(int(n) for n in n_phys)
    if not (len(ghosts) == len(offsets) == len(n_phys) == d):
        raise ValueError(f"need one ghost pair, offset and extent per axis of a {d}-D box")
    for ax, ((lo, hi), off, nph, n) in enumerate(zip(ghosts, offsets, n_phys, box)):
        if lo not in (0, 1) or hi not in (0, 1) or lo + hi > n or off < 0 or nph < 1:
            raise ValueError(f"bad halo geometry on axis {ax}: ghosts {(lo, hi)}, offset {off}, extent {nph}, box {n}")
        # the owned interior nodes, in box coordinates, and their neighbours
        s0, s1 = max(1 - off + lo, lo), min(nph - 1 - off + lo, n - hi)
        if s1 > s0 and (s0 < 1 or s1 > n - 1):
            raise ValueError(
                f"axis {ax}: an owned interior node has a neighbour outside the box "
                f"(ghosts {(lo, hi)}, offset {off}, extent {nph}, box {n})"
            )
    return ghosts, offsets, n_phys


def _interior_masks(box, ghosts, offsets, n_phys, device) -> Tuple[torch.Tensor, ...]:
    """Per axis, a boolean vector over the box: the node is globally
    interior (its global index in [1, n_phys - 2])."""
    out = []
    for n, (lo, _), off, nph in zip(box, ghosts, offsets, n_phys):
        g = torch.arange(n, device=device) + (off - lo)
        out.append((g >= 1) & (g <= nph - 2))
    return tuple(out)


def halo_boundary(box, ghosts, offsets, n_phys, device: torch.device) -> torch.Tensor:
    """Boolean box grid: the boundary (identity) rows by global index."""
    masks = _interior_masks(box, ghosts, offsets, n_phys, device)
    d = len(box)
    inner = torch.ones(tuple(box), dtype=torch.bool, device=device)
    for ax, m in enumerate(masks):
        inner = inner & m.reshape((1,) * ax + (-1,) + (1,) * (d - ax - 1))
    return ~inner


def fused_dpp_apply_halo_plain(
    z: torch.Tensor, S1, S2, C, mode: str = "matvec", ghosts=None, offsets=None, n_phys=None
) -> torch.Tensor:
    """Plain PyTorch twin of K1's halo form (any device): ``z`` is the
    stacked ``(2, *box)`` block with its ghosts, the result the stacked
    owned block."""
    box = tuple(z.shape[1:])
    ghosts, offsets, n_phys = halo_geometry(box, ghosts, offsets, n_phys)
    bdry = halo_boundary(box, ghosts, offsets, n_phys, z.device)
    keep = ~bdry if mode == "matvec" else bdry
    z1m = torch.where(keep, z[0], 0.0)
    z2m = torch.where(keep, z[1], 0.0)
    y1 = apply_stencil(z1m, S1) + apply_stencil(z2m, C)
    y2 = apply_stencil(z1m, C) + apply_stencil(z2m, S2)
    if mode == "lift":
        y1, y2 = -y1, -y2
    own = tuple(slice(lo, n - hi) for n, (lo, hi) in zip(box, ghosts))
    b = bdry[own]
    return torch.stack([torch.where(b, z[0][own], y1[own]), torch.where(b, z[1][own], y2[own])])


@lru_cache(maxsize=None)
def _kernel_constants() -> Tuple[int, int, int]:
    """K1's tile width and height and its z chunk (``csrc/dpp_apply.cu``)."""
    tile_x = _cuda.header_constant("dpp_apply.cu", "kTileX")
    return tile_x, _cuda.header_constant("dpp_apply.cu", "kApplyThreads") // tile_x, \
        _cuda.header_constant("dpp_apply.cu", "kChunk")


#: The wave the plan fills off the card: an H100's 132 SMs times the 4
#: blocks an SM holds (``kMinBlocks``, the halo form's occupancy there).
DEFAULT_WAVE = 132 * 4


@lru_cache(maxsize=16)
def halo_wave(device: torch.device, dtype: torch.dtype, dim: int) -> int:
    """The blocks of the halo form that ``device`` holds at once (the
    occupancy of an SM times the SMs), from the card."""
    wave = _cuda.library().perphil_dpp_apply_halo_wave(dim, int(dtype == torch.float64))
    if wave < 0:
        _cuda.check(-wave, "perphil_dpp_apply_halo_wave")
    return int(wave)


def fill_chunk(columns: int, planes: int, wave: int) -> int:
    """The z planes a block's stencil walks, given the blocks of a plane
    (``columns``), the stencil planes and the blocks the card holds at once
    (``wave``): 8 where a launch at 8 still holds one and a half waves,
    else K1's 4.

    Each plane a block walks costs it two staged planes beside it (a chunk
    of c stages c + 2), so a longer chunk stages less, while a launch of
    fewer blocks overlaps less. Measured on f64 matvecs, in turns (NVIDIA
    H100 80GB HBM3, 700 W; ``tools/profile_kernels.py --only halo``; the
    first of two turns), ms at chunks 2 / 3 / 4 / 5 / 6 / 8: the whole
    129^3 box (64 columns, 127 planes) 0.0573 / 0.0503 / 0.0472 / 0.0457 /
    0.0453 / 0.0431 (K1 0.0444); the padded 136 x 129 x 129 box 0.0579 /
    0.0509 / 0.0474 / 0.0459 / 0.0454 / 0.0432; a 17-plane slab of it
    0.0111 / 0.0101 / 0.0099 / 0.0102 / 0.0106 / 0.0112; all 8 slabs 0.0903
    / 0.0875 / 0.0857 / 0.0890 / 0.0905 / 0.0972. Shorter chunks that fill a
    slab's launch to a wave (576 blocks at 2) stage more than the idle SMs
    cost: a slab's 320 blocks at 4 are 0.6 of a wave and the fastest."""
    long_chunk, chunk = 8, _kernel_constants()[2]
    if columns * -(-planes // long_chunk) * 2 >= 3 * wave:
        return long_chunk
    return chunk


@dataclass(frozen=True)
class HaloPlan:
    """The halo form's launch on one ``dim``-D box, in the kernel's (z, y,
    x) axes (2D: z is the unit axis): the box, its low ghost widths ``o0``,
    the owned block ``nout``, the global interior ``[m0, m1)`` and the owned
    stencil rows ``[c0, c1)`` (empty: ``c0 == c1``) in box coordinates, the
    z ``chunk``, the ``zc`` z blocks that walk stencil chunks and the
    ``blocks`` along (z, y, x). The tiles cover the stencil rows from
    ``c0``; the first and last tile of an axis also write the raw rows
    between them and the owned block's ends, and the z blocks after the
    first ``zc`` write the raw planes, a chunk of them each."""

    dim: int
    box: Tuple[int, int, int]
    o0: Tuple[int, int, int]
    nout: Tuple[int, int, int]
    m0: Tuple[int, int, int]
    m1: Tuple[int, int, int]
    c0: Tuple[int, int, int]
    c1: Tuple[int, int, int]
    chunk: int
    zc: int
    blocks: Tuple[int, int, int]

    @cached_property
    def ints(self) -> np.ndarray:
        """The launcher's 26 plan ints."""
        return np.array(self.box + self.o0 + self.nout + self.m0 + self.m1 + self.c0 + self.c1
                        + (self.chunk, self.zc) + self.blocks, dtype=np.int32)

    def block_writes(self, b: Tuple[int, int, int]):
        """What block ``b`` writes, by the kernel's own arithmetic: its core
        (the stencil rows, a ``(start, stop)`` a kernel axis) and its share
        of the owned block (``(z planes, (y start, stop), (x start,
        stop))``), which it writes raw outside the core."""
        tile_x, tile_y, _ = _kernel_constants()
        core, share = [], []
        for a, t in ((1, tile_y), (2, tile_x)):
            start = self.c0[a] + b[a] * t
            stop = max(start, min(start + t, self.c1[a]))
            core.append((start, stop))
            share.append((self.o0[a] if b[a] == 0 else start,
                          self.o0[a] + self.nout[a] if b[a] == self.blocks[a] - 1 else stop))
        if self.dim == 2:
            return [(0, 1)] + core, ([0],) + tuple(share)
        end = self.o0[0] + self.nout[0]
        if b[0] >= self.zc:  # the planes past the last stencil chunk's, a chunk of them
            z0 = (self.c1[0] + 1 if self.zc else self.o0[0]) + (b[0] - self.zc) * self.chunk
            return [(0, 0)] + core, (list(range(z0, min(z0 + self.chunk, end))),) + tuple(share)
        kb = self.c0[0] + b[0] * self.chunk
        ke = min(kb + self.chunk, self.c1[0])
        z0 = self.o0[0] if b[0] == 0 else kb
        z1 = min(ke + 1, end) if b[0] == self.zc - 1 else ke
        return [(kb, ke)] + core, (list(range(z0, z1)),) + tuple(share)


@lru_cache(maxsize=256)
def _plan(box, ghosts, offsets, n_phys, wave: int, chunk) -> HaloPlan:
    d = len(box)
    lift = lambda v, fill: (fill,) * (3 - d) + tuple(v)  # noqa: E731  (2D: z is the unit axis)
    o0 = lift([g[0] for g in ghosts], 0)
    n = lift(box, 1)
    nout = tuple(m - lo - hi for m, (lo, hi) in zip(n, ((0, 0),) * (3 - d) + tuple(ghosts)))
    m0 = lift([1 - off + lo for off, (lo, _) in zip(offsets, ghosts)], 0)
    m1 = lift([nph - 1 - off + lo for off, nph, (lo, _) in zip(offsets, n_phys, ghosts)], 1)
    c0, c1 = [], []
    for a in range(3):
        s0, s1 = max(m0[a], o0[a]), min(m1[a], o0[a] + nout[a])
        c0.append(s0 if s1 > s0 else o0[a])
        c1.append(s1 if s1 > s0 else o0[a])
    if d == 2:
        c0[0], c1[0] = 0, 1
    tile_x, tile_y, _ = _kernel_constants()
    tiles = lambda a, t: max(1, -(-(c1[a] - c0[a]) // t))  # noqa: E731
    columns = tiles(2, tile_x) * tiles(1, tile_y)
    if d == 2:
        chunk, zc, zblocks = 1, 1, 1
    else:
        planes = c1[0] - c0[0]
        if chunk is None:
            chunk = fill_chunk(columns, planes, wave)
        zc = -(-planes // chunk)
        # the planes past the face the last stencil chunk writes: blocks of their own
        beyond = o0[0] + nout[0] - (c1[0] + 1 if zc else o0[0])
        zblocks = zc + max(0, -(-beyond // chunk))
    return HaloPlan(d, n, o0, nout, m0, m1, tuple(c0), tuple(c1), int(chunk), zc,
                    (zblocks, tiles(1, tile_y), tiles(2, tile_x)))


def halo_plan(box: Tuple[int, ...], ghosts=None, offsets=None, n_phys=None, wave: int = DEFAULT_WAVE,
              chunk=None) -> HaloPlan:
    """The halo form's launch plan on a box of ``box`` nodes (``ghosts``,
    ``offsets``, ``n_phys`` as :func:`halo_geometry` takes them): tiles over
    the owned stencil rows as K1's, and the z chunk by :func:`fill_chunk`
    for a card that holds ``wave`` blocks at once (``chunk``: that chunk)."""
    box = tuple(int(n) for n in box)
    ghosts, offsets, n_phys = halo_geometry(box, ghosts, offsets, n_phys)
    return _plan(box, ghosts, offsets, n_phys, int(wave), None if chunk is None else int(chunk))


def plan_writes(plan: HaloPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Over the owned block (kernel axes), how many times the plan's blocks
    write each node and whether a stencil tile writes it
    (:meth:`HaloPlan.block_writes`)."""
    count = np.zeros(plan.nout, dtype=np.int64)
    stencil = np.zeros(plan.nout, dtype=bool)
    for b in np.ndindex(*plan.blocks):
        core, (planes, ys, xs) = plan.block_writes(b)
        o = plan.o0
        count[np.ix_([z - o[0] for z in planes], range(ys[0] - o[1], ys[1] - o[1]),
                     range(xs[0] - o[2], xs[1] - o[2]))] += 1
        stencil[tuple(slice(lo - oo, hi - oo) for (lo, hi), oo in zip(core, o))] = True
    return count, stencil


# region ids: the owned block, then (kernel axis, side): z low, z high, y
# low, y high, x low, x high
_REGIONS = 7


def _region(fields, shape, origin) -> tuple:
    """A region's row: its two fields (flat), and off, sz, sy such that node
    (z, y, x) of the box is ``field[off + z sz + y sy + x]``, for a region
    of kernel ``shape`` whose first node sits at box ``origin``."""
    sz, sy = shape[1] * shape[2], shape[2]
    return (fields[0].reshape(-1), fields[1].reshape(-1), -(origin[0] * sz + origin[1] * sy + origin[2]), sz, sy)


def _box_regions(plan: HaloPlan, z: torch.Tensor) -> list:
    """The regions of a whole extended box ``z`` (stacked): every one the
    box itself, with the box's strides."""
    whole = _region((z[0], z[1]), plan.box, (0, 0, 0))
    rows = [whole] + [None] * (_REGIONS - 1)
    for a in range(3):
        rows[1 + 2 * a] = whole if plan.o0[a] else None
        rows[2 + 2 * a] = whole if plan.box[a] - plan.o0[a] - plan.nout[a] else None
    return rows


def _plane_regions(plan: HaloPlan, z1, z2, planes) -> list:
    """The regions of an owned block ``(z1, z2)`` and its received
    ``planes`` (per split grid axis, ``(below, above)`` stacked tensors or
    None): the plane of axis k spans the ghost layers of the axes before
    it, one plane along k and the owned block along the axes after."""
    lead = 3 - z1.dim()
    rows = [_region((z1, z2), plan.nout, plan.o0)] + [None] * (_REGIONS - 1)
    for k, pair in enumerate(planes):
        a = lead + k
        shape = list(plan.box[:a]) + [1] + list(plan.nout[a + 1:])
        for side, g in enumerate(pair):
            if g is None:
                continue
            origin = [0] * a + [0 if side == 0 else plan.box[a] - 1] + list(plan.o0[a + 1:])
            rows[1 + 2 * a + side] = _region((g[0], g[1]), shape, origin)
    return rows


def _gather_box(plan: HaloPlan, rows: list, dtype, device) -> torch.Tensor:
    """The stacked box (kernel axes) as the kernel reads it: each node from
    the region of the last axis on which it is a ghost (else the owned
    block), at the region's row's address; zeros from a missing region."""
    box = torch.zeros((2,) + plan.box, dtype=dtype, device=device)
    for r, row in enumerate(rows):
        if row is None:
            continue
        ranges = [(o, o + n) for o, n in zip(plan.o0, plan.nout)]
        if r:
            a, side = divmod(r - 1, 2)
            ranges[a] = (0, plan.o0[a]) if side == 0 else (plan.o0[a] + plan.nout[a], plan.box[a])
            ranges[:a] = [(0, n) for n in plan.box[:a]]
        z, y, x = (torch.arange(lo, hi, device=device) for lo, hi in ranges)
        idx = row[2] + z[:, None, None] * row[3] + y[None, :, None] * row[4] + x[None, None, :]
        at = tuple(slice(lo, hi) for lo, hi in ranges)
        for f in range(2):
            box[(f,) + at] = row[f][idx]
    return box


def _halo_args(plan: HaloPlan, rows: list, S, mode: str, dtype, device, d: int):
    """The halo launcher's symbol and arguments (but the stream) for
    ``plan`` on the regions ``rows``, its output, and the region table the
    arguments point into (keep it until the call)."""
    y = torch.empty((2,) + plan.nout[3 - d:], dtype=dtype, device=device)
    table = np.zeros((_REGIONS, 5), dtype=np.int64)
    for r, row in enumerate(rows):
        if row is not None:
            table[r] = (row[0].data_ptr(), row[1].data_ptr(), row[2], row[3], row[4])
        else:  # a missing region keeps its partner's strides
            partner = rows[r + 1 if r % 2 else r - 1] if r else None
            if partner is not None:
                table[r, 3:] = partner[3], partner[4]
    symbol = "perphil_dpp_apply_halo_f64" if dtype == torch.float64 else "perphil_dpp_apply_halo_f32"
    half = y.numel() // 2 * y.element_size()
    args = (table.ctypes.data, y.data_ptr(), y.data_ptr() + half, packed_weights(*S).ctypes.data, d, MODES[mode],
            plan.ints.ctypes.data)
    return symbol, args, y, table


def _halo_launch(plan: HaloPlan, rows: list, S, mode: str, dtype, device, d: int) -> torch.Tensor:
    symbol, args, y, _table = _halo_args(plan, rows, S, mode, dtype, device, d)
    _cuda.launch(HALO_KERNEL, symbol, device, *args)
    return y


def _card_plan(box, ghosts, offsets, n_phys, dtype, device) -> HaloPlan:
    wave = halo_wave(device if device.index is not None else torch.device("cuda", torch.cuda.current_device()),
                     dtype, len(box))
    return halo_plan(box, ghosts, offsets, n_phys, wave)


def fused_dpp_apply_halo(
    z: torch.Tensor, S1, S2, C, mode: str = "matvec", ghosts=None, offsets=None, n_phys=None
) -> torch.Tensor:
    """K1's halo form on a whole extended box: the stacked ``(2, *box)``
    block of a decomposed or padded 2D/3D grid with its ghost planes around
    it, f32 or f64; the stacked owned block of the BC-eliminated operator
    (``mode="matvec"``) or of the lift (``mode="lift"``). The kernel reads
    the box through its regions (:func:`fused_dpp_apply_halo_planes` reads
    received planes where they lie).

    :param ghosts: per axis ``(low, high)`` ghost widths, 0 or 1; the ghost
        planes hold the neighbours' raw values (zeros beyond the grid).
    :param offsets: per axis the global index of the first owned node.
    :param n_phys: the physical node extents; owned nodes at or beyond
        ``n_phys - 1`` are boundary (phantom) rows.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    _check(z, 1)
    box = tuple(z.shape[1:])
    ghosts, offsets, n_phys = halo_geometry(box, ghosts, offsets, n_phys)
    if z.device.type == "cpu":
        return fused_dpp_apply_halo_plain(z, S1, S2, C, mode, ghosts, offsets, n_phys)
    _cuda.require_cuda_tensor(z, "z", z.dtype, z.device)
    plan = _card_plan(box, ghosts, offsets, n_phys, z.dtype, z.device)
    return _halo_launch(plan, _box_regions(plan, z), (S1, S2, C), mode, z.dtype, z.device, len(box))


def _planes_geometry(z1: torch.Tensor, z2: torch.Tensor, planes, offsets, n_phys):
    """Check the planes entry's arguments; its box and geometry."""
    if z1.shape != z2.shape:
        raise ValueError(f"need two equal 2D/3D grids, got {tuple(z1.shape)}, {tuple(z2.shape)}")
    _check(z1, 0)
    owned = tuple(z1.shape)
    planes = tuple(tuple(pair) for pair in planes)
    if len(planes) > len(owned) or any(len(pair) != 2 for pair in planes):
        raise ValueError(f"need a (below, above) pair for each of the first split axes, got {len(planes)}")
    ghosts = tuple((1, 1) if k < len(planes) else (0, 0) for k in range(len(owned)))
    box = tuple(n + lo + hi for n, (lo, hi) in zip(owned, ghosts))
    for k, pair in enumerate(planes):
        want = (2,) + box[:k] + (1,) + owned[k + 1:]
        for g in pair:
            if g is not None and (tuple(g.shape) != want or g.dtype != z1.dtype or g.device != z1.device
                                  or not g.is_contiguous()):
                raise ValueError(f"axis {k}: a received plane must be a contiguous {z1.dtype} {want} on "
                                 f"{z1.device}, got {tuple(g.shape)} {g.dtype} on {g.device}")
    return planes, box, halo_geometry(box, ghosts, offsets, n_phys)


def fused_dpp_apply_halo_planes_plain(
    z1: torch.Tensor, z2: torch.Tensor, planes, S1, S2, C, mode: str = "matvec", offsets=None, n_phys=None
) -> torch.Tensor:
    """Plain PyTorch twin of the planes entry (any device): the box read
    from the regions as the kernel reads it (:func:`_gather_box`), then the
    whole-box twin."""
    planes, box, (ghosts, offsets, n_phys) = _planes_geometry(z1, z2, planes, offsets, n_phys)
    plan = halo_plan(box, ghosts, offsets, n_phys)
    zb = _gather_box(plan, _plane_regions(plan, z1, z2, planes), z1.dtype, z1.device)
    return fused_dpp_apply_halo_plain(zb.reshape((2,) + box), S1, S2, C, mode, ghosts, offsets, n_phys)


def fused_dpp_apply_halo_planes(
    z1: torch.Tensor, z2: torch.Tensor, planes, S1, S2, C, mode: str = "matvec", offsets=None, n_phys=None
) -> torch.Tensor:
    """K1's halo form on an owned block and the planes its neighbours sent,
    read where they lie (no extended box is built): the stacked owned block
    of the BC-eliminated operator (``mode="matvec"``) or of the lift
    (``mode="lift"``), 2D/3D, f32 or f64.

    :param z1, z2: the owned block's two fields, each contiguous.
    :param planes: per split grid axis (the first ``len(planes)`` axes; each
        has a ghost plane on either side) ``(below, above)``: the stacked
        contiguous plane received from the lower and the upper neighbour,
        of shape ``(2, *box[:k], 1, *owned[k + 1:])`` (the exchange goes
        axis by axis, so it spans the earlier axes' ghost layers), or None
        where there is no neighbour (the kernel reads zeros).
    :param offsets, n_phys: as :func:`fused_dpp_apply_halo` takes them.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    planes, box, (ghosts, offsets, n_phys) = _planes_geometry(z1, z2, planes, offsets, n_phys)
    if z1.device.type == "cpu":
        return fused_dpp_apply_halo_planes_plain(z1, z2, planes, S1, S2, C, mode, offsets, n_phys)
    for name, t in (("z1", z1), ("z2", z2)):
        _cuda.require_cuda_tensor(t, name, z1.dtype, z1.device)
    plan = _card_plan(box, ghosts, offsets, n_phys, z1.dtype, z1.device)
    return _halo_launch(plan, _plane_regions(plan, z1, z2, planes), (S1, S2, C), mode, z1.dtype, z1.device,
                        len(box))


def halo_probe_library():
    """``csrc/profile/dpp_apply_halo_box.cu`` built alone: the first halo
    form, which reads one whole extended box and tiles the owned block
    (``perphil_dpp_apply_halo_box_f64`` / ``_f32``), kept to be timed in
    turns with the package's kernel (:func:`halo_probe_apply`). A
    measurement build: its launches are counted nowhere."""
    sig = [_cuda._P] * 5 + [_cuda._I] * 5 + [_cuda._P, _cuda._P]
    return _cuda.variant_library("profile/dpp_apply_halo_box.cu", "PERPHIL_HALO_PROBE",
                                 {"perphil_dpp_apply_halo_box_f64": sig, "perphil_dpp_apply_halo_box_f32": sig})


def halo_probe_apply(dll, z: torch.Tensor, S, mode: str = "matvec", ghosts=None, offsets=None,
                     n_phys=None) -> torch.Tensor:
    """The first halo form (``dll``: :func:`halo_probe_library`) on a whole
    stacked extended box ``z`` on the card: the stacked owned block."""
    box = tuple(z.shape[1:])
    ghosts, offsets, n_phys = halo_geometry(box, ghosts, offsets, n_phys)
    owned = tuple(n - lo - hi for n, (lo, hi) in zip(box, ghosts))
    y = torch.empty((2,) + owned, dtype=z.dtype, device=z.device)
    pad = 3 - len(box)
    lift = lambda v, fill: (fill,) * pad + tuple(v)  # noqa: E731
    geom = np.array(lift([g[0] for g in ghosts], 0) + lift([g[1] for g in ghosts], 0) + lift(offsets, 0)
                    + lift(n_phys, 1), dtype=np.int32)
    nz, ny, nx = (1,) * pad + box
    fn = dll.perphil_dpp_apply_halo_box_f64 if z.dtype == torch.float64 else dll.perphil_dpp_apply_halo_box_f32
    _cuda.check(fn(z.data_ptr(), z.data_ptr() + z.numel() // 2 * z.element_size(), y.data_ptr(),
                   y.data_ptr() + y.numel() // 2 * y.element_size(), packed_weights(*S).ctypes.data, nz, ny, nx,
                   len(box), MODES[mode], geom.ctypes.data, torch.cuda.current_stream(z.device).cuda_stream),
                "perphil_dpp_apply_halo_box")
    return y
