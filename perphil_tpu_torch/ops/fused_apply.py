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

:func:`fused_dpp_apply_halo` is K1's halo form, for one block of a grid that
is decomposed over ranks or padded with phantom nodes: the input box may
carry a ghost plane on either side of each axis (read as stencil
neighbours, never written), the output is the owned block, and a node is a
boundary (identity) row when its global index is 0 or at least
``n_phys - 1`` on some axis. Its twin is :func:`fused_dpp_apply_halo_plain`.
With no ghost, no offset and no padding it is the whole-grid apply.
"""

from __future__ import annotations

from functools import lru_cache
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


def fused_dpp_apply_halo(
    z: torch.Tensor, S1, S2, C, mode: str = "matvec", ghosts=None, offsets=None, n_phys=None
) -> torch.Tensor:
    """K1's halo form on a stacked ``(2, *box)`` block of a decomposed or
    padded 2D/3D grid, f32 or f64: the stacked owned block of the
    BC-eliminated operator (``mode="matvec"``) or of the lift
    (``mode="lift"``).

    :param ghosts: per axis ``(low, high)`` ghost widths, 0 or 1; the ghost
        planes hold the neighbours' raw values (zeros beyond the grid).
    :param offsets: per axis the global index of the first owned node.
    :param n_phys: the physical node extents; owned nodes at or beyond
        ``n_phys - 1`` are boundary (phantom) rows.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    _check(z, 1)
    ghosts, offsets, n_phys = halo_geometry(tuple(z.shape[1:]), ghosts, offsets, n_phys)
    if z.device.type == "cpu":
        return fused_dpp_apply_halo_plain(z, S1, S2, C, mode, ghosts, offsets, n_phys)
    _cuda.require_cuda_tensor(z, "z", z.dtype, z.device)
    owned = tuple(n - lo - hi for n, (lo, hi) in zip(z.shape[1:], ghosts))
    y = torch.empty((2,) + owned, dtype=z.dtype, device=z.device)
    if y.numel() == 0:
        return y
    pad = 3 - len(owned)
    lift3 = lambda v, fill: (fill,) * pad + tuple(v)  # noqa: E731  (2D: z is the unit axis)
    geom = np.array(
        lift3([g[0] for g in ghosts], 0) + lift3([g[1] for g in ghosts], 0) + lift3(offsets, 0) + lift3(n_phys, 1),
        dtype=np.int32,
    )
    nz, ny, nx = (1,) * pad + tuple(z.shape[1:])
    symbol = "perphil_dpp_apply_halo_f64" if z.dtype == torch.float64 else "perphil_dpp_apply_halo_f32"
    half_in = z.numel() // 2 * z.element_size()
    half_out = y.numel() // 2 * y.element_size()
    _cuda.launch(
        HALO_KERNEL, symbol, z.device, z.data_ptr(), z.data_ptr() + half_in, y.data_ptr(), y.data_ptr() + half_out,
        packed_weights(S1, S2, C).ctypes.data, nz, ny, nx, len(owned), MODES[mode], geom.ctypes.data,
    )
    return y
