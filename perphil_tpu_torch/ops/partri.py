"""Parallel-prefix (scan-tree) exact triangular solves on structured grids.

Counterpart of ``perphil_tpu/ops/partri.py``, the JAX package's default
trisolve of every host ILU apply and every lexicographic Gauss-Seidel sweep
(``ops/ilu.py::PartriILU``, ``PartriGS``).

A lower-triangular solve on a structured grid in lexicographic order is a
first-order affine recurrence over rows (2D) or planes (3D):

    2D:  x[y] = T_y (c[y] + B_y x[y-1])     (T_y the within-row bidiagonal
                                             inverse, B_y the three cross-row
                                             couplings)
    3D:  x[z] = T_z (c[z] + B_z x[z-1])     (T_z the within-plane 2D solve,
                                             B_z the nine cross-plane
                                             couplings)

i.e. ``x_t = M_t x_{t-1} + g_t`` with maps ``M_t = T_t B_t`` fixed by the
factor. Affine maps compose associatively,

    (M2, g2) o (M1, g1) = (M2 M1, M2 g1 + g2),

so every x_t follows from a parallel prefix scan: the tree's composed maps
are built once, and a solve is ~2 log2(n) dependent stages of batched
mat-vecs (the up-sweep and the down-sweep) instead of one step a wavefront
level. Within a row the maps are scalars and the same tree is vector
arithmetic. In 3D the plane maps are dense ``(ny nx)^2`` matrices, built by
applying the z-batched 2D solver to the cross-plane couplings.

Everything is f64 torch ops on the tensors' device (``torch.matmul`` for the
tree's products, as the JAX package forms them with ``einsum`` outside any
Pallas kernel). Internally the recurrence carries a trailing column axis, so
one tree applies to many right-hand sides at once (the 3D densification).

The grouped 2D pass (``GridTriSolve2D(..., group=G)``, the JAX package's
``PERPHIL_TPU_PARTRI_GROUP``; the solver option ``partri_group``) keeps only
one composite map a group of G rows and re-derives the rows inside a group
from the banded coefficients: two passes of G dependent row steps and one
chain over the groups, the same recurrence in another order.

Not ported: the bf16 storage of the maps (``weight_dtype``, the TPU's df32
mode; here the maps are f64).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _unit_bidiag_solve(wr: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``(I - diag(wr, -1)) M = B`` along the row axis, exactly.

    ``wr``: ``(*batch, ny, nx)``; ``B``: ``(*batch, ny, nx, ncol)``. The row
    recurrence ``M[i] = B[i] + wr[i] * M[i-1]``, one step an entry of the
    row (set-up only)."""
    M = torch.empty_like(B)
    prev = torch.zeros_like(B[..., 0, :])
    for i in range(B.shape[-2]):
        prev = B[..., i, :] + wr[..., i, None] * prev
        M[..., i, :] = prev
    return M


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Interleave along axis 0: [e0, o0, e1, o1, ...]."""
    return torch.stack([even, odd], dim=1).reshape((2 * even.shape[0],) + tuple(even.shape[1:]))


def nbytes(module: nn.Module) -> int:
    """Bytes of a module's buffers: for a trisolve, what one apply reads."""
    return sum(b.numel() * b.element_size() for b in module.buffers())


class AffineChainScan(nn.Module):
    """Exact solver of ``x_t = M_t x_{t-1} + g_t`` (t = 0..n-1, x_{-1} = 0).

    :param M: ``(n, *batch, m, m)`` maps (``M[0]`` is taken as zero: row 0
        has no predecessor); for scalar chains ``(n, *batch)`` with
        ``scalar=True``.

    The tree is work-efficient: at each level adjacent elements pair up and
    an odd element at the end is carried to the next level. Level i stores
    its even elements' segment maps (buffer ``even{i}``, the down-sweep's)
    and its odd ones' (``odd{i}``, both sweeps'): ~2n maps in all.
    """

    def __init__(self, M: torch.Tensor, scalar: bool = False):
        super().__init__()
        self.scalar = bool(scalar)
        self.n = int(M.shape[0])
        S = torch.cat([torch.zeros_like(M[:1]), M[1:]]) if self.n > 1 else torch.zeros_like(M[:1])
        self.level_tails: List[bool] = []
        while S.shape[0] > 1:
            k = int(S.shape[0]) // 2
            odd_tail = int(S.shape[0]) % 2 == 1
            S_even, S_odd = S[0 : 2 * k : 2], S[1 : 2 * k : 2]
            lv = len(self.level_tails)
            self.register_buffer(f"even{lv}", S_even.contiguous())
            self.register_buffer(f"odd{lv}", S_odd.contiguous())
            self.level_tails.append(odd_tail)
            S_next = S_odd * S_even if self.scalar else torch.matmul(S_odd, S_even)
            S = torch.cat([S_next, S[-1:]]) if odd_tail else S_next

    @property
    def level_mats(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per level, (even, odd) segment maps."""
        return [(getattr(self, f"even{i}"), getattr(self, f"odd{i}")) for i in range(len(self.level_tails))]

    def _mv(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        # v carries a trailing column axis: (k, *batch[, m], E)
        return a[..., None] * v if self.scalar else torch.matmul(a, v)

    def apply_columns(self, g: torch.Tensor) -> torch.Tensor:
        """All prefix states for right-hand sides with a trailing column
        axis: ``g`` ``(n, *batch[, m], E)``."""
        saved: List[torch.Tensor] = []
        v = g
        # up-sweep: combine pairs; keep each level's input for the down-sweep
        for (S_even, S_odd), odd_tail in zip(self.level_mats, self.level_tails):
            k = S_even.shape[0]
            saved.append(v)
            v_pair = self._mv(S_odd, v[0 : 2 * k : 2]) + v[1 : 2 * k : 2]
            v = torch.cat([v_pair, v[-1:]]) if odd_tail else v_pair
        y = v  # the single-element inclusive scan
        # down-sweep: expand coarse inclusive results back to fine positions
        for (S_even, _), odd_tail, v_orig in zip(
            reversed(self.level_mats), reversed(self.level_tails), reversed(saved)
        ):
            k = S_even.shape[0]
            y_odd = y[:k]  # inclusive results at the fine odd positions
            # even positions: x_{2i} = S_{2i} x_{2i-1} + v_{2i}; i = 0 has no predecessor
            if k > 1:
                rest = self._mv(S_even[1:], y_odd[:-1]) + v_orig[2 : 2 * k : 2]
                y_even = torch.cat([v_orig[0:1], rest])
            else:
                y_even = v_orig[0:1]
            y_fine = _interleave(y_even, y_odd)
            y = torch.cat([y_fine, y[k : k + 1]]) if odd_tail else y_fine
        return y

    def apply(self, g: torch.Tensor) -> torch.Tensor:
        """All prefix states: ``x[t]`` the recurrence's solution at step t,
        for ``g`` ``(n, *batch, m)`` (``(n, *batch)`` scalar)."""
        return self.apply_columns(g[..., None])[..., 0]


class GridTriSolve2D(nn.Module):
    """Exact lower-triangular solve of the 2D grid recurrence

        x[y,i] = c[y,i] + wr[y,i] x[y,i-1]
               + bm[y,i] x[y-1,i-1] + b0[y,i] x[y-1,i] + bp[y,i] x[y-1,i+1]

    (out-of-range terms zero; callers encode upper solves by flipping axes
    and pre-dividing by the diagonal). Coefficients may carry leading batch
    axes: ``(*batch, ny, nx)`` f64 tensors on one device.

    The row maps ``M_y = T_y B_y`` are densified once; a solve runs the
    scalar tree within rows, then the affine tree across rows.

    Grouped mode (``group`` G > 0, unbatched, ``ny >= 2 G``; else the tree,
    ``self.G`` 0): rows go in groups of G (the last zero-padded: all-zero
    coefficients decouple a padding row, whose output is cropped). It keeps
    the banded coefficients and per-step row chains of each step inside a
    group, batched over the groups, and one composite map a group,
    ``Mhat_k = M_{kG+G-1} ... M_{kG}`` (``perphil_tpu/ops/partri.py:277-358``):
    ny / G maps of nx^2 in place of the tree's ~2 ny. A solve
    (:meth:`_grouped_apply`) runs the G steps from zero states, chains the
    groups' last rows through the maps one group after another, and runs the
    G steps again from the true boundary states.
    """

    def __init__(self, wr: torch.Tensor, bm: torch.Tensor, b0: torch.Tensor, bp: torch.Tensor, group: int = 0):
        super().__init__()
        self.batch = tuple(wr.shape[:-2])
        ny, nx = int(wr.shape[-2]), int(wr.shape[-1])
        self.ny, self.nx = ny, nx
        if group < 0:
            raise ValueError(f"group {group} < 0")
        grouped = bool(group) and not self.batch and ny >= 2 * group
        self.G = int(group) if grouped else 0
        # within-row scalar chain over x, batched over (*batch, y)
        self.row_scan = AffineChainScan(torch.movedim(wr, -1, 0), scalar=True)
        # dense B_y: (*batch, ny, nx, nx); B[..., y, i, i+d] = b_d[..., y, i]
        i = torch.arange(nx, device=wr.device)
        B = wr.new_zeros(self.batch + (ny, nx, nx))
        B[..., i[1:], i[1:] - 1] = bm[..., 1:]
        B[..., i, i] = b0
        B[..., i[:-1], i[:-1] + 1] = bp[..., :-1]
        # M_y = T_y B_y by the exact sequential row recurrence (set-up only),
        # element axis (y) first for the chain: (ny, *batch, nx, nx)
        M = torch.movedim(_unit_bidiag_solve(wr, B), len(self.batch), 0)
        del B
        if not grouped:
            self.chain = AffineChainScan(M)
            return
        self.chain = None
        G = self.G
        self.ngroups = ngroups = -(-ny // G)
        self.pad = ngroups * G - ny

        def steps(a: torch.Tensor) -> torch.Tensor:  # (ny, nx) zero-padded -> (G, ngroups, nx)
            return F.pad(a, (0, 0, 0, self.pad)).reshape(ngroups, G, nx).transpose(0, 1).contiguous()

        # the banded coefficients of each step inside a group
        self.register_buffer("g_bm", steps(bm))
        self.register_buffer("g_b0", steps(b0))
        self.register_buffer("g_bp", steps(bp))
        # each step's within-row chains, batched over the groups: (nx, ngroups)
        self.g_chains = nn.ModuleList(AffineChainScan(w.transpose(0, 1), scalar=True) for w in steps(wr))
        # Mhat_k for the whole groups; group 0 holds row 0, whose map is
        # zero, and a padded group a padding row's zero map: both Mhat are
        # zero (the chain reads neither: group 0 starts from zero, the last
        # group's end starts nothing)
        whole = ny // G
        Mhat = M.new_zeros((ngroups, nx, nx))
        Mg = M[: whole * G].reshape(whole, G, nx, nx)
        prod = Mg[1:, 0]
        for s in range(1, G):
            prod = torch.matmul(Mg[1:, s], prod)
        Mhat[1:whole] = prod
        self.register_buffer("g_Mhat", Mhat)

    def row_solve(self, c: torch.Tensor) -> torch.Tensor:
        """The within-row bidiagonal systems only, ``(I - L_y) g = c``, for
        ``c`` ``(*batch, ny, nx, E)``."""
        return torch.movedim(self.row_scan.apply_columns(torch.movedim(c, -2, 0)), 0, -2)

    def apply_columns(self, c: torch.Tensor) -> torch.Tensor:
        """Solve for ``x`` given ``c`` of shape ``(*batch, ny, nx, E)``
        (the tree only)."""
        if self.chain is None:
            raise ValueError("the grouped pass solves one right-hand side at a time (apply)")
        g = torch.movedim(self.row_solve(c), -3, 0)  # (ny, *batch, nx, E)
        return torch.movedim(self.chain.apply_columns(g), 0, -3)

    def apply(self, c: torch.Tensor) -> torch.Tensor:
        """Solve for ``x`` given ``c`` of shape ``(*batch, ny, nx)``."""
        if self.chain is None:
            return self._grouped_apply(c)
        return self.apply_columns(c[..., None])[..., 0]

    def _run_pass(self, cp: torch.Tensor, x_start: torch.Tensor, collect: bool):
        """The G steps of every group at once from ``x_start`` (ngroups, nx),
        each group's state one row above it: (the rows if ``collect``, the
        last row)."""
        x_prev, outs = x_start, []
        for s, chain in enumerate(self.g_chains):
            left = F.pad(x_prev[:, :-1], (1, 0))
            right = F.pad(x_prev[:, 1:], (0, 1))
            cc = cp[s] + self.g_bm[s] * left + self.g_b0[s] * x_prev + self.g_bp[s] * right
            x_prev = chain.apply(cc.transpose(0, 1)).transpose(0, 1)
            if collect:
                outs.append(x_prev)
        return outs, x_prev

    def _grouped_apply(self, c: torch.Tensor) -> torch.Tensor:
        """The grouped solve (``perphil_tpu/ops/partri.py:399-440``): the
        homogeneous pass gives each group's last row from a zero start, zb_k;
        the boundary chain xb_k = Mhat_k xb_{k-1} + zb_k runs over the groups
        in order; the second pass runs from the true states above them."""
        G, ngroups, nx = self.G, self.ngroups, self.nx
        cp = F.pad(c, (0, 0, 0, self.pad)).reshape(ngroups, G, nx).transpose(0, 1)  # (G, ngroups, nx)
        _, zb = self._run_pass(cp, c.new_zeros((ngroups, nx)), collect=False)
        xb = [zb[0]]
        for k in range(1, ngroups - 1):  # the last group's end starts nothing
            xb.append(torch.matmul(self.g_Mhat[k], xb[-1]) + zb[k])
        starts = torch.cat([c.new_zeros((1, nx)), torch.stack(xb)])
        outs, _ = self._run_pass(cp, starts, collect=True)
        return torch.stack(outs, dim=1).reshape(ngroups * G, nx)[: self.ny]


class GridTriSolve3D(nn.Module):
    """Exact lower-triangular solve of the 3D grid recurrence over planes:

        x[z] = plane_solve_z( c[z] + sum_{dx,dy} bz[dx,dy][z] * shift(x[z-1]) )

    ``plane2d`` is a z-batched :class:`GridTriSolve2D` (the within-plane
    lower structure); ``bz`` maps coordinate-ordered offsets (dx, dy) to the
    nine cross-plane coefficient grids ``(nz, ny, nx)``.

    The plane maps ``M_z = T_z B_z`` (``(nz, ny nx, ny nx)``) are densified by
    applying the batched 2D solver to the columns of the sparse cross-plane
    couplings, then the affine tree runs over planes.
    """

    def __init__(self, plane2d: GridTriSolve2D, bz: Dict[Tuple[int, int], torch.Tensor]):
        super().__init__()
        self.plane2d = plane2d
        nz = int(plane2d.batch[-1]) if plane2d.batch else 1
        ny, nx = plane2d.ny, plane2d.nx
        self.nz, self.ny, self.nx = nz, ny, nx
        m2 = ny * nx
        some = next(iter(bz.values()))
        dev = some.device
        # dense cross-plane coupling B_z: (nz, m2, m2)
        yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        rows = torch.as_tensor((yy * nx + xx).ravel(), device=dev)
        B = some.new_zeros((nz, m2, m2))
        for (dx, dy), w in bz.items():
            oy, ox = yy + dy, xx + dx
            valid = torch.as_tensor(((oy >= 0) & (oy < ny) & (ox >= 0) & (ox < nx)).ravel(), device=dev)
            cols = torch.as_tensor((np.clip(oy, 0, ny - 1) * nx + np.clip(ox, 0, nx - 1)).ravel(), device=dev)
            B[:, rows, cols] += w.reshape(nz, m2) * valid  # each (row, col) once an offset
        # M_z = T_z B_z: the plane solves of B_z's columns, each column a plane
        # vector over the row index: (nz, ny, nx, m2) -> (nz, m2 rows, m2 cols)
        M = plane2d.apply_columns(B.reshape(nz, ny, nx, m2)).reshape(nz, m2, m2)
        self.chain = AffineChainScan(M)

    def apply(self, c: torch.Tensor) -> torch.Tensor:
        """Solve for ``x`` given ``c`` of shape ``(nz, ny, nx)``."""
        g = self.plane2d.apply(c)
        x = self.chain.apply(g.reshape(self.nz, self.ny * self.nx))
        return x.reshape(self.nz, self.ny, self.nx)


def apply_varcoef_stencil(x: torch.Tensor, coeffs: Dict[Tuple[int, ...], torch.Tensor]) -> torch.Tensor:
    """A variable-coefficient stencil: ``y = sum_o w_o * shift(x, o)``.

    :param coeffs: maps coordinate-ordered offsets ``(dx, dy[, dz])`` to
        weight grids shaped like ``x`` (slowest-first axes). Out-of-range
        shifts read zero; the weights are zero where an offset leaves the
        grid (the factor arrays' ``valid`` mask guarantees it).
    """
    xp = F.pad(x, (1, 1) * x.ndim)
    acc = torch.zeros_like(x)
    for off, w in coeffs.items():
        # the offset is coordinate-ordered (dx, dy, dz); the axes slowest-first
        rev = tuple(int(o) for o in reversed(off))
        acc = acc + w * xp[tuple(slice(1 + o, 1 + o + s) for o, s in zip(rev, x.shape))]
    return acc
