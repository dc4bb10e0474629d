"""Exact fast direct solvers via tensor-product fast diagonalization.

Counterpart of ``perphil_tpu/ops/direct.py``. On uniform quad/hex meshes the
interior (Dirichlet-eliminated) Q1 operators are tensor products of 1D
tridiagonal stiffness/mass pairs; the generalized eigenproblem
``K1 S = M1 S diag(lam)`` (host scipy) diagonalizes every block, so a solve
is d small dense products per direction plus a diagonal scaling. The
monolithic 2-field DPP system shares one eigenbasis across both fields and
decouples into 2x2 systems per mode.

On simplicial meshes the same machinery built from the lumped mass is a
spectrally-equivalent preconditioner (``lumped=True``).

The solvers are ``nn.Module``s whose buffers (per-axis eigenvectors and
per-mode coefficients) live on the device they were built for, in the dtype
they were built with. The transforms are ``torch.tensordot`` products (the
JAX package leaves them to XLA outside any kernel).

On blocks (the sharded path, ``parallel/sharding.py``): each solver's
``solve_blocks`` runs on the blocks of its node grid, phantom-padded to
divisibility, that a process holds (``parallel/transpose.py``:
``RankBlocks``, ``LoopbackBlocks``). The 1D eigenvector matrices are
extended to the padded node axis with zero rows and columns at the
boundary and phantom indices (:class:`FastDiagBlocks`), so a transform of
the whole padded grid is the interior transform and nothing of the
boundary enters it; each axis is contracted while it is whole, the mesh
axes that split it moved to another axis by all-to-all transposes, and the
mode data are sliced to the layout the forward transform ends in. Boundary
and phantom rows pass ``b`` through, as ``solve`` does.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.linalg
import torch
from torch import nn

from perphil_tpu_torch.config import DeviceLike, default_dtype, resolve_device
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters

Blocks = Dict[Tuple[int, ...], torch.Tensor]


@lru_cache(maxsize=None)
def _interior_eig_1d(n_cells: int, h: float, lumped: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized eigenpairs of the interior 1D (K, M) pair (host scipy).

    Returns (S, lam) with S^T M S = I and K S = M S diag(lam); ``lumped``
    replaces the consistent M1 by diag(h).
    """
    m = n_cells - 1
    if m < 1:
        raise ValueError("Fast diagonalization needs at least one interior node")
    K = (np.diag(np.full(m, 2.0)) - np.diag(np.ones(m - 1), 1) - np.diag(np.ones(m - 1), -1)) / h
    if lumped:
        M = np.eye(m) * h
    else:
        M = (np.diag(np.full(m, 4.0)) + np.diag(np.ones(m - 1), 1) + np.diag(np.ones(m - 1), -1)) * (h / 6.0)
    lam, S = scipy.linalg.eigh(K, M)
    return np.ascontiguousarray(S), np.ascontiguousarray(lam)


def _transform(f: torch.Tensor, mats: List[torch.Tensor], transpose: bool) -> torch.Tensor:
    """Apply per-axis matrices (S or S^T) to a grid tensor.

    ``mats`` are coordinate-ordered (x first); grid axes are slowest first,
    so grid axis ``a`` uses ``mats[d-1-a]``.
    """
    d = f.dim()
    out = f
    for ax in range(d):
        S = mats[d - 1 - ax].to(f.dtype)
        out = torch.movedim(torch.tensordot(S.T if transpose else S, out, dims=([1], [ax])), 0, ax)
    return out


def _lam_sum(eig) -> np.ndarray:
    """sum_i lam_i on the interior mode grid (slowest axis first)."""
    lams = [lam for (_, lam) in eig]
    d = len(lams)
    lam_sum = np.zeros(tuple(len(l) for l in reversed(lams)))
    for ax in range(d):
        shape = [1] * d
        shape[ax] = len(lams[d - 1 - ax])
        lam_sum = lam_sum + lams[d - 1 - ax].reshape(shape)
    return lam_sum


def extended_modes(a: np.ndarray, node_shape: Sequence[int], grid: Sequence[int]) -> np.ndarray:
    """Interior mode data ``a`` (one entry an interior mode) on the padded
    node grid ``grid`` with one more entry an axis: 1 at every other mode
    (boundary, phantom, and the last entry, which index -1 of a padded
    layout reads)."""
    out = np.ones(tuple(int(n) + 1 for n in grid))
    out[tuple(slice(1, n - 1) for n in node_shape)] = a
    return out


class FastDiagBlocks:
    """The per-axis transforms of a fast-diag solve on the blocks ``blocks``
    holds of a node lattice ``node_shape`` padded by ``padding``; ``bases``
    holds, per grid axis, the interior eigenvector matrix of that axis (its
    1D generalised eigenproblem, interior rows and modes): Q1's
    ``solver.eig`` (:meth:`of`), or a degree-p lattice's
    (``ops/tensorfem.py::interior_eig_1d``).

    Each ``S`` is extended to the padded node axis with zeros:
    ``E[1:n-1, 1:n-1] = S``. The forward transform ``E^T`` then reads only
    interior nodes and writes zeros at the boundary and phantom modes, the
    backward ``E`` writes zeros at the boundary and phantom nodes. Axes are
    contracted in the order of ``parallel/transpose.py::transform_plan``,
    the backward transform undoing the forward's moves in reverse."""

    def __init__(self, bases: Sequence[np.ndarray], node_shape: Sequence[int], padding: Sequence[int], blocks,
                 dtype: torch.dtype, device: torch.device):
        from perphil_tpu_torch.parallel.transpose import layout_index, transform_plan

        self.node_shape = tuple(int(n) for n in node_shape)
        padding = tuple(padding) or (0,) * len(self.node_shape)
        self.grid = tuple(n + p for n, p in zip(self.node_shape, padding))
        self.blocks = blocks
        self.E = []
        for S, n, N in zip(bases, self.node_shape, self.grid):
            E = np.zeros((N, N))
            E[1:n - 1, 1:n - 1] = S
            self.E.append(torch.as_tensor(E, dtype=dtype, device=device))
        self.steps, splits = transform_plan(self.grid, blocks.mesh_shape)
        self.at = {c: np.ix_(*layout_index(self.grid, splits, c, blocks.mesh_shape)) for c in blocks.coords}
        interior = np.zeros(self.grid, dtype=bool)
        interior[tuple(slice(1, n - 1) for n in self.node_shape)] = True
        self.interior = blocks.cut(torch.as_tensor(interior, device=device))
        self.dtype, self.device = dtype, device

    @classmethod
    def of(cls, solver: "_FastDiagBase", padding: Sequence[int], blocks) -> "FastDiagBlocks":
        """The transforms of a Q1 fast-diag solver (``solver.eig``) on its
        mesh's node grid."""
        d = solver.mesh.dim
        return cls([solver.eig[d - 1 - a][0] for a in range(d)], solver.mesh.node_shape, padding, blocks,
                   solver.dtype, solver.S0.device)

    def modes(self, a) -> Blocks:
        """Interior mode data (array or tensor, one entry a mode) sliced to
        each block's layout after the forward transform."""
        ext = extended_modes(np.asarray(torch.as_tensor(a).cpu()), self.node_shape, self.grid)
        return {c: torch.as_tensor(np.ascontiguousarray(ext[at]), dtype=self.dtype, device=self.device)
                for c, at in self.at.items()}

    def _contract(self, x: torch.Tensor, a: int, lead: int, forward: bool) -> torch.Tensor:
        E = self.E[a].to(x.dtype)
        return torch.movedim(torch.tensordot(E.T if forward else E, x, dims=([1], [lead + a])), 0, lead + a)

    def forward(self, xs: Blocks, lead: int = 0) -> Blocks:
        for step in self.steps:
            if isinstance(step, tuple) and step[0] == "contract":
                xs = {c: self._contract(x, step[1], lead, True) for c, x in xs.items()}
            else:
                xs = self.blocks.regrid(xs, step, lead)
        return xs

    def backward(self, xs: Blocks, lead: int = 0) -> Blocks:
        for step in reversed(self.steps):
            if isinstance(step, tuple) and step[0] == "contract":
                xs = {c: self._contract(x, step[1], lead, False) for c, x in xs.items()}
            else:
                xs = self.blocks.regrid(xs, step.inverse(), lead)
        return xs

    def passthrough(self, u: Blocks, b: Blocks) -> Blocks:
        """``u`` on interior rows, ``b`` on boundary and phantom rows."""
        return {c: torch.where(self.interior[c], u[c], b[c]) for c in u}


def _fd_blocks(solver: "_FastDiagBase", blocks, padding: Sequence[int]) -> FastDiagBlocks:
    return blocks.built(("fastdiag", solver, tuple(padding)), lambda: FastDiagBlocks.of(solver, padding, blocks))


class _FastDiagBase(nn.Module):
    """Per-axis eigenvector buffers ``S0`` (x), ``S1`` (y)[, ``S2`` (z)]."""

    def __init__(self, mesh: StructuredMesh, lumped: bool, device: DeviceLike, dtype: torch.dtype):
        super().__init__()
        self.mesh = mesh
        self.eig = tuple(_interior_eig_1d(n, hi, lumped) for n, hi in zip(mesh.cells, mesh.h))
        self._device = resolve_device(device)
        self.dtype = dtype
        for a, (S, _) in enumerate(self.eig):
            self.register_buffer(f"S{a}", self._tensor(S))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self._device)

    @property
    def mats(self) -> List[torch.Tensor]:
        return [getattr(self, f"S{a}") for a in range(self.mesh.dim)]

    @property
    def inner(self) -> Tuple[slice, ...]:
        return tuple(slice(1, n - 1) for n in self.mesh.node_shape)


class FastDiagFieldSolver(_FastDiagBase):
    """Exact interior solve of one block ``(k/mu) K + (beta/mu) M`` on a
    tensor-product mesh, or (``lumped=True``) its lumped-mass proxy, the
    simplicial preconditioner. Buffer ``mode_scale`` on the interior grid."""

    def __init__(
        self,
        mesh: StructuredMesh,
        k: float,
        beta: float,
        mu: float,
        lumped: bool = False,
        device: DeviceLike = None,
        dtype: torch.dtype = default_dtype(),
    ):
        if not (mesh.is_tensor_product or lumped):
            raise ValueError(
                "Exact fast diagonalization needs quad/hex cells; "
                "use lumped=True for the simplicial proxy preconditioner"
            )
        super().__init__(mesh, lumped, device, dtype)
        self.register_buffer("mode_scale", self._tensor((k / mu) * _lam_sum(self.eig) + (beta / mu)))

    def solve_interior(self, f: torch.Tensor) -> torch.Tensor:
        fhat = _transform(f, self.mats, transpose=True) / self.mode_scale.to(f.dtype)
        return _transform(fhat, self.mats, transpose=False)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Solve the BC-eliminated block on the full node grid: boundary
        entries pass through (identity rows), the interior is solved."""
        out = b.clone()
        out[self.inner] = self.solve_interior(b[self.inner])
        return out

    def solve_blocks(self, bs: Blocks, blocks, padding: Sequence[int] = ()) -> Blocks:
        """:meth:`solve` on the blocks ``blocks`` holds of the node grid
        padded by ``padding`` (:class:`FastDiagBlocks`)."""
        fb = _fd_blocks(self, blocks, padding)
        scale = blocks.built(("scale", self, tuple(padding)), lambda: fb.modes(self.mode_scale))
        bh = fb.forward({c: b.to(self.dtype) for c, b in bs.items()})
        u = fb.backward({c: v / scale[c] for c, v in bh.items()})
        return fb.passthrough(u, bs)


def field_pair_blocks(pc0: FastDiagFieldSolver, pc1: FastDiagFieldSolver, blocks, padding: Sequence[int] = ()):
    """Two field solves on one mesh (stacked ``(2, *grid)`` blocks: field 0
    by ``pc0``, field 1 by ``pc1``) on shared transforms, both fields in
    every transpose: ``bs -> zs`` on the blocks ``blocks`` holds."""
    if any(e0[0] is not e1[0] for e0, e1 in zip(pc0.eig, pc1.eig)):
        raise ValueError("the two field solvers need the same eigenbasis")
    fb = _fd_blocks(pc0, blocks, padding)
    scale = blocks.built(("pair", pc0, pc1, tuple(padding)), lambda: {
        c: torch.stack([a, b]) for (c, a), b in zip(fb.modes(pc0.mode_scale).items(),
                                                    fb.modes(pc1.mode_scale).values())})

    def solve(bs: Blocks) -> Blocks:
        bh = fb.forward({c: b.to(pc0.dtype) for c, b in bs.items()}, lead=1)
        u = fb.backward({c: v / scale[c] for c, v in bh.items()}, lead=1)
        return {c: torch.where(fb.interior[c], u[c], bs[c]) for c in u}

    return solve


class LumpedDPPPreconditioner(nn.Module):
    """Block-diagonal lumped fast-diag preconditioner of the monolithic
    simplicial system: one lumped field solve per field on the interior,
    identity on the boundary. Acts on stacked ``(2, *node_shape)`` grids."""

    def __init__(self, mesh: StructuredMesh, params: DPPParameters, device: DeviceLike = None):
        super().__init__()
        p = params
        self.pc1 = FastDiagFieldSolver(mesh, p.k1, p.beta, p.mu, lumped=True, device=device)
        self.pc2 = FastDiagFieldSolver(mesh, p.k2, p.beta, p.mu, lumped=True, device=device)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.pc1.solve(r[0]), self.pc2.solve(r[1])])

    def solve_blocks(self, rs: Blocks, blocks, padding: Sequence[int] = ()) -> Blocks:
        """:meth:`forward` on stacked blocks (:func:`field_pair_blocks`)."""
        return blocks.built(("lumped", self, tuple(padding)),
                            lambda: field_pair_blocks(self.pc1, self.pc2, blocks, padding))(rs)


class FastDiagDPPSolver(_FastDiagBase):
    """Exact direct solve of the monolithic 2-field DPP system on a
    tensor-product mesh. After the forward transforms the system decouples
    into per-mode 2x2 solves

        [[ (k1 lam + beta)/mu,      -beta/mu      ] [u1]   [f1]
         [      -beta/mu,       (k2 lam + beta)/mu]] [u2] = [f2]

    Buffers ``a11``, ``a22`` and ``det`` on the interior mode grid.
    """

    def __init__(
        self,
        mesh: StructuredMesh,
        params: DPPParameters,
        device: DeviceLike = None,
        dtype: torch.dtype = default_dtype(),
    ):
        if not mesh.is_tensor_product:
            raise ValueError("Exact fast diagonalization needs quad/hex cells")
        super().__init__(mesh, False, device, dtype)
        self.params = params
        lam_sum = _lam_sum(self.eig)
        p = params
        a11 = (p.k1 * lam_sum + p.beta) / p.mu
        a22 = (p.k2 * lam_sum + p.beta) / p.mu
        self.a12 = -p.beta / p.mu
        self.register_buffer("a11", self._tensor(a11))
        self.register_buffer("a22", self._tensor(a22))
        self.register_buffer("det", self._tensor(a11 * a22 - self.a12 * self.a12))

    def solve_interior(
        self, f1: torch.Tensor, f2: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        a11, a22, det = (t.to(f1.dtype) for t in (self.a11, self.a22, self.det))
        a12 = self.a12
        f1h = _transform(f1, self.mats, transpose=True)
        f2h = _transform(f2, self.mats, transpose=True)
        u1h = (a22 * f1h - a12 * f2h) / det
        u2h = (a11 * f2h - a12 * f1h) / det
        return (
            _transform(u1h, self.mats, transpose=False),
            _transform(u2h, self.mats, transpose=False),
        )

    def solve(
        self, b1: torch.Tensor, b2: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        z1i, z2i = self.solve_interior(b1[self.inner], b2[self.inner])
        z1, z2 = b1.clone(), b2.clone()
        z1[self.inner] = z1i
        z2[self.inner] = z2i
        return z1, z2

    def solve_blocks(self, bs: Blocks, blocks, padding: Sequence[int] = ()) -> Blocks:
        """:meth:`solve` on stacked ``(2, *grid)`` blocks of the node grid
        padded by ``padding``: both fields in every transform and transpose,
        the per-mode 2x2 solve in the forward transform's layout."""
        fb = _fd_blocks(self, blocks, padding)
        a11, a22, det = blocks.built(("dpp", self, tuple(padding)),
                                     lambda: [fb.modes(t) for t in (self.a11, self.a22, self.det)])
        a12 = self.a12
        fh = fb.forward({c: b.to(self.dtype) for c, b in bs.items()}, lead=1)
        uh = {c: torch.stack([(a22[c] * f[0] - a12 * f[1]) / det[c], (a11[c] * f[1] - a12 * f[0]) / det[c]])
              for c, f in fh.items()}
        return fb.passthrough(fb.backward(uh, lead=1), {c: b.to(self.dtype) for c, b in bs.items()})
