"""Degree-2 (P2) Lagrange operators on structured simplex meshes.

Counterpart of ``perphil_tpu/ops/simplexfem.py``. On the Kuhn-triangulated
meshes of ``ops/element.py`` (2 triangles a square, 6 tets a cube) the P2
DoFs (vertices and edge midpoints) are exactly the nodes of the once-refined
lattice, so P2 fields are grid-shaped tensors of shape ``(2N+1,)^d`` and the
assembled operator is a parity-class stencil: translation-invariant with
period 2, one weight table per node class (``2^d`` classes) and offsets in
``[-2, 2]^d``.

The JAX package builds each offset's weight field from the per-axis index
parities inside its jitted matvec (XLA fuses the chain). Here the weight
fields are built once an operator, with the same arithmetic, and an apply is
the shifted views stacked and summed against them: a few torch ops a stencil
instead of a few hundred. There is no hand-written kernel on this path; the
JAX package has no Pallas kernel for it either.

On blocks (the sharded path, and the single-device solves with the whole
lattice as one block): the whole lattice's weight fields are cut to each
block and read against the block extended by 2 planes a side (the plane
exchange of ``parallel/halo.py``), so a block at any offset reads the
parities of its global indices; with the fixed-order sum of
:func:`_weighted_sum` the blocked rows are the whole lattice's, bit for bit.

``assemble_p2_monolithic`` is the host scipy CSR of the BC-eliminated
system: the analysis path and the factor of the preonly + lu solve, which
runs on the host (``scipy.sparse.linalg.splu``) in both packages.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from functools import cached_property, lru_cache
from typing import Callable, List, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from perphil_tpu_torch.config import DeviceLike, default_dtype, resolve_device
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.element import cell_subcells, simplex_geometry
from perphil_tpu_torch.utils.quadrature import _duffy, gauss_legendre_01

__all__ = [
    "p2_dof_mesh",
    "p2_local_nodes",
    "p2_simplex_matrices",
    "p2_class_stencils",
    "p2_stencil_diagonal",
    "P2SimplexDPPOperator",
    "assemble_p2_monolithic",
]


def p2_dof_mesh(mesh: StructuredMesh) -> StructuredMesh:
    """The once-refined lattice holding the P2 DoFs (``FunctionSpace.dof_mesh``
    at degree 2)."""
    return replace(mesh, cells=tuple(2 * c for c in mesh.cells))


def p2_local_nodes(verts_unit: np.ndarray) -> List[np.ndarray]:
    """P2 node positions of one simplex on the doubled lattice: vertices at
    ``2*v``, then edge midpoints ``v_i + v_j`` in ``combinations`` order."""
    d = verts_unit.shape[1]
    nodes = [2 * verts_unit[i] for i in range(d + 1)]
    for i, j in itertools.combinations(range(d + 1), 2):
        nodes.append(verts_unit[i] + verts_unit[j])
    return [n.astype(np.int64) for n in nodes]


def _p2_basis(lam: np.ndarray, grads_l: np.ndarray):
    """P2 values (nn,) and physical gradients (nn, d) from barycentric
    coordinates ``lam`` (d+1,) and their constant gradients (d+1, d), in
    ``p2_local_nodes`` order."""
    d = grads_l.shape[1]
    nn = (d + 1) + (d + 1) * d // 2
    phi = np.zeros(nn)
    grad = np.zeros((nn, d))
    for i in range(d + 1):
        phi[i] = lam[i] * (2.0 * lam[i] - 1.0)
        grad[i] = (4.0 * lam[i] - 1.0) * grads_l[i]
    for k, (i, j) in enumerate(itertools.combinations(range(d + 1), 2)):
        a = d + 1 + k
        phi[a] = 4.0 * lam[i] * lam[j]
        grad[a] = 4.0 * (lam[j] * grads_l[i] + lam[i] * grads_l[j])
    return phi, grad


def p2_simplex_matrices(
    verts_unit: np.ndarray, h: Tuple[float, ...], nq: int = 6
) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """P2 stiffness and mass on one simplex (physical scaling included), by
    Duffy-collapsed Gauss quadrature with ``nq`` points an axis (exact for
    these degree <= 4 integrands). Returns (nodes on the doubled lattice,
    Ke, Me)."""
    d = verts_unit.shape[1]
    detE, grads_l = simplex_geometry(verts_unit, h)
    detE = abs(detE)
    nodes = p2_local_nodes(verts_unit)
    nn = len(nodes)
    K = np.zeros((nn, nn))
    M = np.zeros((nn, nn))
    xq, wq = gauss_legendre_01(nq)
    for idx in itertools.product(range(nq), repeat=d):
        u = np.array([xq[i] for i in idx])
        w = float(np.prod([wq[i] for i in idx]))
        x, jac = _duffy(u)
        lam = np.concatenate([[1.0 - x.sum()], x])
        phi, grad = _p2_basis(lam, grads_l)
        wt = w * jac * detE
        K += wt * (grad @ grad.T)
        M += wt * np.outer(phi, phi)
    return nodes, K, M


@lru_cache(maxsize=None)
def _class_stencils_cached(
    element: str, h: Tuple[float, ...], diagonal: str
) -> Tuple[np.ndarray, np.ndarray]:
    d = len(h)
    shape = (2,) * d + (5,) * d
    Kw = np.zeros(shape)
    Mw = np.zeros(shape)
    for verts, _, _ in cell_subcells(element, h, diagonal):
        nodes, Ke, Me = p2_simplex_matrices(verts, h)
        for a, na in enumerate(nodes):
            # grid axes are the coordinate axes reversed (x fastest)
            ca = tuple(int(v) % 2 for v in reversed(na))
            for b, nb in enumerate(nodes):
                delta = tuple(int(v) + 2 for v in reversed(nb - na))
                Kw[ca + delta] += Ke[a, b]
                Mw[ca + delta] += Me[a, b]
    # the cache hands out shared arrays: a caller's in-place edit must not
    # reach every later operator with the same key
    Kw.setflags(write=False)
    Mw.setflags(write=False)
    return Kw, Mw


def p2_class_stencils(mesh: StructuredMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Parity-class stencil tables ``(Kw, Mw)`` of shape ``(2,)*d + (5,)*d``
    (class index in grid-axis order, then offset index, 0 <-> -2). Every
    interior row is the true assembled row; boundary rows are identity in
    the operator, so their entries are never read."""
    if mesh.is_tensor_product:
        raise ValueError("p2_class_stencils is for simplex meshes; use ops/tensorfem")
    return _class_stencils_cached(mesh.element, tuple(mesh.h), mesh.diagonal)


def _parity_vectors(shape: Tuple[int, ...], dtype, device) -> List[torch.Tensor]:
    d = len(shape)
    return [
        (torch.arange(shape[ax], device=device) % 2).to(dtype).reshape((1,) * ax + (-1,) + (1,) * (d - ax - 1))
        for ax in range(d)
    ]


def _parity_weight(Wc: np.ndarray, pb: List[torch.Tensor]):
    """The weight field multilinear in the parities,
    ``sum_c Wc[c] prod_k pb_k^{c_k}`` (None where every class weight is 0)."""
    d = len(pb)
    w = None
    for c in itertools.product((0, 1), repeat=d):
        coeff = float(Wc[c])
        if coeff == 0.0:
            continue
        term = coeff
        for k in range(d):
            term = term * (pb[k] if c[k] else (1.0 - pb[k]))
        w = term if w is None else w + term
    return w


@dataclass(frozen=True)
class P2Stencil:
    """One class stencil laid out on a lattice: the offsets with a nonzero
    weight somewhere, as slices of the input padded by 2, and their weight
    fields stacked, ``(n_offsets, *shape)`` on the device."""

    slices: Tuple[Tuple[slice, ...], ...]
    weights: torch.Tensor


def p2_stencil(shape: Tuple[int, ...], W: np.ndarray, dtype, device: DeviceLike = None) -> P2Stencil:
    """Lay out the class stencil ``W`` on a lattice of ``shape``."""
    device = resolve_device(device)
    d = len(shape)
    pb = _parity_vectors(shape, dtype, device)
    slices, fields = [], []
    for off in itertools.product(range(-2, 3), repeat=d):
        Wc = W[(slice(None),) * d + tuple(o + 2 for o in off)]
        if not np.any(Wc):
            continue
        w = _parity_weight(Wc, pb)
        if w is None:
            continue
        slices.append(tuple(slice(2 + o, 2 + o + s) for o, s in zip(off, shape)))
        fields.append(torch.broadcast_to(w, shape))
    return P2Stencil(tuple(slices), torch.stack(fields))


def _weighted_sum(up: torch.Tensor, slices, weights: torch.Tensor) -> torch.Tensor:
    """``y[r] = sum_i weights[i, r] * up[slices[i]][r]`` (``up`` the input
    padded by 2, reads beyond the lattice zero; a leading field axis rides
    along, the weights broadcast over it): the products in one op,
    the n - m products past the largest power of two m <= n added onto the
    first ones, then summed pairwise by halves, in a fixed order of
    elementwise adds, so that every entry's bits depend on its own terms
    alone, not on the lattice's shape (a block of the lattice gives the
    whole lattice's bits); 1 + log2(m) adds."""
    t = weights * torch.stack([up[sl] for sl in slices])
    n = t.shape[0]
    m = 1 << (n.bit_length() - 1)
    if m < n:
        t[: n - m] += t[m:]
    t = t[:m]
    while m > 1:
        m //= 2
        t = t[:m] + t[m:]
    return t[0]


def p2_stencil_diagonal(shape: Tuple[int, ...], W: np.ndarray, dtype, device: DeviceLike = None) -> torch.Tensor:
    """Grid of the diagonal entries (the zero-offset class weights)."""
    d = len(shape)
    Wc = W[(slice(None),) * d + (2,) * d]
    w = _parity_weight(Wc, _parity_vectors(shape, dtype, resolve_device(device)))
    return torch.broadcast_to(w, shape).to(dtype)


@dataclass(frozen=True)
class P2SimplexDPPOperator:
    """BC-eliminated two-field DPP operator for P2 on simplex meshes, on
    ``device``: the block structure and conventions of
    ``ops/assembly.py::DPPOperator`` (symmetric elimination, zero forcing),
    with the fields on the refined lattice ``(2N+1,)^d``. ``padding`` appends
    phantom lattice entries at the high end of each axis (the sharded path's
    divisibility): they are marked boundary with zero data, identity rows
    whose residual stays zero; padding shifts no index, so the parities of
    the real nodes are unchanged."""

    mesh: StructuredMesh
    params: DPPParameters
    padding: Tuple[int, ...] = ()
    device: DeviceLike = None

    def __post_init__(self):
        if self.mesh.is_tensor_product:
            raise ValueError(
                "P2SimplexDPPOperator is for simplex meshes; tensor-product "
                "cells use ops/tensorfem.TensorDPPOperator"
            )
        if self.padding and len(self.padding) != self.mesh.dim:
            raise ValueError(f"padding {self.padding} must have one entry per axis ({self.mesh.dim})")
        object.__setattr__(self, "padding", tuple(int(p) for p in self.padding))
        object.__setattr__(self, "device", resolve_device(self.device))

    @cached_property
    def dof_mesh(self) -> StructuredMesh:
        return p2_dof_mesh(self.mesh)

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        base = self.dof_mesh.node_shape
        return tuple(n + p for n, p in zip(base, self.padding)) if self.padding else base

    @cached_property
    def boundary_mask(self) -> np.ndarray:
        mask = np.asarray(self.dof_mesh.boundary_mask())
        if self.padding:
            mask = np.pad(mask, [(0, p) for p in self.padding], constant_values=True)
        return mask

    @cached_property
    def _bdry(self) -> torch.Tensor:
        return torch.as_tensor(self.boundary_mask, device=self.device)

    @cached_property
    def _stencils(self) -> Tuple[P2Stencil, P2Stencil]:
        return tuple(
            p2_stencil(self.dof_shape, W, default_dtype(), self.device) for W in p2_class_stencils(self.mesh)
        )

    @cached_property
    def _coefficients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(k_i / mu)`` and ``(+-beta / mu)`` a field, shaped to scale the
        stacked ``(2, *grid)`` fields."""
        p, shape = self.params, (2,) + (1,) * len(self.dof_shape)
        return tuple(torch.tensor(v, dtype=default_dtype(), device=self.device).reshape(shape)
                     for v in ((p.k1 / p.mu, p.k2 / p.mu), (p.beta / p.mu, -p.beta / p.mu)))

    @cached_property
    def whole(self):
        """The whole (padded) lattice as one block (``LoopbackBlocks(())``),
        kept: :meth:`matvec` and :meth:`lifted_rhs` are :meth:`apply_blocks`
        on it."""
        from perphil_tpu_torch.parallel.transpose import LoopbackBlocks

        return LoopbackBlocks(())

    def _whole_apply(self, z1: torch.Tensor, z2: torch.Tensor, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
        y = self.apply_blocks({(): torch.stack([z1, z2])}, self.whole, mode)[()]
        return y[0], y[1]

    def matvec(self, z1: torch.Tensor, z2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._whole_apply(z1, z2, "matvec")

    def lifted_rhs(self, g1: torch.Tensor, g2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Boundary rows get ``g``, interior rows ``-A[interior, boundary] g``."""
        return self._whole_apply(g1, g2, "lift")

    def residual(self, z1, z2, b1, b2):
        y1, y2 = self.matvec(z1, z2)
        return b1 - y1, b2 - y2

    def stacked_matvec(self) -> Callable[[torch.Tensor], torch.Tensor]:
        def mv(x: torch.Tensor) -> torch.Tensor:
            return torch.stack(self.matvec(x[0], x[1]))

        return mv

    def diagonal_stacked(self) -> torch.Tensor:
        """(2, *dof_shape) diagonal of the eliminated operator (Jacobi)."""
        p = self.params
        Kw, Mw = p2_class_stencils(self.mesh)
        dtype = default_dtype()
        dK = p2_stencil_diagonal(self.dof_shape, Kw, dtype, self.device)
        dM = p2_stencil_diagonal(self.dof_shape, Mw, dtype, self.device)
        bdry = self._bdry
        d1 = torch.where(bdry, 1.0, (p.k1 / p.mu) * dK + (p.beta / p.mu) * dM)
        d2 = torch.where(bdry, 1.0, (p.k2 / p.mu) * dK + (p.beta / p.mu) * dM)
        return torch.stack([d1, d2])

    # -- on blocks ------------------------------------------------------------

    def block_stencils(self, blocks):
        """Per block ``blocks`` holds, both class stencils (K, M) as the
        block reads them: the whole lattice's weight fields
        (:attr:`_stencils`, the parities of the global indices) cut to the
        block, ``(n, 1, *block)`` to scale both fields at once, and the same
        offsets as slices of its stacked box extended by 2 a side. Cut once
        per set of blocks; raises ``ValueError`` where a
        block is thinner than 2 planes (``parallel/halo.py::check_halo_width``;
        the solver's parts run such blocks gathered).
        Never a stencil laid out on the block's own shape: that would take
        the parities from the block's origin."""
        from perphil_tpu_torch.parallel.halo import check_halo_width
        from perphil_tpu_torch.parallel.transpose import block_slices

        def cut():
            check_halo_width(self.dof_shape, blocks.mesh_shape, 2)
            out = {}
            for c in blocks.coords:
                sl = block_slices(self.dof_shape, blocks.mesh_shape, c)
                local = tuple((s.stop if s.stop is not None else n) - (s.start or 0)
                              for s, n in zip(sl, self.dof_shape))
                out[c] = tuple(
                    (tuple((slice(None),) + tuple(slice(o.start, o.start + n) for o, n in zip(offs, local))
                           for offs in st.slices),
                     st.weights[(slice(None),) + sl].unsqueeze(1).contiguous())
                    for st in self._stencils)
            return out

        return blocks.built(("p2-stencils", self), cut)

    def apply_blocks(self, xs, blocks, mode: str = "matvec"):
        """The BC-eliminated operator (``mode="matvec"``) or the lift
        (``"lift"``) on the stacked ``(2, *block)`` blocks ``xs``: the
        boundary rows masked, one exchange of 2 planes a side along every
        split axis, the unsplit axes padded with zeros, then the whole
        lattice's offsets and weights in its order (:meth:`block_stencils`):
        bit for bit the whole lattice's rows. K goes over both fields in
        one sum, M over ``z1 - z2``."""
        from perphil_tpu_torch.parallel.halo import eliminated_apply

        bdry = blocks.built(("p2-boundary", self), lambda: blocks.cut(self._bdry))
        stencils, split = self.block_stencils(blocks), len(blocks.mesh_shape)
        ck, cm = self._coefficients

        def raw(c, box):
            pad = [v for ax in reversed(range(split, box.dim() - 1)) for v in (2, 2)]
            up = F.pad(box, pad) if pad else box
            (ks, kw), (ms, mw) = stencils[c]
            return ck * _weighted_sum(up, ks, kw) + cm * _weighted_sum((up[0] - up[1])[None], ms, mw)

        return eliminated_apply(blocks, xs, bdry, 2, raw, mode)


def _assemble_p2_scalar(mesh: StructuredMesh) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """Host CSR of the raw (pre-elimination) P2 K and M on the refined
    lattice."""
    d = mesh.dim
    ref_shape = tuple(2 * c + 1 for c in reversed(mesh.cells))  # grid order
    n = int(np.prod(ref_shape))
    strides = np.ones(d, dtype=np.int64)  # coordinate-axis strides, x first
    acc = 1
    for ax in range(d):
        strides[ax] = acc
        acc *= ref_shape[d - 1 - ax]
    grids = np.meshgrid(*[np.arange(c) for c in mesh.cells], indexing="ij")
    bases = 2 * np.stack([g.ravel() for g in grids], axis=1)  # (ncells, d)
    rows, cols, vals_K, vals_M = [], [], [], []
    for verts, _, _ in cell_subcells(mesh.element, tuple(mesh.h), mesh.diagonal):
        nodes, Ke, Me = p2_simplex_matrices(verts, tuple(mesh.h))
        gidx = np.stack([(bases + nn[None, :]) @ strides for nn in nodes], axis=1)  # (ncells, nn)
        for a in range(len(nodes)):
            for b in range(len(nodes)):
                rows.append(gidx[:, a])
                cols.append(gidx[:, b])
                vals_K.append(np.full(gidx.shape[0], Ke[a, b]))
                vals_M.append(np.full(gidx.shape[0], Me[a, b]))
    ij = (np.concatenate(rows), np.concatenate(cols))
    K = sp.csr_matrix((np.concatenate(vals_K), ij), shape=(n, n))
    M = sp.csr_matrix((np.concatenate(vals_M), ij), shape=(n, n))
    return K, M


def assemble_p2_monolithic(mesh: StructuredMesh, params: DPPParameters) -> sp.csr_matrix:
    """The symmetric-BC-eliminated monolithic two-field CSR (host scipy):
    the analysis path and the preonly + lu factor. Boundary rows and
    columns are identity, as in the degree-1 CSR."""
    K, M = _assemble_p2_scalar(mesh)
    p = params
    A11 = (p.k1 / p.mu) * K + (p.beta / p.mu) * M
    A22 = (p.k2 / p.mu) * K + (p.beta / p.mu) * M
    C = -(p.beta / p.mu) * M
    A = sp.bmat([[A11, C], [C, A22]], format="csr")
    bmask = np.asarray(p2_dof_mesh(mesh).boundary_mask()).ravel().astype(bool)
    bmask2 = np.concatenate([bmask, bmask])
    keep = sp.diags((~bmask2).astype(float))
    A = keep @ A @ keep + sp.diags(bmask2.astype(float))
    return A.tocsr()
