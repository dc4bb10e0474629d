"""Cell quadrature tables for error norms (degree-1 spaces and P2 simplices).

Counterpart of ``perphil_tpu/utils/quadrature.py`` (``cell_quadrature``,
``cell_quadrature_p2``), host-side numpy. Degree-14 rules reproduce the reference's committed error
CSVs (``DEFAULT_QUADRATURE_DEGREE``); simplices map the tensor
Gauss-Legendre rule through the Duffy transform.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Tuple

import numpy as np

from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.ops.element import cell_subcells

#: Default quadrature degree for error norms (parity-critical).
DEFAULT_QUADRATURE_DEGREE = 14


@dataclass(frozen=True)
class QPoint:
    """One quadrature point within a grid cell.

    :param weight: physical weight (includes the cell Jacobian).
    :param point: physical offset from the cell's lower corner, coord order.
    :param vertex_offsets: integer node offsets of the owning sub-cell.
    :param basis: FE basis values at the point, one per node offset.
    :param basis_grad: physical basis gradients, shape (nnodes, dim).
    :param stride: lattice steps per grid cell (1 for degree 1).
    """

    weight: float
    point: Tuple[float, ...]
    vertex_offsets: Tuple[Tuple[int, ...], ...]
    basis: Tuple[float, ...]
    basis_grad: Tuple[Tuple[float, ...], ...]
    stride: int = 1


def gauss_legendre_01(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def _tensor_basis(xi: np.ndarray, h: Tuple[float, ...]):
    """Q1 basis values and physical gradients at local point xi in [0,1]^d."""
    d = len(h)
    verts = list(itertools.product((0, 1), repeat=d))
    vals, grads = [], []
    for v in verts:
        val = 1.0
        for ax in range(d):
            val *= xi[ax] if v[ax] else (1.0 - xi[ax])
        g = []
        for gax in range(d):
            gv = 1.0
            for ax in range(d):
                if ax == gax:
                    gv *= (1.0 if v[ax] else -1.0) / h[ax]
                else:
                    gv *= xi[ax] if v[ax] else (1.0 - xi[ax])
            g.append(gv)
        vals.append(val)
        grads.append(tuple(g))
    return [tuple(v) for v in verts], vals, grads


def _simplex_basis(verts_phys: np.ndarray):
    """P1 barycentric basis: affine values, constant gradients."""
    d = verts_phys.shape[1]
    E = (verts_phys[1:] - verts_phys[0]).T
    Einv = np.linalg.inv(E)
    grads = np.zeros((d + 1, d))
    grads[1:] = Einv
    grads[0] = -grads[1:].sum(axis=0)

    def basis_at(p_phys: np.ndarray) -> np.ndarray:
        lam = Einv @ (p_phys - verts_phys[0])
        return np.concatenate([[1.0 - lam.sum()], lam])

    return basis_at, grads


def _simplex_volume(verts_phys: np.ndarray) -> float:
    d = verts_phys.shape[1]
    E = (verts_phys[1:] - verts_phys[0]).T
    return abs(float(np.linalg.det(E))) / float(np.prod(np.arange(1, d + 1)))


def _duffy(u: np.ndarray) -> Tuple[np.ndarray, float]:
    """Map [0,1]^d onto the unit simplex (lam_i = u_i prod_{j<i}(1-u_j)),
    with Jacobian prod_j (1-u_j)^{d-1-j}."""
    d = u.shape[0]
    lam = np.zeros(d)
    jac = 1.0
    rem = 1.0
    for i in range(d):
        lam[i] = rem * u[i]
        jac *= (1.0 - u[i]) ** (d - 1 - i)
        rem = rem * (1.0 - u[i])
    return lam, jac


@lru_cache(maxsize=None)
def _cell_quadrature_cached(
    cells: Tuple[int, ...], element: str, diagonal: str, extent: Tuple[float, ...], degree: int
) -> Tuple[QPoint, ...]:
    mesh = StructuredMesh(cells=cells, element=element, diagonal=diagonal, extent=extent)
    d = mesh.dim
    h = mesh.h
    n1 = max(1, (degree + 2) // 2)  # GL exactness 2n-1 >= degree
    xq, wq = gauss_legendre_01(n1)
    qpts: List[QPoint] = []
    if mesh.is_tensor_product:
        jac = float(np.prod(h))
        for idx in itertools.product(range(n1), repeat=d):
            xi = np.array([xq[i] for i in idx])
            w = float(np.prod([wq[i] for i in idx])) * jac
            offs, vals, grads = _tensor_basis(xi, h)
            qpts.append(
                QPoint(
                    weight=w,
                    point=tuple(xi * np.asarray(h)),
                    vertex_offsets=tuple(offs),
                    basis=tuple(vals),
                    basis_grad=tuple(grads),
                )
            )
        return tuple(qpts)
    ref_volume_inv = float(np.prod(np.arange(1, d + 1)))
    for verts, _, _ in cell_subcells(element, h, diagonal):
        verts_phys = verts.astype(float) * np.asarray(h)
        basis_at, grads = _simplex_basis(verts_phys)
        vol = _simplex_volume(verts_phys)
        for idx in itertools.product(range(n1), repeat=d):
            u = np.array([xq[i] for i in idx])
            w = float(np.prod([wq[i] for i in idx]))
            lam, jac = _duffy(u)
            p = verts_phys[0] + (verts_phys[1:] - verts_phys[0]).T @ lam
            qpts.append(
                QPoint(
                    weight=w * jac * vol * ref_volume_inv,
                    point=tuple(p),
                    vertex_offsets=tuple(tuple(int(c) for c in v) for v in verts),
                    basis=tuple(basis_at(p)),
                    basis_grad=tuple(tuple(row) for row in grads),
                )
            )
    return tuple(qpts)


def cell_quadrature(
    mesh: StructuredMesh, degree: int = DEFAULT_QUADRATURE_DEGREE
) -> Tuple[QPoint, ...]:
    """Quadrature table for one grid cell of the mesh (cached)."""
    return _cell_quadrature_cached(
        mesh.cells, mesh.element, mesh.diagonal, mesh.extent, degree
    )


@lru_cache(maxsize=None)
def _cell_quadrature_p2_cached(
    cells: Tuple[int, ...], element: str, diagonal: str, extent: Tuple[float, ...], degree: int
) -> Tuple[QPoint, ...]:
    from perphil_tpu_torch.ops.element import simplex_geometry
    from perphil_tpu_torch.ops.simplexfem import _p2_basis, p2_local_nodes

    mesh = StructuredMesh(cells=cells, element=element, diagonal=diagonal, extent=extent)
    if mesh.is_tensor_product:
        raise ValueError("P2 quadrature tables are for simplex meshes (Qp uses tensorfem)")
    d = mesh.dim
    h = mesh.h
    n1 = max(1, (degree + 2) // 2)
    xq, wq = gauss_legendre_01(n1)
    qpts: List[QPoint] = []
    for verts, _, _ in cell_subcells(element, h, diagonal):
        verts_phys = verts.astype(float) * np.asarray(h)
        detE, grads_l = simplex_geometry(verts, h)
        detE = abs(detE)
        nodes = p2_local_nodes(verts)
        for idx in itertools.product(range(n1), repeat=d):
            u = np.array([xq[i] for i in idx])
            w = float(np.prod([wq[i] for i in idx]))
            x, jac = _duffy(u)
            lam = np.concatenate([[1.0 - x.sum()], x])
            phi, grad = _p2_basis(lam, grads_l)
            p = verts_phys[0] + (verts_phys[1:] - verts_phys[0]).T @ x
            qpts.append(
                QPoint(
                    weight=w * jac * detE,
                    point=tuple(p),
                    vertex_offsets=tuple(tuple(int(c) for c in nn) for nn in nodes),
                    basis=tuple(phi),
                    basis_grad=tuple(tuple(row) for row in grad),
                    stride=2,
                )
            )
    return tuple(qpts)


def cell_quadrature_p2(
    mesh: StructuredMesh, degree: int = DEFAULT_QUADRATURE_DEGREE
) -> Tuple[QPoint, ...]:
    """P2 quadrature table for one grid cell of a simplex mesh: node offsets
    on the once-refined lattice (``stride=2``), the quadratic Lagrange
    basis values and gradients (``ops/simplexfem.py``)."""
    return _cell_quadrature_p2_cached(mesh.cells, mesh.element, mesh.diagonal, mesh.extent, degree)
