"""Reference-element stiffness and mass matrices on uniform cells.

Counterpart of ``perphil_tpu/ops/element.py`` (host-side numpy). The forms
are fixed — Darcy stiffness ``(k/mu) grad p . grad q`` and mass coupling
``(beta/mu) p q`` on uniform cells — so closed-form element matrices
replace a form compiler.

Conventions: node positions are integer grid units relative to the cell's
lower corner; each cell type is a list of sub-cells (1 for quad/hex, 2
triangles, 6 Kuhn tetrahedra), each with vertex offsets and element
matrices (Ke, Me).
"""

from __future__ import annotations

import itertools
from typing import List, Tuple

import numpy as np

Subcell = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (vertex offsets, Ke, Me)


def _tensor_q1(h: Tuple[float, ...]) -> Subcell:
    """Q1 stiffness/mass on a box via 1D tensor factors
    ``K1 = (1/hi)[[1,-1],[-1,1]]``, ``M1 = (hi/6)[[2,1],[1,2]]``;
    vertex ordering is binary counting with x fastest."""
    d = len(h)
    K1 = [np.array([[1.0, -1.0], [-1.0, 1.0]]) / hi for hi in h]
    M1 = [np.array([[2.0, 1.0], [1.0, 2.0]]) * (hi / 6.0) for hi in h]

    def kron_all(mats):
        # x (dimension 0) is the fastest vertex bit, so it is the LAST factor
        out = np.array([[1.0]])
        for m in reversed(mats):
            out = np.kron(out, m)
        return out

    Me = kron_all(M1)
    Ke = np.zeros_like(Me)
    for i in range(d):
        Ke += kron_all([K1[j] if j == i else M1[j] for j in range(d)])

    verts = np.array(
        [[(v >> i) & 1 for i in range(d)] for v in range(2**d)], dtype=np.int64
    )
    return verts, Ke, Me


def simplex_geometry(
    verts_unit: np.ndarray, h: Tuple[float, ...]
) -> Tuple[float, np.ndarray]:
    """(detE, barycentric gradients of shape (d+1, d)) of an affine simplex.

    grad(lam_i) is the i-th ROW of Einv (lam = Einv (p - v0)), and
    grad(lam_0) = -sum of the others.
    """
    d = verts_unit.shape[1]
    phys = verts_unit.astype(float) * np.asarray(h)
    E = (phys[1:] - phys[0]).T
    detE = float(np.linalg.det(E))
    Einv = np.linalg.inv(E)
    grads = np.zeros((d + 1, d))
    grads[1:] = Einv
    grads[0] = -grads[1:].sum(axis=0)
    return detE, grads


def _simplex(verts_unit: np.ndarray, h: Tuple[float, ...]) -> Subcell:
    """P1 stiffness/mass: ``Ke = |T| g_i . g_j``,
    ``Me = |T| / ((d+1)(d+2)) (1 + I)``."""
    d = verts_unit.shape[1]
    detE, grads = simplex_geometry(verts_unit, h)
    vol = abs(detE) / float(np.prod(np.arange(1, d + 1)))
    Ke = vol * grads @ grads.T
    Me = vol / ((d + 1) * (d + 2)) * (np.ones((d + 1, d + 1)) + np.eye(d + 1))
    return verts_unit.astype(np.int64), Ke, Me


def cell_subcells(element: str, h: Tuple[float, ...], diagonal: str = "left") -> List[Subcell]:
    """Decompose one grid cell into FE sub-cells with element matrices.

    :param element: "quad" | "triangle" | "hex" | "tet".
    :param h: grid spacings, coordinate order (hx, hy[, hz]).
    :param diagonal: triangle split; "left" is the diagonal (1,0)-(0,1).
    """
    if element in ("quad", "hex"):
        return [_tensor_q1(h)]
    if element == "triangle":
        if diagonal == "left":
            tris = [
                np.array([[0, 0], [1, 0], [0, 1]]),
                np.array([[1, 0], [1, 1], [0, 1]]),
            ]
        else:
            tris = [
                np.array([[0, 0], [1, 0], [1, 1]]),
                np.array([[0, 0], [1, 1], [0, 1]]),
            ]
        return [_simplex(t, h) for t in tris]
    if element == "tet":
        # Kuhn/Freudenthal: one tet per coordinate order of the unit-step
        # path (0,0,0) -> (1,1,1)
        tets = []
        for perm in itertools.permutations(range(3)):
            v = [np.zeros(3, dtype=np.int64)]
            for axis in perm:
                nxt = v[-1].copy()
                nxt[axis] = 1
                v.append(nxt)
            tets.append(np.stack(v))
        return [_simplex(t, h) for t in tets]
    raise ValueError(f"Unknown element type: {element!r}")
