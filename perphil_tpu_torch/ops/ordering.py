"""The pinned SNES-NGS colouring (host numpy/scipy).

Counterpart of the part of ``perphil_tpu/ops/ordering.py`` that the Picard
``ngs`` solve needs: PETSc colours the Jacobian's pattern with a
randomised distance-1 greedy colouring, and the draw that reproduces the
reference's published Picard counts 16/63/194/635/1673/5135 at 2D N=4..128
(``petsc_perf_breakdown-with-picard.csv``) is pinned by

  - the weights: PETSc's rander48 stream from its default seed
    (:func:`petsc_rander48_weights`);
  - the row numbering they are dealt along: Cuthill-McKee on the quad cell
    dual graph from the ``(nx-1, 0)`` corner cell, vertices numbered by
    first appearance (:func:`quad_cell_cm_parity`), field-major blocked
    (:func:`blocked`).

:func:`ngs_parity_coloring` returns each DoF's colour;
:func:`colored_ngs_sweeps` is the scipy yardstick that sweeps with it. The
colouring costs about a second at N=128, so the solvers build it once per
mesh. The other orderings of the JAX module (RCM variants, host ILU and
GMRES) belong to ROADMAP slice 6.
"""

from __future__ import annotations

import itertools
from collections import defaultdict

import numpy as np
import scipy.sparse as sp

from perphil_tpu_torch.mesh.structured import StructuredMesh

__all__ = [
    "blocked",
    "drand48_weights",
    "petsc_rander48_weights",
    "quad_cell_cm_parity",
    "ngs_parity_coloring",
    "greedy_coloring",
    "colored_ngs_sweeps",
]


def blocked(vertex_perm: np.ndarray, nfields: int = 2) -> np.ndarray:
    """Extend a vertex permutation to a field-major blocked DoF permutation
    (Firedrake numbers mixed spaces field by field)."""
    nv = vertex_perm.shape[0]
    return np.concatenate([vertex_perm + f * nv for f in range(nfields)])


def drand48_weights(n: int, x0: int = 0x1234ABCD330E) -> np.ndarray:
    """The drand48 LCG sequence from state ``x0`` (by default its
    documented default state)."""
    a, c, m = 0x5DEECE66D, 0xB, 1 << 48
    out = np.empty(n)
    x = x0
    for i in range(n):
        x = (a * x + c) % m
        out[i] = x / m
    return out


def petsc_rander48_weights(n: int) -> np.ndarray:
    """The rander48 sequence from PETSc's default ``PetscRandom`` seed
    (``0x12345678``, seeded srand48-style: state ``(seed << 16) | 0x330E``)."""
    return drand48_weights(n, (0x12345678 << 16) | 0x330E)


def _quad_cells(mesh: StructuredMesh) -> np.ndarray:
    """Global vertex ids of every quad cell in counterclockwise order
    (DMPlex's closure order), cells lexicographic with x fastest; vertex ids
    are the lexicographic flat index ``j * (nx + 1) + i``."""
    nx, ny = mesh.cells
    s = nx + 1
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    v00 = (j * s + i).ravel()
    return np.stack([v00, v00 + 1, v00 + s + 1, v00 + s], axis=1)


def _cell_dual_graph(cells: np.ndarray, d: int) -> sp.csr_matrix:
    """Cells adjacent through a shared facet."""
    facet_map = defaultdict(list)
    for c, vs in enumerate(cells):
        for f in itertools.combinations(sorted(vs), d):
            facet_map[f].append(c)
    rows, cols = [], []
    for cs in facet_map.values():
        if len(cs) == 2:
            rows += [cs[0], cs[1]]
            cols += [cs[1], cs[0]]
    nc = len(cells)
    G = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(nc, nc))
    G.sort_indices()
    return G


def _cm_from_root(G: sp.csr_matrix, root: int) -> np.ndarray:
    """Cuthill-McKee traversal from ``root``: neighbours by increasing
    degree, stable on adjacency order; then any component left, from its
    lowest cell."""
    indptr, indices = G.indptr, G.indices
    n = G.shape[0]
    deg = np.diff(indptr)
    seen = np.zeros(n, dtype=bool)
    order = []
    for start in itertools.chain([root], range(n)):
        if seen[start]:
            continue
        seen[start] = True
        k = len(order)
        order.append(start)
        while k < len(order):
            u = order[k]
            nbrs = sorted((v for v in indices[indptr[u] : indptr[u + 1]] if not seen[v]), key=lambda v: deg[v])
            for v in nbrs:
                seen[v] = True
                order.append(v)
            k += 1
    return np.array(order, dtype=np.int64)


def quad_cell_cm_parity(mesh: StructuredMesh) -> np.ndarray:
    """The pinned quad-mesh vertex numbering behind the reference's NGS
    colouring: unreversed Cuthill-McKee on the cell dual graph from cell
    ``(nx-1, 0)``, vertices numbered by first appearance in the cell
    traversal (counterclockwise within a cell). Returns ``perm`` with
    ``perm[new_index] = old_lexicographic_index``."""
    nv = mesh.num_vertices
    cells = _quad_cells(mesh)
    corder = _cm_from_root(_cell_dual_graph(cells, 2), mesh.cells[0] - 1)
    new = np.full(nv, -1, dtype=np.int64)
    nxt = 0
    for c in corder:
        for v in cells[c]:
            if new[v] < 0:
                new[v] = nxt
                nxt += 1
    if nxt != nv:
        raise RuntimeError("the cell traversal did not reach every vertex")
    perm = np.empty(nv, dtype=np.int64)
    perm[new] = np.arange(nv)
    return perm


def greedy_coloring(A: sp.spmatrix, order: np.ndarray) -> np.ndarray:
    """Greedy distance-1 colouring of ``A``'s pattern, vertices taken in
    ``order`` (PETSc's MATCOLORINGGREEDY takes the largest weight first):
    each gets the least colour no coloured neighbour has."""
    A = A.tocsr()
    colors = -np.ones(A.shape[0], dtype=np.int64)
    indptr, indices = A.indptr, A.indices
    for v in order:
        used = {colors[j] for j in indices[indptr[v] : indptr[v + 1]] if j != v and colors[j] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def ngs_parity_coloring(mesh: StructuredMesh) -> np.ndarray:
    """The pinned SNES-NGS colouring draw: per-DoF colours of the 2-field
    monolithic system, field-major, shape ``(2 * num_vertices,)``, int32.

    Every field pair couples through the 9-point vertex envelope, so the
    pattern coloured is the full monolithic one and no DoF shares a colour
    with a DoF it couples to. Sweeping the colours in ascending order with
    a diagonal step on the current residual (``ColoredNGSSweeper``)
    reproduces the reference's trajectory. Quad meshes only (the only
    element the reference publishes Picard counts for)."""
    if mesh.element != "quad":
        raise ValueError(f"ngs_parity_coloring is pinned for quad meshes, got {mesh.element!r}")
    nv = mesh.num_vertices
    n = 2 * nv
    perm2 = blocked(quad_cell_cm_parity(mesh))
    nx, ny = mesh.cells
    sx, sy = nx + 1, ny + 1
    j, i = np.divmod(np.arange(nv), sx)
    rows_, cols_ = [], []
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            ok = (i + di >= 0) & (i + di < sx) & (j + dj >= 0) & (j + dj < sy)
            r = np.flatnonzero(ok)
            rows_.append(r)
            cols_.append(r + dj * sx + di)
    rr = np.concatenate(rows_)
    cc = np.concatenate(cols_)
    Gv = sp.csr_matrix((np.ones(rr.shape[0]), (rr, cc)), shape=(nv, nv))
    G = sp.bmat([[Gv, Gv], [Gv, Gv]], format="csr")
    Gp = G[perm2][:, perm2].tocsr()
    order = np.argsort(petsc_rander48_weights(n), kind="stable")[::-1]
    colors = np.empty(n, dtype=np.int32)
    colors[perm2] = greedy_coloring(Gp, order)
    return colors


def colored_ngs_sweeps(
    A: sp.csr_matrix,
    b: np.ndarray,
    x0: np.ndarray,
    colors: np.ndarray,
    rtol: float = 1e-8,
    atol: float = 1e-12,
    stol: float = 0.0,
    max_it: int = 30000,
) -> int:
    """Multicolour Gauss-Seidel sweep count with PETSc's
    SNESComputeNGSDefaultSecant semantics, on a scipy matrix: per colour in
    ascending order, every DoF of the colour steps at once by the current
    residual over the diagonal (a linear residual's secant slope); one
    iteration is one pass over the colours. Stops on
    ``||F|| <= max(rtol ||F0||, atol)`` or, with ``stol``, a step below
    ``stol ||x||``."""
    A = A.tocsr()
    x = x0.astype(np.float64).copy()
    diag = A.diagonal()
    fnorm0 = np.linalg.norm(b - A @ x)
    masks = [colors == c for c in range(int(colors.max()) + 1)]
    for it in range(1, max_it + 1):
        xold = x.copy()
        for m in masks:
            r = b - A @ x
            x[m] += r[m] / diag[m]
        fnorm = np.linalg.norm(b - A @ x)
        if fnorm <= atol or fnorm <= rtol * fnorm0:
            return it
        if stol and np.linalg.norm(x - xold) <= stol * np.linalg.norm(x):
            return it
    return max_it
