"""DoF orderings, the parity system's CSR pattern and the host ILU twins
(host numpy/scipy).

Counterpart of ``perphil_tpu/ops/ordering.py``. Two parts of the
reference's numbering matter to counts that depend on the order of rows.

The pinned SNES-NGS colouring. PETSc colours the Jacobian's pattern with
a randomised distance-1 greedy colouring, and the draw that reproduces the
reference's published Picard counts 16/63/194/635/1673/5135 at 2D N=4..128
(``petsc_perf_breakdown-with-picard.csv``) is pinned by

  - the weights: PETSc's rander48 stream from its default seed
    (:func:`petsc_rander48_weights`);
  - the row numbering they are dealt along: Cuthill-McKee on the quad cell
    dual graph from the ``(nx-1, 0)`` corner cell, vertices numbered by
    first appearance (:func:`quad_cell_cm_parity`), field-major blocked
    (:func:`blocked`).

:func:`ngs_parity_coloring` returns each DoF's colour;
:func:`colored_ngs_sweeps` is the scipy yardstick that sweeps with it.

The ordering-parity ILU (``pc_factor_mat_ordering_type=rcm``). Firedrake
numbers DoFs through DMPlex's RCM mesh reordering, and PETSc's ILU(0) fills
exactly the allocated finite-element pattern. :func:`parity_system` builds
that system: the structured system as CSR (:func:`to_csr`) restricted to
the finite-element adjacency (:func:`tighten_pattern`) and permuted by the
pinned cell-RCM draw (:func:`cell_rcm_parity`), which lands the published
3D tet GMRES+ILU column 6/8/12/15/17/20/26/29/33 at nx=4..40.
:func:`host_ilu0`, :func:`host_ilu_apply` and :func:`host_gmres` are the
sequential numpy twins of the host engine's C++ kernels
(``ops/_native.py``). The traversals run a level of the Cuthill-McKee queue
at a time, with the queue's order, so that the largest published mesh
(384,000 tets) takes seconds.

For the ordering study (``experiments/ordering_study.py``):
:func:`random_ordering`, numpy's seeded permutation, and
:func:`host_gs_sweeps`, the sequential pointwise Gauss-Seidel sweep count
by the C++ kernel (``ops/_native.py``; no Python fallback: a host without
``g++`` raises).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops import _native
from perphil_tpu_torch.ops.stencil import compile_stencils

__all__ = [
    "to_csr",
    "tighten_pattern",
    "parity_system",
    "blocked",
    "vertex_rcm",
    "cell_rcm",
    "cell_rcm_parity",
    "random_ordering",
    "host_gs_sweeps",
    "host_ilu0",
    "host_ilu_apply",
    "host_gmres",
    "drand48_weights",
    "petsc_rander48_weights",
    "quad_cell_cm_parity",
    "ngs_parity_coloring",
    "greedy_coloring",
    "colored_ngs_sweeps",
]


def to_csr(sysm) -> sp.csr_matrix:
    """A structured system (``ops/ilu.py::StructuredSystem``) as CSR, with
    the full offset envelope and its explicit zeros (PETSc keeps allocated
    zeros: this is the pattern the structured ILU factorises)."""
    nrows = sysm.nrows
    cols_mat = np.arange(nrows)[:, None] + sysm.deltas[None, :]
    ok = sysm.valid & (cols_mat >= 0) & (cols_mat < nrows)
    rows, cols = np.nonzero(ok)[0], cols_mat[ok]
    return sp.csr_matrix((sysm.vals[ok], (rows, cols)), shape=(nrows, nrows))


def tighten_pattern(A: sp.spmatrix, sysm, mesh: StructuredMesh, params: DPPParameters) -> sp.csr_matrix:
    """Restrict ``A``'s pattern to the true finite-element adjacency.

    Keeps the positions whose raw (before the BC elimination) stencil weight
    is nonzero, the pattern Firedrake allocates, and the explicit zeros the
    symmetric BC elimination leaves (PETSc's MatZeroRowsColumns keeps the
    allocated pattern). Quads and hexes couple through every envelope
    offset, so nothing changes there; on simplex meshes the never-coupled
    offsets go (12 of 27 in 3D)."""
    K_st, M_st = compile_stencils(mesh)
    p = params
    raw = {
        (0, 0): (p.k1 / p.mu) * K_st + (p.beta / p.mu) * M_st,
        (1, 1): (p.k2 / p.mu) * K_st + (p.beta / p.mu) * M_st,
        (0, 1): -(p.beta / p.mu) * M_st,
        (1, 0): -(p.beta / p.mu) * M_st,
    }
    nrows, n = sysm.nrows, sysm.n_nodes
    keep = np.zeros((nrows, sysm.vals.shape[1]), dtype=bool)
    for t in range(sysm.vals.shape[1]):
        bd = int(sysm.blocks[t])
        g = sysm.geoms[t]
        for f in range(sysm.nfields):
            cf = f + bd
            if cf < 0 or cf >= sysm.nfields:
                continue
            w = raw[(f, cf)][tuple(int(o) + 1 for o in reversed(g))]
            if w != 0.0 or (bd == 0 and (g == 0).all()):
                keep[f * n : (f + 1) * n, t] = True
    cols_mat = np.arange(nrows)[:, None] + sysm.deltas[None, :]
    ok = sysm.valid & keep & (cols_mat >= 0) & (cols_mat < nrows)
    rows, cols = np.nonzero(ok)[0], cols_mat[ok]
    vals = np.asarray(A.tocsr()[rows, cols]).ravel()
    return sp.csr_matrix((vals, (rows, cols)), shape=A.shape)


def parity_system(mesh: StructuredMesh, params: DPPParameters) -> Tuple[sp.csr_matrix, np.ndarray, sp.csr_matrix]:
    """The ordering-parity ILU's system: ``(A, perm, Ap)``.

    ``A`` is the BC-eliminated monolithic matrix as CSR in the reference's
    pattern and the natural field-major order; ``perm`` the DoF numbering
    (``x_new = x_old[perm]``); ``Ap = A[perm][:, perm]`` with sorted indices,
    the matrix the ILU(0) factorises. Simplex meshes take the finite-element
    pattern and the pinned cell-RCM numbering (:func:`cell_rcm_parity`,
    field-major blocked); quad and hex meshes the envelope, which is their
    finite-element pattern, and the identity, with which the natural order
    already lands the reference's counts."""
    from perphil_tpu_torch.ops.ilu import build_monolithic_system  # ops/ilu.py imports this module

    sysm = build_monolithic_system(mesh, params)
    A = to_csr(sysm)
    if mesh.is_tensor_product:
        perm = np.arange(2 * mesh.num_vertices, dtype=np.int64)
    else:
        # the dropped entries are exact zeros: A stays the same matrix
        A = tighten_pattern(A, sysm, mesh, params)
        perm = blocked(cell_rcm_parity(mesh))
    Ap = A[perm][:, perm].tocsr()
    Ap.sort_indices()
    return A, perm, Ap


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
    """Cells adjacent through a shared facet: every ``d``-subset of a cell's
    vertices that exactly two cells hold is an edge between them (a quad's
    diagonals belong to one cell only). Rows hold sorted column indices."""
    nc, per_cell = cells.shape
    srt = np.sort(cells.astype(np.int64), axis=1)
    span = int(srt.max()) + 1 if nc else 1
    if span**d >= 2**63:
        raise ValueError(f"{span} vertices: a facet's key would not fit in 64 bits")
    keys, owner = [], []
    for comb in itertools.combinations(range(per_cell), d):
        key = np.zeros(nc, dtype=np.int64)
        for col in comb:
            key = key * span + srt[:, col]
        keys.append(key)
        owner.append(np.arange(nc, dtype=np.int64))
    keys = np.concatenate(keys)
    owner = np.concatenate(owner)
    order = np.argsort(keys, kind="stable")
    keys, owner = keys[order], owner[order]
    same = np.flatnonzero(keys[1:] == keys[:-1])
    # a facet held by exactly two cells: equal to its successor, and neither
    # to the entry before it nor to the one after the pair
    lone_pair = np.ones(same.shape, dtype=bool)
    lone_pair &= (same == 0) | (keys[np.maximum(same - 1, 0)] != keys[same])
    lone_pair &= (same + 2 >= keys.size) | (keys[np.minimum(same + 2, keys.size - 1)] != keys[same])
    a, b = owner[same[lone_pair]], owner[same[lone_pair] + 1]
    rows = np.concatenate([a, b])
    cols = np.concatenate([b, a])
    G = sp.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(nc, nc))
    G.sort_indices()
    return G


def _cm_level(frontier: np.ndarray, indptr, indices, deg, seen) -> np.ndarray:
    """The next level of a Cuthill-McKee traversal: the unseen neighbours of
    ``frontier``, each claimed by the first node of the frontier that has it,
    grouped by claimer in frontier order and, within a claimer, by
    increasing degree, stable on adjacency order. This is what the
    one-node-at-a-time queue appends while it works through the frontier."""
    starts = indptr[frontier]
    counts = indptr[frontier + 1] - starts
    claimer = np.repeat(np.arange(frontier.size), counts)
    at = np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts, counts) + np.repeat(starts, counts)
    nbr = indices[at]
    keep = ~seen[nbr]
    claimer, nbr, at = claimer[keep], nbr[keep], at[keep]
    by_node = np.lexsort((claimer, nbr))
    first = np.ones(by_node.size, dtype=bool)
    first[1:] = nbr[by_node[1:]] != nbr[by_node[:-1]]
    sel = by_node[first]
    return nbr[sel][np.lexsort((at[sel], deg[nbr[sel]], claimer[sel]))]


def _cm_from_root(G: sp.csr_matrix, root: int, reverse: bool = False) -> np.ndarray:
    """Cuthill-McKee traversal from ``root``: neighbours by increasing
    degree, stable on adjacency order; then any component left, from its
    lowest cell. With ``reverse`` the order comes back reversed (SPARSEPACK's
    GENRCM is this with a pseudo-peripheral root and ``reverse=True``;
    pinning the root reproduces one tie-break draw). Runs a level of the
    traversal at a time (:func:`_cm_level`)."""
    indptr, indices = G.indptr.astype(np.int64), G.indices.astype(np.int64)
    n = G.shape[0]
    deg = np.diff(indptr)
    seen = np.zeros(n, dtype=bool)
    levels = []
    start = int(root)
    while True:
        frontier = np.array([start], dtype=np.int64)
        while frontier.size:
            seen[frontier] = True
            levels.append(frontier)
            frontier = _cm_level(frontier, indptr, indices, deg, seen)
        rest = np.flatnonzero(~seen)
        if rest.size == 0:
            break
        start = int(rest[0])
    order = np.concatenate(levels)
    return order[::-1].copy() if reverse else order


def _first_appearance(cells: np.ndarray, corder: np.ndarray, nv: int) -> np.ndarray:
    """Vertices numbered by first appearance in the cell traversal
    ``corder`` (within a cell, in the cell's own vertex order): returns
    ``perm`` with ``perm[new_index] = old_index``."""
    flat = cells[corder].ravel()
    verts, first = np.unique(flat, return_index=True)
    if verts.size != nv:
        raise RuntimeError("the cell traversal did not reach every vertex")
    return verts[np.argsort(first, kind="stable")].astype(np.int64)


def quad_cell_cm_parity(mesh: StructuredMesh) -> np.ndarray:
    """The pinned quad-mesh vertex numbering behind the reference's NGS
    colouring: unreversed Cuthill-McKee on the cell dual graph from cell
    ``(nx-1, 0)``, vertices numbered by first appearance in the cell
    traversal (counterclockwise within a cell). Returns ``perm`` with
    ``perm[new_index] = old_lexicographic_index``."""
    cells = _quad_cells(mesh)
    corder = _cm_from_root(_cell_dual_graph(cells, 2), mesh.cells[0] - 1)
    return _first_appearance(cells, corder, mesh.num_vertices)


def _simplex_cells(mesh: StructuredMesh) -> np.ndarray:
    """Global vertex ids of every simplex cell, as the element conventions
    of ``ops/element.py`` lay them (two right-diagonal triangles a square, six
    Kuhn tets a cube, in the order of the permutations of the axes), cells
    in lexicographic square/cube order with x fastest."""
    d = mesh.dim
    shape = mesh.node_shape
    strides = [1]
    for ax in range(1, d):
        strides.append(strides[-1] * shape[d - ax])
    strides = np.array(strides, dtype=np.int64)
    if d == 3:
        offs = []
        for axes in itertools.permutations(range(3)):
            v = [np.zeros(3, dtype=np.int64)]
            for axis in axes:
                nxt = v[-1].copy()
                nxt[axis] = 1
                v.append(nxt)
            offs.append(np.stack(v))
    else:
        offs = [np.array([[0, 0], [1, 0], [1, 1]]), np.array([[0, 0], [1, 1], [0, 1]])]
    offs = np.stack(offs).astype(np.int64)  # (simplices a cell, d + 1, d)
    grids = np.meshgrid(*[np.arange(c) for c in reversed(mesh.cells)], indexing="ij")
    base = np.stack([g.ravel() for g in reversed(grids)], axis=1)  # (cells, d) as (x, y[, z])
    verts = (base[:, None, None, :] + offs[None]) @ strides
    return verts.reshape(-1, d + 1)


def cell_rcm(mesh: StructuredMesh) -> np.ndarray:
    """A Firedrake-like mesh reordering: scipy's reverse Cuthill-McKee on
    the simplex cell dual graph (pseudo-peripheral root), vertices numbered
    by first appearance in the reordered cell traversal. Returns ``perm``
    with ``perm[new_index] = old_index``. :func:`cell_rcm_parity` pins the
    draw that lands every published count."""
    cells = _simplex_cells(mesh)
    corder = np.asarray(reverse_cuthill_mckee(_cell_dual_graph(cells, mesh.dim), symmetric_mode=True))
    return _first_appearance(cells, corder, mesh.num_vertices)


def cell_rcm_parity(mesh: StructuredMesh) -> np.ndarray:
    """The cell-RCM tie-break draw that reproduces the reference's published
    simplex GMRES+ILU counts at every size (``petsc_perf_breakdown_3d.csv``,
    "GMRES + ILU PC": 6/8/12/15/17/20/26/29/33 at tet nx=4..40): reversed
    Cuthill-McKee on the simplex cell dual graph rooted at the first simplex
    of the ``(nx-1, 0[, 0])`` corner cell, vertices numbered by first
    appearance in the reordered cell traversal. Returns ``perm`` with
    ``perm[new_index] = old_index`` (extend it to the two fields with
    :func:`blocked`)."""
    cells = _simplex_cells(mesh)
    nsimplex = 6 if mesh.dim == 3 else 2
    root = nsimplex * (mesh.cells[0] - 1)
    corder = _cm_from_root(_cell_dual_graph(cells, mesh.dim), root, reverse=True)
    return _first_appearance(cells, corder, mesh.num_vertices)


def vertex_rcm(A_vertex: sp.spmatrix) -> np.ndarray:
    """Reverse Cuthill-McKee (scipy) on a vertex adjacency graph."""
    adj = abs(A_vertex) + abs(A_vertex).T
    return np.asarray(reverse_cuthill_mckee(adj.tocsr(), symmetric_mode=True))


def random_ordering(n: int, seed: int = 0) -> np.ndarray:
    """A seeded random vertex permutation (numpy's ``default_rng(seed)``)."""
    return np.random.default_rng(seed).permutation(n)


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


# ---------------------------------------------------------------------------
# the host engine's plain twins (sequential numpy; ops/_native.py runs the
# same recurrences in C++)


def host_ilu0(A: sp.spmatrix) -> Tuple[sp.csr_matrix, np.ndarray]:
    """Sequential IKJ ILU(0) on CSR, filling exactly ``A``'s stored pattern
    (explicit zeros included, as PETSc does). Returns ``(F, diag)``: the
    combined factor (L strictly below the diagonal, unit diagonal implied;
    U on and above it) and the position of each row's diagonal in ``F``."""
    F = A.tocsr().copy()
    F.sort_indices()
    n = F.shape[0]
    indptr, indices, data = F.indptr, F.indices, F.data
    diag = np.zeros(n, dtype=np.int64)
    for i in range(n):
        diag[i] = indptr[i] + np.searchsorted(indices[indptr[i] : indptr[i + 1]], i)
    for i in range(n):
        s = indptr[i]
        row_cols = indices[s : indptr[i + 1]]
        for kk in range(s, diag[i]):
            k = indices[kk]
            piv = data[kk] / data[diag[k]]
            data[kk] = piv
            ks, ke = diag[k] + 1, indptr[k + 1]
            jj = np.searchsorted(row_cols, indices[ks:ke])
            ok = (jj < len(row_cols)) & (row_cols[np.minimum(jj, len(row_cols) - 1)] == indices[ks:ke])
            data[s + jj[ok]] -= piv * data[ks:ke][ok]
    return F, diag


def host_ilu_apply(F: sp.csr_matrix, diag: np.ndarray, r: np.ndarray) -> np.ndarray:
    """``x = U^-1 L^-1 r`` by sequential forward and backward substitution
    over the combined factor of :func:`host_ilu0`."""
    indptr, indices, data = F.indptr, F.indices, F.data
    n = F.shape[0]
    y = np.zeros(n)
    for i in range(n):
        s = r[i]
        for kk in range(indptr[i], diag[i]):
            s -= data[kk] * y[indices[kk]]
        y[i] = s
    x = np.zeros(n)
    for i in range(n - 1, -1, -1):
        s = y[i]
        for kk in range(diag[i] + 1, indptr[i + 1]):
            s -= data[kk] * x[indices[kk]]
        x[i] = s / data[diag[i]]
    return x


def host_gmres(
    mv: Callable[[np.ndarray], np.ndarray],
    b: np.ndarray,
    pc: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    rtol: float = 1e-8,
    atol: float = 1e-12,
    restart: int = 30,
    max_it: int = 10000,
    return_solution: bool = False,
):
    """Left-preconditioned GMRES(restart) from ``x = 0`` with PETSc's
    KSPGMRES semantics (preconditioned residual norm, classical
    Gram-Schmidt, KSPConvergedDefault's ``max(rtol ||M^-1 r0||, atol)``), in
    plain numpy. Returns the iteration count, or ``(its, x, rnorm)`` with
    ``return_solution``."""
    pc = pc or (lambda v: v)
    n = b.shape[0]
    x = np.zeros(n)
    its = 0
    rnorm0 = np.linalg.norm(pc(b - mv(x)))
    tol = max(rtol * rnorm0, atol)
    rnorm = rnorm0
    while its < max_it:
        r = pc(b - mv(x))
        beta = np.linalg.norm(r)
        if beta <= tol:
            break
        V = np.zeros((restart + 1, n))
        H = np.zeros((restart + 1, restart))
        cs, sn = np.zeros(restart), np.zeros(restart)
        g = np.zeros(restart + 1)
        V[0] = r / beta
        g[0] = beta
        k = 0
        while k < restart and its < max_it:
            w = pc(mv(V[k]))
            h = V[: k + 1] @ w
            w = w - V[: k + 1].T @ h
            hk1 = np.linalg.norm(w)
            H[: k + 1, k] = h
            H[k + 1, k] = hk1
            for i in range(k):
                t = cs[i] * H[i, k] + sn[i] * H[i + 1, k]
                H[i + 1, k] = -sn[i] * H[i, k] + cs[i] * H[i + 1, k]
                H[i, k] = t
            d = np.hypot(H[k, k], H[k + 1, k])
            cs[k], sn[k] = H[k, k] / d, H[k + 1, k] / d
            H[k, k] = d
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            if hk1 > 0:
                V[k + 1] = w / hk1
            k += 1
            its += 1
            rnorm = abs(g[k])
            if rnorm <= tol:
                break
        y = np.linalg.solve(H[:k, :k], g[:k]) if k else np.zeros(0)
        x = x + V[:k].T @ y
        if rnorm <= tol:
            break
    return (its, x, rnorm) if return_solution else its


def host_gs_sweeps(
    A: sp.csr_matrix,
    b: np.ndarray,
    x0: np.ndarray,
    rtol: float = 1e-8,
    atol: float = 1e-12,
    stol: float = 1e-8,
    max_it: int = 20000,
) -> int:
    """Sequential pointwise Gauss-Seidel sweep count with
    SNESConvergedDefault-style stopping: ``||F|| <= max(rtol ||F0||, atol)``
    or ``||dx|| < stol ||x||`` (PETSc's ``snes_stol``, default 1e-8). The
    sweep is sequential: the C++ kernel runs it
    (``csrc/csr_solver.cpp::csr_gs_sweeps``), built by ``ops/_native.py``,
    which raises where ``g++`` is missing."""
    return _native.native_gs_sweeps(A, b, x0, rtol, atol, stol, max_it)
