"""Arbitrary-degree tensor-product (Qp) DPP operators and direct solves.

Counterpart of ``perphil_tpu/ops/tensorfem.py``. On uniform quad/hex meshes
the degree-p stiffness and mass operators factor as

    K_d = sum_i  K1 (x) M1 (x) ... ,      M_d = M1 (x) M1 (x) ...

where (K1, M1) are the 1D degree-p Lagrange matrices on p*N+1 uniform
nodes. An operator application is d dense (n x n) products over the DoF
lattice (``torch.tensordot``: cuBLAS on the card; the JAX package uses XLA
``tensordot`` there too, outside any Pallas kernel), and the generalised 1D
eigenproblem gives the exact fast-diagonalisation direct solve of the
coupled two-field system, as ``ops/direct.py`` does for Q1.

DoFs live on the refined lattice (p*N+1 nodes an axis, spacing h/p). The
1D matrices and eigenbases are host numpy (scipy ``eigh``, the JAX
package's own); every operator and solve runs on ``device``. ``padding``
(the sharded path's phantom rows at the high end of each grid axis) extends
each 1D factor by an identity block with no coupling, so phantom DoFs are
inert in every tensor term and carry zero data.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Callable, Tuple

import numpy as np
import scipy.linalg
import torch
from numpy.polynomial import polynomial as P

from perphil_tpu_torch.config import DeviceLike, default_dtype, resolve_device
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters


def _lagrange_coefficients(p: int):
    """Monomial coefficients of the degree-p Lagrange basis on the
    equispaced nodes j/p of [0, 1]."""
    nodes = np.linspace(0.0, 1.0, p + 1)
    basis = []
    for i in range(p + 1):
        c = np.array([1.0])
        for j in range(p + 1):
            if j == i:
                continue
            c = P.polymul(c, np.array([-nodes[j], 1.0]) / (nodes[i] - nodes[j]))
        basis.append(c)
    return basis


@lru_cache(maxsize=None)
def lagrange_ref_matrices(p: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reference 1D matrices (Khat, Mhat) of the degree-p Lagrange basis on
    [0, 1]: the physical element matrices are Khat/h and Mhat*h.
    Gauss-Legendre integration exact to degree 2p + 1."""
    basis = _lagrange_coefficients(p)
    q, w = np.polynomial.legendre.leggauss(p + 1)
    q = 0.5 * (q + 1.0)
    w = 0.5 * w
    vals = np.array([P.polyval(q, c) for c in basis])  # (p+1, nq)
    ders = np.array([P.polyval(q, P.polyder(c)) for c in basis])
    Mhat = (vals * w) @ vals.T
    Khat = (ders * w) @ ders.T
    return Khat, Mhat


@lru_cache(maxsize=None)
def assemble_1d(p: int, cells: int, h: float) -> Tuple[np.ndarray, np.ndarray]:
    """Global 1D degree-p (K1, M1) on ``cells`` uniform elements of size h,
    dense (p*cells+1)^2."""
    Khat, Mhat = lagrange_ref_matrices(p)
    n = p * cells + 1
    K = np.zeros((n, n))
    M = np.zeros((n, n))
    for e in range(cells):
        s = p * e
        K[s : s + p + 1, s : s + p + 1] += Khat / h
        M[s : s + p + 1, s : s + p + 1] += Mhat * h
    return K, M


@lru_cache(maxsize=None)
def interior_eig_1d(p: int, cells: int, h: float) -> Tuple[np.ndarray, np.ndarray]:
    """Generalised eigenpairs of the interior (Dirichlet-eliminated) 1D
    degree-p pair: K1 S = M1 S diag(lam), S^T M1 S = I."""
    K, M = assemble_1d(p, cells, h)
    lam, S = scipy.linalg.eigh(K[1:-1, 1:-1], M[1:-1, 1:-1])
    return np.ascontiguousarray(S), np.ascontiguousarray(lam)


def _apply_axis(u: torch.Tensor, A: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract the matrix A against one grid axis of u."""
    return torch.movedim(torch.tensordot(A, u, dims=([1], [axis])), 0, axis)


def _pad_identity(A: np.ndarray, pad: int) -> np.ndarray:
    """A 1D factor matrix extended by an identity phantom block with zero
    cross-coupling, ``[[A, 0], [0, I]]``."""
    n = A.shape[0]
    out = np.zeros((n + pad, n + pad), dtype=A.dtype)
    out[:n, :n] = A
    out[n:, n:] = np.eye(pad, dtype=A.dtype)
    return out


def _check_padding(padding, dim: int) -> Tuple[int, ...]:
    pad = tuple(int(p) for p in padding) or (0,) * dim
    if len(pad) != dim or any(p < 0 for p in pad):
        raise ValueError(f"padding must be {dim} nonneg ints, got {padding}")
    return pad


def _lam_sum(eig, d: int) -> np.ndarray:
    """Sum of the 1D interior eigenvalues over the axes, on the interior
    lattice (grid axes, slowest first)."""
    lams = [lam for (_, lam) in eig]
    lam_sum = np.zeros(tuple(len(l) for l in reversed(lams)))
    for ax in range(d):
        shape = [1] * d
        shape[ax] = len(lams[d - 1 - ax])
        lam_sum = lam_sum + lams[d - 1 - ax].reshape(shape)
    return lam_sum


@dataclass(frozen=True)
class TensorDPPOperator:
    """BC-eliminated monolithic DPP operator at degree p on a quad/hex
    mesh, on ``device``: the semantics of ``ops/assembly.py::DPPOperator``
    (boundary rows and columns replaced by identity) on the refined DoF
    lattice, with the same ``matvec``/``lifted_rhs``/``residual``
    signatures. With ``padding`` per grid axis the 1D factors carry inert
    identity blocks (:func:`_pad_identity`); the phantom rows are not
    boundary rows."""

    mesh: StructuredMesh
    params: DPPParameters
    degree: int
    padding: Tuple[int, ...] = ()
    device: DeviceLike = None

    def __post_init__(self):
        if not self.mesh.is_tensor_product:
            raise ValueError("Tensor-product degree-p spaces need quad/hex cells")
        if self.degree < 1:
            raise ValueError("degree must be >= 1")
        object.__setattr__(self, "padding", _check_padding(self.padding, self.mesh.dim))
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def phys_shape(self) -> Tuple[int, ...]:
        """The physical DoF lattice (no phantom rows)."""
        return tuple(self.degree * c + 1 for c in reversed(self.mesh.cells))

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        return tuple(n + p for n, p in zip(self.phys_shape, self.padding))

    @property
    def phys_interior(self) -> Tuple[slice, ...]:
        """The physical interior: no boundary row, no phantom."""
        return tuple(slice(1, n - 1) for n in self.phys_shape)

    @cached_property
    def _host_mats(self) -> Tuple[Tuple[np.ndarray, np.ndarray], ...]:
        """(K1, M1) per coordinate axis (x first), host numpy, extended by
        the identity over that axis's phantom padding."""
        d = self.mesh.dim
        out = []
        for c_ax, (c, h) in enumerate(zip(self.mesh.cells, self.mesh.h)):
            pad = self.padding[d - 1 - c_ax]  # the grid axis of this coordinate axis
            out.append(tuple(_pad_identity(A, pad) if pad else A for A in assemble_1d(self.degree, c, h)))
        return tuple(out)

    @cached_property
    def _mats(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """(K1, M1) per coordinate axis (x first) on the device."""
        dtype = default_dtype()
        return tuple(
            tuple(torch.as_tensor(A, dtype=dtype, device=self.device) for A in pair) for pair in self._host_mats
        )

    @cached_property
    def boundary_mask(self) -> np.ndarray:
        """Physical boundary rows of the DoF lattice (identity rows); the
        phantom rows are not marked."""
        m = np.zeros(self.dof_shape, dtype=bool)
        for ax, n in enumerate(self.phys_shape):
            sl = [slice(None)] * m.ndim
            sl[ax] = 0
            m[tuple(sl)] = True
            sl[ax] = n - 1
            m[tuple(sl)] = True
        return m

    @cached_property
    def _bdry(self) -> torch.Tensor:
        return torch.as_tensor(self.boundary_mask, device=self.device)

    def _K(self, u: torch.Tensor) -> torch.Tensor:
        """Stiffness: the sum over axes of K1 on that axis, M1 on the others."""
        d = u.dim()
        out = torch.zeros_like(u)
        for kax in range(d):
            term = u
            for ax in range(d):
                K1, M1 = self._mats[d - 1 - ax]  # grid axes are the coordinate axes reversed
                term = _apply_axis(term, K1 if ax == kax else M1, ax)
            out = out + term
        return out

    def _M(self, u: torch.Tensor) -> torch.Tensor:
        d = u.dim()
        for ax in range(d):
            u = _apply_axis(u, self._mats[d - 1 - ax][1], ax)
        return u

    def _raw_blocks(self, z1: torch.Tensor, z2: torch.Tensor):
        p = self.params
        K1z = self._K(z1)
        K2z = self._K(z2)
        Md = self._M(z1 - z2)
        return (p.k1 / p.mu) * K1z + (p.beta / p.mu) * Md, (p.k2 / p.mu) * K2z - (p.beta / p.mu) * Md

    def matvec(self, z1: torch.Tensor, z2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        bdry = self._bdry
        y1, y2 = self._raw_blocks(torch.where(bdry, 0.0, z1), torch.where(bdry, 0.0, z2))
        return torch.where(bdry, z1, y1), torch.where(bdry, z2, y2)

    def lifted_rhs(self, g1: torch.Tensor, g2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """RHS of the BC-eliminated system for zero forcing: interior rows
        get ``-A[interior, boundary] g``, boundary rows ``g``."""
        bdry = self._bdry
        a1, a2 = self._raw_blocks(torch.where(bdry, g1, 0.0), torch.where(bdry, g2, 0.0))
        return torch.where(bdry, g1, -a1), torch.where(bdry, g2, -a2)

    def residual(self, z1, z2, b1, b2):
        y1, y2 = self.matvec(z1, z2)
        return b1 - y1, b2 - y2

    def stacked_matvec(self) -> Callable[[torch.Tensor], torch.Tensor]:
        def mv(x: torch.Tensor) -> torch.Tensor:
            return torch.stack(self.matvec(x[0], x[1]))

        return mv

    def diagonal_stacked(self) -> torch.Tensor:
        """(2, *dof_shape) diagonal of the eliminated operator (Jacobi),
        from the 1D matrices' diagonals."""
        d = self.mesh.dim
        shape = self.dof_shape
        dK = [np.diag(K1) for K1, _ in self._host_mats]
        dM = [np.diag(M1) for _, M1 in self._host_mats]
        diag_K = np.zeros(shape)
        diag_M = np.ones(shape)
        for ax in range(d):  # grid axes, slowest first
            term = np.ones(shape)
            for ax2 in range(d):
                shape2 = [1] * d
                shape2[ax2] = shape[ax2]
                v = dK[d - 1 - ax2] if ax2 == ax else dM[d - 1 - ax2]
                term = term * v.reshape(shape2)
            diag_K = diag_K + term
            shape1 = [1] * d
            shape1[ax] = shape[ax]
            diag_M = diag_M * dM[d - 1 - ax].reshape(shape1)
        p = self.params
        d1 = (p.k1 / p.mu) * diag_K + (p.beta / p.mu) * diag_M
        d2 = (p.k2 / p.mu) * diag_K + (p.beta / p.mu) * diag_M
        stacked = np.where(self.boundary_mask, 1.0, np.stack([d1, d2]))
        return torch.as_tensor(stacked, dtype=default_dtype(), device=self.device)


@dataclass(frozen=True)
class TensorFastDiagDPP:
    """Exact direct solve of the degree-p coupled DPP system by generalised
    fast diagonalisation (the MUMPS role at any degree), on ``device``; also
    the exact solve of one field's block (``block_solve``), the fieldsplit's
    LU role. With ``padding`` the phantom rows pass through as identity
    beside the boundary rows."""

    mesh: StructuredMesh
    params: DPPParameters
    degree: int
    padding: Tuple[int, ...] = ()
    device: DeviceLike = None

    def __post_init__(self):
        object.__setattr__(self, "padding", _check_padding(self.padding, self.mesh.dim))
        object.__setattr__(self, "device", resolve_device(self.device))

    @cached_property
    def _eig(self):
        return tuple(interior_eig_1d(self.degree, c, h) for c, h in zip(self.mesh.cells, self.mesh.h))

    @cached_property
    def _bases(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        """(S, S^T) per coordinate axis on the device."""
        dtype = default_dtype()
        return tuple(
            (torch.as_tensor(S, dtype=dtype, device=self.device), torch.as_tensor(S.T, dtype=dtype, device=self.device))
            for S, _ in self._eig
        )

    @cached_property
    def _mode_data(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        lam_sum = _lam_sum(self._eig, self.mesh.dim)
        p = self.params
        a11 = (p.k1 * lam_sum + p.beta) / p.mu
        a22 = (p.k2 * lam_sum + p.beta) / p.mu
        a12 = -p.beta / p.mu
        det = a11 * a22 - a12 * a12
        return tuple(torch.as_tensor(m, dtype=default_dtype(), device=self.device) for m in (a11, a22, det))

    @cached_property
    def _field_scales(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The eigenvalues of each field's block, ``(k_i lam + beta) / mu``."""
        lam_sum = _lam_sum(self._eig, self.mesh.dim)
        p = self.params
        return tuple(
            torch.as_tensor((k * lam_sum + p.beta) / p.mu, dtype=default_dtype(), device=self.device)
            for k in (p.k1, p.k2)
        )

    def _transform(self, f: torch.Tensor, transpose: bool) -> torch.Tensor:
        d = f.dim()
        out = f
        for ax in range(d):
            S, St = self._bases[d - 1 - ax]
            out = _apply_axis(out, St if transpose else S, ax)
        return out

    def _inner(self, shape: Tuple[int, ...]) -> Tuple[slice, ...]:
        """The physical interior of a (padded) DoF grid."""
        return tuple(slice(1, n - p - 1) for n, p in zip(shape, self.padding))

    def solve(self, b1: torch.Tensor, b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Solve on full DoF grids: boundary rows (and phantom rows) pass
        through as identity (the eliminated operator's), the interior is
        solved exactly."""
        inner = self._inner(b1.shape)
        a11, a22, det = self._mode_data
        a12 = -self.params.beta / self.params.mu
        f1h = self._transform(b1[inner], transpose=True)
        f2h = self._transform(b2[inner], transpose=True)
        u1h = (a22 * f1h - a12 * f2h) / det
        u2h = (a11 * f2h - a12 * f1h) / det
        z1, z2 = b1.clone(), b2.clone()
        z1[inner] = self._transform(u1h, transpose=False)
        z2[inner] = self._transform(u2h, transpose=False)
        return z1, z2

    def block_solve(self, r: torch.Tensor, field: int) -> torch.Tensor:
        """Exact solve of field ``field``'s BC-eliminated block
        ``(k/mu) K + (beta/mu) M`` on a full DoF grid."""
        inner = self._inner(r.shape)
        z = r.clone()
        z[inner] = self._transform(self._transform(r[inner], True) / self._field_scales[field], False)
        return z


# -- degree-aware error norms (tensor-product quadrature with the Qp basis) ------


def _basis_at(p: int, pts: np.ndarray) -> np.ndarray:
    """(p+1, len(pts)) values of the degree-p Lagrange basis at reference
    coordinates in [0, 1]."""
    return np.array([P.polyval(pts, c) for c in _lagrange_coefficients(p)])


def _dbasis_at(p: int, pts: np.ndarray) -> np.ndarray:
    return np.array([P.polyval(pts, P.polyder(c)) for c in _lagrange_coefficients(p)])


def _cellwise_dofs(u: torch.Tensor, p: int, cells: Tuple[int, ...]) -> torch.Tensor:
    """Per-cell DoF blocks ``(*cells, *(p+1,)*d)`` from the lattice, both
    halves in grid-axis order (slowest first)."""
    d = u.dim()
    out = u
    for ax in range(d):
        c = cells[d - 1 - ax]
        idx = (p * np.arange(c))[:, None] + np.arange(p + 1)[None, :]
        out = torch.index_select(out, ax, torch.as_tensor(idx.ravel(), device=u.device))
        out = out.reshape(out.shape[:ax] + (c, p + 1) + out.shape[ax + 1 :])
        out = torch.movedim(out, ax + 1, -1)
    return out


def _grad_component(exact: Callable, k: int) -> Callable:
    """d(exact)/dx_k at tensors of points, by ``torch.func``."""
    grad = torch.func.vmap(torch.func.grad(exact, argnums=k))

    def g(*xs):
        return grad(*[x.reshape(-1) for x in xs]).reshape(xs[0].shape)

    return g


def errornorm_p(
    u: torch.Tensor,
    exact,
    mesh: StructuredMesh,
    p: int,
    kind: str = "l2",
    quadrature_degree: int = 14,
) -> float:
    """L2 (``kind="l2"``) or H1-seminorm (``"h1s"``) error of a degree-p
    lattice function against a callable of coordinate tensors, by
    tensor-product Gauss-Legendre quadrature of ``quadrature_degree``
    (14, the degree-1 norms' parity-critical default). ``exact`` may be a
    Function on the same mesh and degree: the norm of the difference field
    is integrated."""
    from perphil_tpu_torch.forms import spaces as _spaces

    if isinstance(exact, _spaces.Function):
        ef = exact
        if tuple(ef.space.mesh.node_shape) != tuple(mesh.node_shape) or ef.space.degree != p:
            raise TypeError(
                "Function-valued exact must live on the same mesh and degree "
                f"(got degree {ef.space.degree} on {ef.space.mesh.node_shape} "
                f"vs degree {p} on {mesh.node_shape})"
            )
        u = u - ef.data

        def exact(*xs):  # noqa: F811 - the difference field against zero
            return torch.zeros_like(xs[0])

    d = mesh.dim
    dev, dtype = u.device, u.dtype
    nq = quadrature_degree // 2 + 1
    q, w = np.polynomial.legendre.leggauss(nq)
    q = 0.5 * (q + 1.0)
    w = 0.5 * w
    B = torch.as_tensor(_basis_at(p, q), dtype=dtype, device=dev)  # (p+1, nq)
    D = torch.as_tensor(_dbasis_at(p, q), dtype=dtype, device=dev)
    cells, hs = mesh.cells, mesh.h
    ud = _cellwise_dofs(u, p, cells)

    def eval_field(mats):
        # contract the local axes one at a time (grid order); each appends
        # its quadrature axis at the end
        out = ud
        for ax in range(d):
            out = torch.tensordot(out, mats[d - 1 - ax], dims=([d], [0]))
        return out  # (*cells, *nq) in grid order

    def coord_grid(ax_c):
        pts = np.arange(cells[ax_c])[:, None] * hs[ax_c] + q[None, :] * hs[ax_c]  # (c, nq)
        shape_cells = [1] * d
        shape_cells[d - 1 - ax_c] = cells[ax_c]
        shape_q = [1] * d
        shape_q[d - 1 - ax_c] = nq
        return pts.reshape(tuple(shape_cells) + tuple(shape_q))

    Xs = [coord_grid(ax_c) for ax_c in range(d)]
    wgrid = np.ones(())
    for ax_c in range(d):
        shape_q = [1] * d
        shape_q[d - 1 - ax_c] = nq
        wgrid = wgrid * (w * hs[ax_c]).reshape(tuple(shape_q))

    def on_device(a, shape):
        return torch.as_tensor(np.ascontiguousarray(np.broadcast_to(a, shape)), dtype=dtype, device=dev)

    if kind == "l2":
        uq = eval_field([B] * d)
        ex = exact(*[on_device(X, uq.shape) for X in Xs])
        return float(torch.sqrt(torch.sum((uq - ex) ** 2 * on_device(wgrid, uq.shape))))
    if kind == "h1s":
        total = torch.zeros((), dtype=dtype, device=dev)
        for k in range(d):
            mats = [B] * d
            mats[k] = D  # the derivative along coordinate axis k
            duq = eval_field(mats) / hs[k]
            ex = _grad_component(exact, k)(*[on_device(X, duq.shape) for X in Xs])
            total = total + torch.sum((duq - ex) ** 2 * on_device(wgrid, duq.shape))
        return float(torch.sqrt(total))
    raise ValueError(kind)
