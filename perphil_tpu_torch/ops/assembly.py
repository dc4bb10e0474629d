"""Operator assembly with Dirichlet boundary conditions.

Counterpart of ``perphil_tpu/ops/assembly.py`` (the matrix-free monolithic
operator, the fieldsplit blocks and their coupling). Dirichlet BCs are
eliminated symmetrically: boundary rows and columns are zeroed with a unit
diagonal, and the RHS is lifted. The monolithic matvec and lift go through
K1 (``ops/fused_apply.py``), which folds the box-boundary masking into the
stencil pass; the blocks (``FieldOperator``, ``coupling_apply``) are plain
stencil passes, as in the JAX package.

For the conditioning analysis it also holds :class:`FullMassOperator` (the
raw consistent mass matrix, exact on boundary rows) and the host CSR
materialisations of the BC-eliminated blocks and monolithic matrix
(:func:`materialize_field_csr`, :func:`materialize_monolithic_csr`; scipy).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from perphil_tpu_torch.config import DeviceLike, default_dtype, resolve_device
from perphil_tpu_torch.forms.spaces import Expr, FunctionSpace, MixedFunctionSpace, _evaluate
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply, fused_dpp_apply_halo, fused_dpp_apply_stacked
from perphil_tpu_torch.ops.stencil import apply_stencil, compile_stencils


@dataclass(frozen=True)
class DirichletBC:
    """Dirichlet condition on the whole boundary of one (sub-)space.

    :param space: a ``FunctionSpace`` or an indexed sub-space ``W.sub(i)``.
    :param value: constant, array/tensor, or callable of coordinate tensors.
    :param region: only "on_boundary" is supported.
    """

    space: FunctionSpace
    value: Expr
    region: str = "on_boundary"

    def __post_init__(self):
        if self.region != "on_boundary":
            raise ValueError("Only region='on_boundary' is supported")

    @property
    def sub_index(self) -> int:
        return getattr(self.space, "index", 0)

    def grid_values(self, mesh: StructuredMesh) -> torch.Tensor:
        """Values at the mesh vertices on the space's device (only the
        boundary entries are used)."""
        return _evaluate(self.value, mesh, (), self.space.device)


def bc_values_per_field(
    W: MixedFunctionSpace, bcs: Optional[Sequence[DirichletBC]]
) -> Tuple[torch.Tensor, ...]:
    """Per-field boundary-value grids on ``W``'s device (zero where no BC),
    on each field's DoF lattice (the refined one at degree p)."""
    vals = [
        torch.zeros(s.dof_shape, dtype=default_dtype(), device=W.device) for s in W.spaces
    ]
    for bc in bcs or ():
        vals[bc.sub_index] = bc.grid_values(W.spaces[bc.sub_index].dof_mesh)
    return tuple(vals)


def _masks(mesh: StructuredMesh, padding: Tuple[int, ...] = ()):
    """(boundary, interior) boolean node grids, numpy. Phantom nodes (the
    ``padding`` at the high end of each grid axis, which makes node counts
    divisible by a device mesh) are boundary: identity rows with zero data,
    so a solve on the padded grid has the unpadded iterates."""
    bdry = mesh.boundary_mask()
    if padding and any(padding):
        bdry = np.pad(bdry, [(0, p) for p in padding], mode="constant", constant_values=True)
    return bdry, ~bdry


def normalize_padding(mesh: StructuredMesh, padding) -> Tuple[int, ...]:
    """Validate and normalise a per-grid-axis (slowest first) padding
    tuple: () means none."""
    if not padding:
        return (0,) * mesh.dim
    padding = tuple(int(p) for p in padding)
    if len(padding) != mesh.dim or any(p < 0 for p in padding):
        raise ValueError(f"Bad padding {padding} for a {mesh.dim}D mesh")
    return padding


@lru_cache(maxsize=None)
def dpp_stencils(
    mesh: StructuredMesh, params: DPPParameters
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Combined two-field stencils (S1, S2, C), host numpy:
    ``S_i = (k_i/mu) K + (beta/mu) M`` and ``C = -(beta/mu) M``."""
    K_st, M_st = compile_stencils(mesh)
    p = params
    S1 = (p.k1 / p.mu) * K_st + (p.beta / p.mu) * M_st
    S2 = (p.k2 / p.mu) * K_st + (p.beta / p.mu) * M_st
    C = -(p.beta / p.mu) * M_st
    return S1, S2, C


@dataclass(frozen=True)
class DPPOperator:
    """The BC-eliminated monolithic DPP operator:

        A = [[ (k1/mu) K + (beta/mu) M,        -(beta/mu) M        ],
             [       -(beta/mu) M,        (k2/mu) K + (beta/mu) M ]]

    with identity rows/columns at the boundary DoFs of each field. The
    stencil weights are host constants that K1 takes by value at launch.
    With ``padding`` the fields carry phantom nodes at the high end of each
    grid axis (boundary rows, zero data): the operator then runs K1's halo
    form, which takes the boundary from the physical node grid.
    """

    W: MixedFunctionSpace
    params: DPPParameters
    padding: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.W.num_sub_spaces() != 2:
            raise ValueError(f"Expected a 2-field MixedFunctionSpace, got {type(self.W)}")
        object.__setattr__(self, "padding", normalize_padding(self.W.mesh, self.padding))

    @property
    def mesh(self) -> StructuredMesh:
        return self.W.mesh

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        """Working grid shape: the node grid plus the phantom padding."""
        return tuple(n + p for n, p in zip(self.mesh.node_shape, self.padding))

    @property
    def padded(self) -> bool:
        return any(self.padding)

    @property
    def _combined_stencils(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return dpp_stencils(self.mesh, self.params)

    @cached_property
    def _mask_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        bdry, interior = _masks(self.mesh, self.padding)
        dev = self.W.device
        return torch.as_tensor(bdry, device=dev), torch.as_tensor(interior, device=dev)

    def _padded_apply(self, z: torch.Tensor, mode: str) -> torch.Tensor:
        """K1's halo form on the stacked padded grid."""
        return fused_dpp_apply_halo(z, *self._combined_stencils, mode=mode, n_phys=self.mesh.node_shape)

    def matvec(self, z1: torch.Tensor, z2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Apply the BC-eliminated operator to grid-shaped fields (K1)."""
        if self.padded:
            return tuple(self._padded_apply(torch.stack([z1, z2]), "matvec"))
        return fused_dpp_apply(z1, z2, *self._combined_stencils, mode="matvec")

    def residual(
        self, z1: torch.Tensor, z2: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        y1, y2 = self.matvec(z1, z2)
        return b1 - y1, b2 - y2

    def lifted_rhs(
        self, g1: torch.Tensor, g2: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """RHS of the BC-eliminated system for zero forcing (K1): interior
        rows get ``-A[interior, boundary] g``, boundary rows get ``g``."""
        if self.padded:
            return tuple(self._padded_apply(torch.stack([g1, g2]), "lift"))
        return fused_dpp_apply(g1, g2, *self._combined_stencils, mode="lift")

    def flat_matvec(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Operator on the flat field-major vector ``(2 n,)`` (K1 on a view
        of it, no concatenation)."""
        shape = (2,) + tuple(self.grid_shape)
        mv = self.stacked_matvec()
        return lambda x: mv(x.reshape(shape)).reshape(-1)

    def stacked_matvec(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Operator on stacked fields ``(2, *node_shape)`` (K1 on the stacked
        tensor, no stack)."""
        if self.padded:
            return lambda x: self._padded_apply(x, "matvec")
        S = self._combined_stencils
        return lambda x: fused_dpp_apply_stacked(x, *S, mode="matvec")

    def diagonal(self) -> torch.Tensor:
        """Flat diagonal of the BC-eliminated operator (field-major)."""
        S1, S2, _ = self._combined_stencils
        center = (1,) * self.mesh.dim
        bdry, _ = self._mask_arrays
        d = [
            torch.full(bdry.shape, float(S[center]), dtype=default_dtype(), device=bdry.device)
            .masked_fill_(bdry, 1.0)
            .reshape(-1)
            for S in (S1, S2)
        ]
        return torch.cat(d)


@dataclass(frozen=True)
class FieldOperator:
    """One diagonal block ``(k/mu) K + (beta/mu) M`` with BC elimination:
    the fieldsplit preconditioner blocks. Counterpart of
    ``perphil_tpu/ops/assembly.py::FieldOperator`` (``matvec``,
    ``mass_apply``, ``lifted_rhs``, ``stencil``), in ``apply_stencil``'s
    order on the space's device; ``padding`` as in :class:`DPPOperator`."""

    V: FunctionSpace
    k: float
    beta: float
    mu: float
    padding: Tuple[int, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "padding", normalize_padding(self.V.mesh, self.padding))

    @property
    def mesh(self) -> StructuredMesh:
        return self.V.mesh

    @cached_property
    def _mask_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        bdry, interior = _masks(self.mesh, self.padding)
        dev = self.V.device
        return torch.as_tensor(bdry, device=dev), torch.as_tensor(interior, device=dev)

    @cached_property
    def stencil(self) -> np.ndarray:
        K_st, M_st = compile_stencils(self.mesh)
        return (self.k / self.mu) * K_st + (self.beta / self.mu) * M_st

    def matvec(self, z: torch.Tensor) -> torch.Tensor:
        """Identity boundary rows, the stencil on the interior-masked input."""
        bdry, interior = self._mask_arrays
        y = apply_stencil(torch.where(interior, z, 0.0), self.stencil)
        return torch.where(bdry, z, y)

    def mass_apply(self, z: torch.Tensor) -> torch.Tensor:
        """Interior-stencil consistent-mass application ``(beta/mu) M z``;
        not exact on boundary rows (callers discard them)."""
        _, M_st = compile_stencils(self.mesh)
        return (self.beta / self.mu) * apply_stencil(z, M_st)

    def lifted_rhs(self, g: torch.Tensor, f: Optional[torch.Tensor] = None) -> torch.Tensor:
        """RHS of ``A z = f`` with boundary values ``g``; ``f`` is a full
        load vector or None for zero forcing."""
        bdry, _ = self._mask_arrays
        lift = apply_stencil(torch.where(bdry, g, 0.0), self.stencil)
        b = -lift if f is None else f - lift
        return torch.where(bdry, g, b)


def coupling_apply(
    mesh: StructuredMesh, params: DPPParameters, device: torch.device
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The off-diagonal block ``C = -(beta/mu) M`` with BC rows and columns
    zeroed, on one field's grid: ``coef * apply_stencil(z_interior, M)``
    (``perphil_tpu/solvers/solver.py::_coupling_apply``)."""
    _, M_st = compile_stencils(mesh)
    bdry = torch.as_tensor(mesh.boundary_mask(), device=device)
    coef = -(params.beta / params.mu)

    def C(z: torch.Tensor) -> torch.Tensor:
        zi = torch.where(bdry, 0.0, z)
        return torch.where(bdry, 0.0, coef * apply_stencil(zi, M_st))

    return C


@dataclass(frozen=True)
class FullMassOperator:
    """The raw (no-BC) consistent mass matrix as a gather/scatter element
    matvec, exact on boundary rows unlike the interior-only stencil path
    (``perphil_tpu/ops/assembly.py::FullMassOperator``); its diagonal on
    ``device``."""

    mesh: StructuredMesh
    device: DeviceLike = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @cached_property
    def _subcells(self):
        from perphil_tpu_torch.ops.element import cell_subcells

        return cell_subcells(self.mesh.element, self.mesh.h, self.mesh.diagonal)

    def _slices(self, off) -> Tuple[slice, ...]:
        # vertex offsets are coordinate-ordered; grid axes are reversed
        return tuple(slice(int(o), int(o) + c) for o, c in zip(reversed(off), reversed(self.mesh.cells)))

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(u)
        for verts, _, Me in self._subcells:
            for a in range(verts.shape[0]):
                acc = None
                for b in range(verts.shape[0]):
                    term = float(Me[a, b]) * u[self._slices(verts[b])]
                    acc = term if acc is None else acc + term
                out[self._slices(verts[a])] += acc
        return out

    def diagonal(self) -> torch.Tensor:
        d = torch.zeros(self.mesh.node_shape, dtype=default_dtype(), device=self.device)
        for verts, _, Me in self._subcells:
            for a in range(verts.shape[0]):
                d[self._slices(verts[a])] += float(Me[a, a])
        return d


# -- CSR materialisation (host, scipy: the conditioning analysis) --------------


def _block_csr(
    mesh: StructuredMesh, stencil: np.ndarray, zero_bc_rows_cols: bool = True, unit_diagonal: bool = False
) -> sp.csr_matrix:
    """One stencil block as scipy CSR with BC elimination. Valid because
    after symmetric elimination every surviving off-diagonal entry couples
    two interior vertices, whose raw rows carry the full stencil weights."""
    shape = mesh.node_shape
    d = len(shape)
    n = int(np.prod(shape))
    bdry = mesh.boundary_mask().ravel()
    strides = np.array([int(np.prod(shape[ax + 1 :])) for ax in range(d)])
    idx_grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    flat = np.arange(n).reshape(shape)
    rows, cols, vals = [], [], []
    for off in np.ndindex(*((3,) * d)):
        w = stencil[off]
        if w == 0.0:
            continue
        delta = np.array(off) - 1
        valid = np.ones(shape, dtype=bool)
        for ax in range(d):
            if delta[ax] == -1:
                valid &= idx_grids[ax] >= 1
            elif delta[ax] == 1:
                valid &= idx_grids[ax] <= shape[ax] - 2
        r = flat[valid]
        c = r + int(np.dot(delta, strides))
        keep = ~bdry[r] & ~bdry[c] if zero_bc_rows_cols else np.ones(r.shape, dtype=bool)
        rows.append(r[keep])
        cols.append(c[keep])
        vals.append(np.full(keep.sum(), w))
    if unit_diagonal and zero_bc_rows_cols:
        db = np.where(bdry)[0]
        rows.append(db)
        cols.append(db)
        vals.append(np.ones(db.shape[0]))
    A = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n))
    return A.tocsr()


def materialize_field_csr(op: FieldOperator) -> sp.csr_matrix:
    """CSR of one BC-eliminated diagonal block."""
    return _block_csr(op.mesh, np.asarray(op.stencil), True, True)


def materialize_monolithic_csr(W: MixedFunctionSpace, params: DPPParameters) -> Tuple[sp.csr_matrix, int, int]:
    """CSR of the BC-eliminated monolithic matrix in field-major DoF order,
    and the two fields' block sizes: (csr, n0, n1)."""
    if W.spaces[0].degree > 1:
        raise NotImplementedError(
            "CSR materialization covers the Q1 stencil pattern only; "
            f"degree-{W.spaces[0].degree} conditioning analysis is not "
            "supported (the published conditioning artifacts are all Q1)"
        )
    S1, S2, C = dpp_stencils(W.mesh, params)
    A11 = _block_csr(W.mesh, S1, True, True)
    A22 = _block_csr(W.mesh, S2, True, True)
    A12 = _block_csr(W.mesh, C, True, False)
    A = sp.bmat([[A11, A12], [A12, A22]], format="csr")
    A.eliminate_zeros()
    return A, W.sub(0).dim(), W.sub(1).dim()
