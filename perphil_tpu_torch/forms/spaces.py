"""Function spaces and Functions on structured meshes.

Counterpart of ``perphil_tpu/forms/spaces.py``: continuous Lagrange spaces
of any degree on quad/hex meshes (Qp, ``ops/tensorfem.py``) and of degree 1
or 2 on tri/tet meshes (P1, P2: ``ops/simplexfem.py``). DoFs are
grid-shaped tensors over ``dof_mesh.node_shape``, the p-times refined
lattice (equispaced Lagrange nodes are a refined uniform grid; P2's
vertices and edge midpoints are the once-refined lattice). A space carries
its device: every tensor derived from it (boundary grids, operator and
solver buffers, solutions) lives there.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from perphil_tpu_torch.config import DeviceLike, default_dtype, resolve_device
from perphil_tpu_torch.mesh.structured import StructuredMesh


@dataclass(frozen=True)
class FunctionSpace:
    """Scalar or vector CG space on a structured mesh.

    :param mesh: the structured mesh.
    :param family: "CG" (aliases "Lagrange", "Q", "P" accepted).
    :param degree: polynomial degree: any p on quad/hex meshes (Qp), 1 or 2
        on simplex meshes (P1/P2).
    :param value_shape: () for scalar, (dim,) for vector spaces.
    :param device: where the space's tensors live (default: the current CUDA device; pass "cpu" for the CPU).
    """

    mesh: StructuredMesh
    family: str = "CG"
    degree: int = 1
    value_shape: Tuple[int, ...] = ()
    device: DeviceLike = None

    def __post_init__(self):
        if self.family not in ("CG", "Lagrange", "Q", "P"):
            raise ValueError(f"Unsupported family {self.family!r}; only CG1-type spaces exist")
        if self.degree < 1:
            raise ValueError("degree must be >= 1")
        if self.degree > 2 and not self.mesh.is_tensor_product:
            raise ValueError(
                "Simplex meshes support degrees 1 and 2 (P2 DoFs are the "
                "once-refined lattice, ops/simplexfem); degree > 2 has no "
                "half-lattice structure. Tensor-product meshes support any "
                "degree (Qp via ops/tensorfem)."
            )
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def dof_mesh(self) -> StructuredMesh:
        """The lattice carrying the DoFs: the mesh itself at degree 1, the
        p-times refined lattice at degree p."""
        if self.degree == 1:
            return self.mesh
        return replace(self.mesh, cells=tuple(self.degree * c for c in self.mesh.cells))

    def dim(self) -> int:
        """Total number of degrees of freedom."""
        return self.dof_mesh.num_vertices * int(np.prod(self.value_shape, dtype=int) or 1)

    def num_sub_spaces(self) -> int:
        return 0

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        return self.dof_mesh.node_shape + self.value_shape


@dataclass(frozen=True)
class IndexedFunctionSpace(FunctionSpace):
    """A sub-space handle from ``MixedFunctionSpace.sub(i)``; carries its
    field index so ``DirichletBC(W.sub(i), ...)`` knows its field."""

    index: int = 0


@dataclass(frozen=True)
class MixedFunctionSpace:
    """A product of scalar spaces, e.g. W = V x V for (p1, p2); field-major
    DoF numbering. All sub-spaces share one mesh and one device."""

    spaces: Tuple[FunctionSpace, ...]

    def __post_init__(self):
        if len(self.spaces) < 1:
            raise ValueError("MixedFunctionSpace needs at least one sub-space")
        mesh = self.spaces[0].mesh
        if any(s.mesh != mesh for s in self.spaces):
            raise ValueError("All sub-spaces must share one mesh")
        device = self.spaces[0].device
        if any(s.device != device for s in self.spaces):
            raise ValueError("All sub-spaces must share one device")

    @property
    def mesh(self) -> StructuredMesh:
        return self.spaces[0].mesh

    @property
    def device(self) -> torch.device:
        return self.spaces[0].device

    def num_sub_spaces(self) -> int:
        return len(self.spaces)

    def sub(self, i: int) -> IndexedFunctionSpace:
        base = self.spaces[i]
        return IndexedFunctionSpace(
            mesh=base.mesh,
            family=base.family,
            degree=base.degree,
            value_shape=base.value_shape,
            device=base.device,
            index=i,
        )

    def dim(self) -> int:
        return sum(s.dim() for s in self.spaces)


def mixed_space(V: FunctionSpace, n: int = 2) -> MixedFunctionSpace:
    """W = V x V (x ... n times)."""
    return MixedFunctionSpace(spaces=(V,) * n)


def create_function_spaces(
    mesh: StructuredMesh,
    velocity_deg: int = 1,
    pressure_deg: int = 1,
    velocity_family: str = "CG",
    pressure_family: str = "CG",
    device: DeviceLike = None,
) -> Tuple[FunctionSpace, FunctionSpace]:
    """Build (velocity, pressure) spaces on ``device``."""
    device = resolve_device(device)
    U = FunctionSpace(
        mesh, family=velocity_family, degree=velocity_deg, value_shape=(mesh.dim,),
        device=device,
    )
    V = FunctionSpace(mesh, family=pressure_family, degree=pressure_deg, device=device)
    return U, V


Expr = Union[Callable[..., torch.Tensor], float, int, torch.Tensor, np.ndarray]


def _evaluate(
    expr: Expr,
    mesh: StructuredMesh,
    value_shape: Tuple[int, ...],
    device: DeviceLike = None,
) -> torch.Tensor:
    """Evaluate an expression (callable of coordinate tensors, constant, or
    array) at the mesh vertices, as a grid-shaped float64 tensor on
    ``device``."""
    dtype = default_dtype()
    device = resolve_device(device)
    target = mesh.node_shape + value_shape
    if callable(expr):
        coords = [torch.as_tensor(c, dtype=dtype, device=device) for c in mesh.coordinates()]
        val = expr(*coords)
        if value_shape and isinstance(val, (tuple, list)):
            val = torch.stack([torch.broadcast_to(v, mesh.node_shape) for v in val], dim=-1)
    else:
        val = expr
    val = torch.as_tensor(val, dtype=dtype, device=device)
    return torch.broadcast_to(val, target)


class Function:
    """A finite-element function: vertex DoF tensors with space metadata."""

    def __init__(
        self,
        space: Union[FunctionSpace, MixedFunctionSpace],
        data=None,
        name: Optional[str] = None,
    ):
        self.space = space
        self.name = name
        dtype, device = default_dtype(), space.device
        if isinstance(space, MixedFunctionSpace):
            if data is None:
                data = tuple(
                    torch.zeros(s.dof_shape, dtype=dtype, device=device) for s in space.spaces
                )
            self.data = tuple(torch.as_tensor(d, dtype=dtype, device=device) for d in data)
        else:
            if data is None:
                data = torch.zeros(space.dof_shape, dtype=dtype, device=device)
            self.data = torch.as_tensor(data, dtype=dtype, device=device)

    def function_space(self):
        return self.space

    def sub(self, i: int) -> "Function":
        if not isinstance(self.space, MixedFunctionSpace):
            raise ValueError("sub() is only available on mixed-space Functions")
        return Function(self.space.sub(i), self.data[i])

    def split(self) -> Tuple["Function", ...]:
        if not isinstance(self.space, MixedFunctionSpace):
            raise ValueError("split() is only available on mixed-space Functions")
        return tuple(self.sub(i) for i in range(self.space.num_sub_spaces()))

    @property
    def dat(self) -> torch.Tensor:
        """Flat DoF vector (field-major for mixed spaces)."""
        if isinstance(self.space, MixedFunctionSpace):
            return torch.cat([d.reshape(-1) for d in self.data])
        return self.data.reshape(-1)

    def interpolate(self, expr: Expr) -> "Function":
        """Set DoFs to the expression's nodal values (on the refined lattice
        at degree p: the degree-p Lagrange interpolant)."""
        if isinstance(self.space, MixedFunctionSpace):
            raise ValueError("Interpolate into sub-functions individually")
        self.data = _evaluate(expr, self.space.dof_mesh, self.space.value_shape, self.space.device)
        return self

    def assign(self, other: Union["Function", Expr]) -> "Function":
        if isinstance(other, Function):
            self.data = other.data
            return self
        return self.interpolate(other)

    def at(self, points) -> torch.Tensor:
        """Values at physical points (n, dim) or one point (dim,), by
        (bi/tri)linear interpolation on the DoF lattice: exact at the nodes;
        at degree p, O(h^2/p^2) between them."""
        if isinstance(self.space, MixedFunctionSpace):
            raise ValueError("Evaluate sub-functions individually")
        mesh = self.space.dof_mesh
        pts = torch.as_tensor(points, dtype=default_dtype(), device=self.data.device)
        single = pts.dim() == 1
        pts = torch.atleast_2d(pts)
        h = torch.as_tensor(mesh.h, dtype=pts.dtype, device=pts.device)
        cells = torch.as_tensor(mesh.cells, device=pts.device)
        t = pts / h
        cell = torch.minimum(torch.clamp(torch.floor(t).long(), min=0), cells - 1)
        loc = t - cell
        vals = 0.0
        for corner in np.ndindex(*((2,) * mesh.dim)):
            w = 1.0
            idx = []
            for ax, c in enumerate(corner):
                w = w * (loc[:, ax] if c == 1 else 1.0 - loc[:, ax])
                idx.append(cell[:, ax] + c)
            # grid tensors index slowest axis first: reverse the coordinate order
            vals = vals + w * self.data[tuple(reversed(idx))]
        return vals[0] if single else vals

    def copy(self) -> "Function":
        return Function(self.space, self.data, name=self.name)
