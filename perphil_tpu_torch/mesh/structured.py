"""Structured meshes on the unit square / unit cube.

Counterpart of ``perphil_tpu/mesh/structured.py``; host-side numpy, with the
same conventions. A mesh is shape metadata only: coordinates, boundary masks
and element adjacency are index arithmetic, which keeps every operator a
constant stencil.

Element types:
  - ``quad`` / ``hex``: tensor-product Q1 cells.
  - ``triangle``: each grid square split in two; ``diagonal="left"`` matches
    Firedrake's ``UnitSquareMesh`` default.
  - ``tet``: Kuhn/Freudenthal subdivision of each cube into 6 tetrahedra.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

_SIMPLEX_MULTIPLICITY = {"quad": 1, "hex": 1, "triangle": 2, "tet": 6}


@dataclass(frozen=True)
class StructuredMesh:
    """A uniform structured mesh of the unit box [0,1]^d.

    :param cells: grid cells per dimension, ordered (nx, ny[, nz]).
    :param element: one of "quad", "triangle", "hex", "tet".
    :param diagonal: split direction for simplicial meshes.
    """

    cells: Tuple[int, ...]
    element: str = "quad"
    diagonal: str = "left"
    extent: Tuple[float, ...] = field(default=())

    def __post_init__(self):
        if self.element not in _SIMPLEX_MULTIPLICITY:
            raise ValueError(f"Unknown element type: {self.element!r}")
        dim = 2 if self.element in ("quad", "triangle") else 3
        if len(self.cells) != dim:
            raise ValueError(
                f"{self.element} mesh needs {dim} cell counts, got {self.cells}"
            )
        if any(n < 1 for n in self.cells):
            raise ValueError(f"Cell counts must be >= 1, got {self.cells}")
        if not self.extent:
            object.__setattr__(self, "extent", (1.0,) * dim)

    @property
    def dim(self) -> int:
        return len(self.cells)

    @property
    def h(self) -> Tuple[float, ...]:
        """Grid spacing per dimension (hx, hy[, hz])."""
        return tuple(e / n for e, n in zip(self.extent, self.cells))

    @property
    def node_shape(self) -> Tuple[int, ...]:
        """Vertex-grid shape, slowest axis first: 2D ``(ny+1, nx+1)``
        indexed ``u[j, i]``; 3D ``(nz+1, ny+1, nx+1)`` indexed ``u[k, j, i]``."""
        return tuple(n + 1 for n in reversed(self.cells))

    @property
    def num_vertices(self) -> int:
        return int(np.prod(self.node_shape))

    @property
    def num_cells(self) -> int:
        """Number of FE cells, counting the simplicial subdivision."""
        return int(np.prod(self.cells)) * _SIMPLEX_MULTIPLICITY[self.element]

    @property
    def is_tensor_product(self) -> bool:
        """True for quad/hex cells (the exact fast-diagonalization solver)."""
        return self.element in ("quad", "hex")

    def coordinates(self) -> Tuple[np.ndarray, ...]:
        """Vertex coordinate grids (X, Y[, Z]) in coordinate order, each of
        shape ``node_shape`` and indexed grid-style."""
        axes_1d = [
            np.linspace(0.0, e, n + 1) for e, n in zip(self.extent, self.cells)
        ]
        grids = np.meshgrid(*reversed(axes_1d), indexing="ij")
        return tuple(reversed(grids))

    def boundary_mask(self) -> np.ndarray:
        """Boolean grid marking vertices on the domain boundary."""
        mask = np.zeros(self.node_shape, dtype=bool)
        for axis in range(len(self.node_shape)):
            sl_lo = [slice(None)] * len(self.node_shape)
            sl_hi = [slice(None)] * len(self.node_shape)
            sl_lo[axis] = 0
            sl_hi[axis] = -1
            mask[tuple(sl_lo)] = True
            mask[tuple(sl_hi)] = True
        return mask

    def interior_mask(self) -> np.ndarray:
        return ~self.boundary_mask()

    @property
    def num_interior_vertices(self) -> int:
        return int(np.prod([n - 1 for n in self.cells]))

    def hmax(self) -> float:
        """Largest cell diameter."""
        return math.sqrt(sum(hi * hi for hi in self.h))


def create_mesh(num_x: int, num_y: int, quadrilateral: bool = True) -> StructuredMesh:
    """2D unit-square mesh of quads (default) or triangles."""
    return StructuredMesh(
        cells=(num_x, num_y), element="quad" if quadrilateral else "triangle"
    )


def create_cube_mesh(
    num_x: int, num_y: int, num_z: int, hexahedral: bool = False
) -> StructuredMesh:
    """3D unit-cube mesh of tetrahedra (default) or hexahedra."""
    return StructuredMesh(
        cells=(num_x, num_y, num_z), element="hex" if hexahedral else "tet"
    )
