"""Stencil compilation (host numpy) and application (torch).

Counterpart of ``perphil_tpu/ops/stencil.py``. On a uniform structured mesh
every interior row of an assembled FEM operator has the same weights, so the
matrix is a constant ``3^d`` stencil, assembled once on the host from the
element matrices.

Axis convention: stencil arrays are indexed ``[dz+1, dy+1, dx+1]`` (slowest
axis first), matching grid tensors ``u[k, j, i]``.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.ops.element import cell_subcells


@lru_cache(maxsize=None)
def _stencils_cached(
    cells: Tuple[int, ...], element: str, diagonal: str, extent: Tuple[float, ...]
) -> Tuple[np.ndarray, np.ndarray]:
    mesh = StructuredMesh(cells=cells, element=element, diagonal=diagonal, extent=extent)
    d = mesh.dim
    K_st = np.zeros((3,) * d)
    M_st = np.zeros((3,) * d)
    # every sub-cell of every grid cell touching the central vertex (cell
    # corner offsets in {-1, 0}^d) contributes its central row
    for corner in itertools.product((-1, 0), repeat=d):
        corner = np.asarray(corner, dtype=np.int64)
        for verts, Ke, Me in cell_subcells(element, mesh.h, diagonal):
            pos = verts + corner
            for a in np.where((pos == 0).all(axis=1))[0]:
                for b in range(pos.shape[0]):
                    idx = tuple(int(o) + 1 for o in reversed(pos[b]))
                    K_st[idx] += Ke[a, b]
                    M_st[idx] += Me[a, b]
    K_st.setflags(write=False)
    M_st.setflags(write=False)
    return K_st, M_st


def compile_stencils(mesh: StructuredMesh) -> Tuple[np.ndarray, np.ndarray]:
    """Return (K_stencil, M_stencil), each a read-only ``(3,)*dim`` array:
    the unit-conductivity stiffness stencil and the consistent-mass
    stencil. Every DPP block is ``(k/mu) K + (beta/mu) M``."""
    return _stencils_cached(mesh.cells, mesh.element, mesh.diagonal, mesh.extent)


def apply_stencil(u: torch.Tensor, stencil: np.ndarray) -> torch.Tensor:
    """Apply a constant 3^d stencil to a grid tensor by shifted adds over a
    zero-padded copy. Valid at interior nodes (boundary rows of the
    BC-eliminated operators never go through this path). Zero weights are
    skipped."""
    d = u.dim()
    up = F.pad(u, (1, 1) * d)
    shape = u.shape
    out = None
    for idx in itertools.product(range(3), repeat=d):
        w = float(stencil[idx])
        if w == 0.0:
            continue
        term = w * up[tuple(slice(k, k + s) for k, s in zip(idx, shape))]
        out = term if out is None else out + term
    return torch.zeros_like(u) if out is None else out
