"""Build the port's DPP state from plain numpy and dict inputs.

The DPP system has no weights: its state is the model parameters, the mesh,
the function space and the Dirichlet boundary grids. :func:`from_numpy_state`
makes them from plain values, so that another implementation (the JAX
package, in the parity tests) can solve the same system from the same
inputs.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from perphil_tpu_torch.config import DeviceLike, default_dtype, resolve_device
from perphil_tpu_torch.forms.spaces import MixedFunctionSpace, create_function_spaces, mixed_space
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC


class DPPState(NamedTuple):
    params: DPPParameters
    mesh: StructuredMesh
    W: MixedFunctionSpace
    grids: Tuple[torch.Tensor, torch.Tensor]

    @property
    def bcs(self) -> Tuple[DirichletBC, DirichletBC]:
        """Dirichlet conditions of both fields from the boundary grids."""
        return (DirichletBC(self.W.sub(0), self.grids[0]), DirichletBC(self.W.sub(1), self.grids[1]))


def from_numpy_state(
    params: Mapping[str, float],
    cells: Sequence[int],
    element: str,
    g1: np.ndarray,
    g2: np.ndarray,
    device: DeviceLike = None,
) -> DPPState:
    """Port-side DPP state.

    :param params: ``DPPParameters`` fields (``k1``, ``k2``, ``beta``,
        ``mu``, ``scale_contrast``), any subset.
    :param cells: grid cells per dimension (nx, ny[, nz]).
    :param element: "quad" | "triangle" | "hex" | "tet".
    :param g1, g2: per-field Dirichlet data on the node grid (only the
        boundary entries are used).
    :param device: where the state lives: the current CUDA device when left
        out, ``"cpu"`` for the CPU.
    """
    device = resolve_device(device)
    mesh = StructuredMesh(cells=tuple(int(c) for c in cells), element=element)
    _, V = create_function_spaces(mesh, device=device)
    W = mixed_space(V)
    grids = tuple(
        torch.tensor(np.asarray(g, dtype=np.float64), dtype=default_dtype(), device=device)
        for g in (g1, g2)
    )
    for g in grids:
        if tuple(g.shape) != mesh.node_shape:
            raise ValueError(f"boundary grid of shape {tuple(g.shape)}, mesh nodes {mesh.node_shape}")
    return DPPState(DPPParameters(**dict(params)), mesh, W, grids)
