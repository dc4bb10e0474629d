"""Post-processing: field splitting, Darcy velocity, slices, error norms.

Counterpart of ``perphil_tpu/utils/postprocessing.py``:

  - ``split_dpp_solution``: (p1_h, p2_h) from a mixed solution;
  - ``calculate_darcy_velocity_from_pressure``: the L2 projection of
    ``-k grad(p_h)`` into a vector CG1 space (consistent mass, Jacobi-CG to
    1e-13, on the field's device);
  - ``slice_along_x``: a 2D field sampled along a vertical line;
  - ``l2_error`` and ``h1_seminorm_error``: per-cell Gauss quadrature
    (degree 14 by default, ``utils/quadrature.py``) of ``(u_h - u)^2`` and
    ``|grad(u_h - u)|^2``, with the P2 tables on simplex meshes
    (``cell_quadrature_p2``) and ``ops/tensorfem.py::errornorm_p`` for Qp.
    The exact gradient comes from ``torch.func.vmap(torch.func.grad(...))``.

Quadrature points that share a sub-cell share their node offsets, so each
sub-cell's points are evaluated in one batched pass over the cell grid.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perphil_tpu_torch.forms.spaces import Function, FunctionSpace
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.utils.quadrature import (
    DEFAULT_QUADRATURE_DEGREE,
    QPoint,
    cell_quadrature,
    cell_quadrature_p2,
)


def split_dpp_solution(dpp_solution: Function) -> Tuple[Function, Function]:
    """(p1_h, p2_h) from a two-field mixed solution."""
    W = dpp_solution.function_space()
    if not hasattr(W, "num_sub_spaces") or W.num_sub_spaces() != 2:
        raise ValueError(f"Expected a 2-field MixedFunctionSpace, got {type(W)}")
    p1 = dpp_solution.sub(0)
    p2 = dpp_solution.sub(1)
    p1.name, p2.name = "p1_h", "p2_h"
    return p1, p2


def _cells_grid_shape(mesh: StructuredMesh) -> Tuple[int, ...]:
    return tuple(reversed(mesh.cells))


def _qp_groups(qps: Sequence[QPoint], device: torch.device) -> List[Dict[str, Any]]:
    """Quadrature points grouped by sub-cell: node offsets, lattice stride,
    and tensors of weights (nq,), points (nq, d), basis (nq, nv) and
    gradients (nq, nv, d)."""
    groups: Dict[Tuple, List] = {}
    for qp in qps:
        groups.setdefault(qp.vertex_offsets, []).append(qp)
    f64 = torch.float64
    return [
        dict(
            offsets=offsets,
            stride=qps[0].stride,
            weight=torch.tensor([q.weight for q in qps], dtype=f64, device=device),
            point=torch.tensor([q.point for q in qps], dtype=f64, device=device),
            basis=torch.tensor([q.basis for q in qps], dtype=f64, device=device),
            grad=torch.tensor([q.basis_grad for q in qps], dtype=f64, device=device),
        )
        for offsets, qps in groups.items()
    ]


def _patches(data: torch.Tensor, mesh: StructuredMesh, offsets, stride: int = 1) -> torch.Tensor:
    """(nv, *cells) node values of each sub-cell node over the cell grid;
    ``stride`` lattice steps a grid cell (2 for P2 on the refined lattice)."""
    cshape = _cells_grid_shape(mesh)
    return torch.stack(
        [
            data[tuple(slice(o, o + stride * (c - 1) + 1, stride) for o, c in zip(reversed(off), cshape))]
            for off in offsets
        ]
    )


def _points(mesh: StructuredMesh, point: torch.Tensor) -> List[torch.Tensor]:
    """Physical coordinates (coordinate order) of the group's points in
    every cell, each of shape (nq, *cells)."""
    coords = mesh.coordinates()
    sl = tuple(slice(0, -1) for _ in range(mesh.dim))
    out = []
    for a in range(mesh.dim):
        origin = torch.as_tensor(coords[a][sl], dtype=point.dtype, device=point.device)
        out.append(origin.unsqueeze(0) + point[:, a].reshape((-1,) + (1,) * mesh.dim))
    return out


def _quadrature_for(space: FunctionSpace, quadrature_degree: int) -> Tuple[QPoint, ...]:
    """The quadrature table of the space's degree: the P2 tables for degree-2
    simplex spaces, the degree-1 tables otherwise (Qp spaces take
    ``errornorm_p``)."""
    mesh = space.mesh
    if space.degree == 2 and not mesh.is_tensor_product:
        return cell_quadrature_p2(mesh, quadrature_degree)
    if space.degree > 1:
        raise NotImplementedError(f"error norms for degree-{space.degree} simplex spaces")
    return cell_quadrature(mesh, quadrature_degree)


def l2_error(
    numerical: Function,
    exact_expr: Any,
    quadrature_degree: int = DEFAULT_QUADRATURE_DEGREE,
) -> float:
    """||numerical - exact||_{L2}; ``exact_expr`` is a callable of
    coordinate tensors or a Function on the same space."""
    space = numerical.space
    mesh = space.mesh
    if space.degree > 1 and mesh.is_tensor_product:
        from perphil_tpu_torch.ops.tensorfem import errornorm_p

        return errornorm_p(numerical.data, exact_expr, mesh, space.degree, "l2", quadrature_degree)
    total = torch.zeros((), dtype=torch.float64, device=numerical.data.device)
    for g in _qp_groups(_quadrature_for(space, quadrature_degree), numerical.data.device):
        fe = torch.einsum("qv,v...->q...", g["basis"], _patches(numerical.data, mesh, g["offsets"], g["stride"]))
        if isinstance(exact_expr, Function):
            ex_patches = _patches(exact_expr.data, mesh, g["offsets"], g["stride"])
            ex = torch.einsum("qv,v...->q...", g["basis"], ex_patches)
        else:
            ex = exact_expr(*_points(mesh, g["point"]))
        diff = (fe - ex).reshape(fe.shape[0], -1)
        total = total + torch.sum(g["weight"] * torch.sum(diff * diff, dim=1))
    return math.sqrt(float(total))


def h1_seminorm_error(
    numerical: Function,
    exact_expr: Any,
    quadrature_degree: int = DEFAULT_QUADRATURE_DEGREE,
) -> float:
    """|numerical - exact|_{H1}; the exact gradient of a callable comes from
    ``torch.func.vmap(torch.func.grad(exact_expr))``."""
    space = numerical.space
    mesh = space.mesh
    if space.degree > 1 and mesh.is_tensor_product:
        from perphil_tpu_torch.ops.tensorfem import errornorm_p

        return errornorm_p(numerical.data, exact_expr, mesh, space.degree, "h1s", quadrature_degree)
    d = mesh.dim
    total = torch.zeros((), dtype=torch.float64, device=numerical.data.device)
    grad_fn = None
    if not isinstance(exact_expr, Function):
        grad_fn = torch.func.vmap(torch.func.grad(exact_expr, argnums=tuple(range(d))))
    for g in _qp_groups(_quadrature_for(space, quadrature_degree), numerical.data.device):
        patches = _patches(numerical.data, mesh, g["offsets"], g["stride"])
        fe = [torch.einsum("qv,v...->q...", g["grad"][:, :, a], patches) for a in range(d)]
        if grad_fn is None:
            ex_patches = _patches(exact_expr.data, mesh, g["offsets"], g["stride"])
            ex = [torch.einsum("qv,v...->q...", g["grad"][:, :, a], ex_patches) for a in range(d)]
        else:
            pts = _points(mesh, g["point"])
            ex = [e.reshape(pts[0].shape) for e in grad_fn(*[p.reshape(-1) for p in pts])]
        for a, b in zip(fe, ex):
            diff = (a - b).reshape(a.shape[0], -1)
            total = total + torch.sum(g["weight"] * torch.sum(diff * diff, dim=1))
    return math.sqrt(float(total))


def calculate_darcy_velocity_from_pressure(
    pressure_field: Function,
    conductivity: float,
    velocity_space: Optional[FunctionSpace] = None,
    degree: int = 1,
) -> Function:
    """L2-project ``u = -k grad(p_h)`` of a degree-1 pressure into a CG
    vector space on the field's device: per component, the consistent-mass
    system ``M u_c = r_c`` by Jacobi-preconditioned CG to 1e-13."""
    from perphil_tpu_torch.ops.assembly import FullMassOperator
    from perphil_tpu_torch.ops.krylov import cg

    mesh = pressure_field.space.mesh
    device = pressure_field.data.device
    if velocity_space is None:
        velocity_space = FunctionSpace(mesh, degree=degree, value_shape=(mesh.dim,), device=device)
    d = mesh.dim
    cshape = _cells_grid_shape(mesh)
    # r_v = sum_qp w * (-k dp/dx_c) * phi_v, scattered to the vertices
    rhs = [torch.zeros(mesh.node_shape, dtype=torch.float64, device=device) for _ in range(d)]
    for g in _qp_groups(cell_quadrature(mesh, degree=4), device):
        patches = _patches(pressure_field.data, mesh, g["offsets"])
        for q in range(g["weight"].shape[0]):
            grads = [torch.einsum("v,v...->...", g["grad"][q, :, a], patches) for a in range(d)]
            for v, off in enumerate(g["offsets"]):
                sl = tuple(slice(o, o + c) for o, c in zip(reversed(off), cshape))
                for ax in range(d):
                    rhs[ax][sl] += g["weight"][q] * g["basis"][q, v] * (-conductivity) * grads[ax]
    M = FullMassOperator(mesh, device=device)
    dinv = 1.0 / M.diagonal()
    comps = [
        cg(M.matvec, r, rtol=1e-13, atol=0.0, max_it=200, M_inv=lambda x: dinv * x)[0] for r in rhs
    ]
    return Function(velocity_space, torch.stack(comps, dim=-1))


def slice_along_x(scalar_field: Function, x_value: float) -> Tuple[np.ndarray, np.ndarray]:
    """Sample a 2D scalar field along the vertical line x = ``x_value`` at
    the mesh's vertex heights: (y, values) as host arrays."""
    mesh = scalar_field.space.mesh
    _, Y = mesh.coordinates()
    y_points = np.unique(Y)
    pts = np.stack([np.full_like(y_points, x_value), y_points], axis=1)
    return y_points, scalar_field.at(pts).cpu().numpy()
