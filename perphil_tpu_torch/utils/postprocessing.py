"""Error norms of degree-1 solutions.

Counterpart of ``perphil_tpu/utils/postprocessing.py::l2_error`` and
``h1_seminorm_error``: per-cell Gauss quadrature (degree 14 by default,
``utils/quadrature.py``) of ``(u_h - u)^2`` and ``|grad(u_h - u)|^2``. The
exact gradient comes from ``torch.func.vmap(torch.func.grad(...))``.

Quadrature points that share a sub-cell share their vertex offsets, so each
sub-cell's points are evaluated in one batched pass over the cell grid.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from perphil_tpu_torch.forms.spaces import Function
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.utils.quadrature import DEFAULT_QUADRATURE_DEGREE, cell_quadrature


def _cells_grid_shape(mesh: StructuredMesh) -> Tuple[int, ...]:
    return tuple(reversed(mesh.cells))


def _qp_groups(mesh: StructuredMesh, degree: int, device: torch.device) -> List[Dict[str, Any]]:
    """Quadrature points grouped by sub-cell: vertex offsets, and tensors of
    weights (nq,), points (nq, d), basis (nq, nv) and gradients (nq, nv, d)."""
    groups: Dict[Tuple, List] = {}
    for qp in cell_quadrature(mesh, degree):
        groups.setdefault(qp.vertex_offsets, []).append(qp)
    f64 = torch.float64
    return [
        dict(
            offsets=offsets,
            weight=torch.tensor([q.weight for q in qps], dtype=f64, device=device),
            point=torch.tensor([q.point for q in qps], dtype=f64, device=device),
            basis=torch.tensor([q.basis for q in qps], dtype=f64, device=device),
            grad=torch.tensor([q.basis_grad for q in qps], dtype=f64, device=device),
        )
        for offsets, qps in groups.items()
    ]


def _patches(data: torch.Tensor, mesh: StructuredMesh, offsets) -> torch.Tensor:
    """(nv, *cells) node values of each sub-cell vertex over the cell grid."""
    cshape = _cells_grid_shape(mesh)
    return torch.stack(
        [data[tuple(slice(o, o + c) for o, c in zip(reversed(off), cshape))] for off in offsets]
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


def l2_error(
    numerical: Function,
    exact_expr: Any,
    quadrature_degree: int = DEFAULT_QUADRATURE_DEGREE,
) -> float:
    """||numerical - exact||_{L2}; ``exact_expr`` is a callable of
    coordinate tensors or a Function on the same space."""
    mesh = numerical.space.mesh
    total = torch.zeros((), dtype=torch.float64, device=numerical.data.device)
    for g in _qp_groups(mesh, quadrature_degree, numerical.data.device):
        fe = torch.einsum("qv,v...->q...", g["basis"], _patches(numerical.data, mesh, g["offsets"]))
        if isinstance(exact_expr, Function):
            ex = torch.einsum("qv,v...->q...", g["basis"], _patches(exact_expr.data, mesh, g["offsets"]))
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
    mesh = numerical.space.mesh
    d = mesh.dim
    total = torch.zeros((), dtype=torch.float64, device=numerical.data.device)
    grad_fn = None
    if not isinstance(exact_expr, Function):
        grad_fn = torch.func.vmap(torch.func.grad(exact_expr, argnums=tuple(range(d))))
    for g in _qp_groups(mesh, quadrature_degree, numerical.data.device):
        patches = _patches(numerical.data, mesh, g["offsets"])
        fe = [torch.einsum("qv,v...->q...", g["grad"][:, :, a], patches) for a in range(d)]
        if grad_fn is None:
            ex_patches = _patches(exact_expr.data, mesh, g["offsets"])
            ex = [torch.einsum("qv,v...->q...", g["grad"][:, :, a], ex_patches) for a in range(d)]
        else:
            pts = _points(mesh, g["point"])
            ex = [e.reshape(pts[0].shape) for e in grad_fn(*[p.reshape(-1) for p in pts])]
        for a, b in zip(fe, ex):
            diff = (a - b).reshape(a.shape[0], -1)
            total = total + torch.sum(g["weight"] * torch.sum(diff * diff, dim=1))
    return math.sqrt(float(total))
