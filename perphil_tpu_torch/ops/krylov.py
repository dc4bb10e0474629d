"""Krylov solvers: preconditioned conjugate gradients.

Counterpart of ``perphil_tpu/ops/krylov.py::cg`` (GMRES is ROADMAP slice 2).
The loop runs on the host and reads the residual norm back once per
iteration; the operator and preconditioner run on the tensors' device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

Op = Callable[[torch.Tensor], torch.Tensor]


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(u.reshape(-1), v.reshape(-1))


def cg(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-8,
    atol: float = 1.0e-12,
    max_it: int = 10000,
    M_inv: Optional[Op] = None,
) -> Tuple[torch.Tensor, int, float]:
    """Preconditioned conjugate gradients for SPD operators.

    Converges on the unpreconditioned residual 2-norm,
    ``||r|| <= max(rtol ||r0||, atol)``; also stops on a non-finite residual.
    Shape-agnostic (grid or flat tensors). Returns (x, iterations,
    residual_norm).
    """
    P = M_inv or (lambda v: v)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - A(x)
    z = P(r)
    p = z
    rz = _dot(r, z)
    rnorm = math.sqrt(float(_dot(r, r)))
    tol = max(rtol * rnorm, atol)
    its = 0
    while rnorm > tol and its < max_it:
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = P(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm = math.sqrt(float(_dot(r, r)))
        its += 1
        if not math.isfinite(rnorm):
            break
    return x, its, rnorm
