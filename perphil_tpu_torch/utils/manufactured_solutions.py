"""Manufactured (exact) solutions for the DPP model, 2D and 3D.

Counterpart of ``perphil_tpu/utils/manufactured_solutions.py``
(``exact_expressions``, ``exact_expressions_3d``, ``interpolate_exact``). Each
expression is a plain callable of coordinate tensors built from torch ops:
evaluable at vertices (Dirichlet data) or quadrature points, and
differentiable with ``torch.func.grad`` for H1-seminorm errors.

    p1 = (mu/pi) e^{pi x} sin(pi y) - (mu/(beta k1)) e^{eta y}
    p2 = (mu/pi) e^{pi x} sin(pi y) + (mu/(beta k2)) e^{eta y}

with eta = sqrt(beta (k1+k2)/(k1 k2)) and velocities u_i = -(k_i/mu) grad p_i.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from perphil_tpu_torch.forms.spaces import Function, FunctionSpace
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters

PI = math.pi

ScalarExpr = Callable[..., torch.Tensor]
VectorExpr = Callable[..., Tuple[torch.Tensor, ...]]


def exact_expressions(
    mesh: StructuredMesh, dpp_params: DPPParameters
) -> Tuple[VectorExpr, ScalarExpr, VectorExpr, ScalarExpr]:
    """2D exact (u1, p1, u2, p2) callables."""
    k1, k2 = dpp_params.k1, dpp_params.k2
    beta, mu = dpp_params.beta, dpp_params.mu
    eta = dpp_params.eta

    def p1(x, y):
        return (mu / PI) * torch.exp(PI * x) * torch.sin(PI * y) - (mu / (beta * k1)) * torch.exp(eta * y)

    def p2(x, y):
        return (mu / PI) * torch.exp(PI * x) * torch.sin(PI * y) + (mu / (beta * k2)) * torch.exp(eta * y)

    def u1(x, y):
        e = torch.exp(PI * x)
        return (
            -k1 * (e * torch.sin(PI * y)),
            -k1 * (e * torch.cos(PI * y) - (eta / (beta * k1)) * torch.exp(eta * y)),
        )

    def u2(x, y):
        e = torch.exp(PI * x)
        return (
            -k2 * (e * torch.sin(PI * y)),
            -k2 * (e * torch.cos(PI * y) + (eta / (beta * k2)) * torch.exp(eta * y)),
        )

    return u1, p1, u2, p2


def exact_expressions_3d(
    mesh: StructuredMesh, dpp_params: DPPParameters
) -> Tuple[VectorExpr, ScalarExpr, VectorExpr, ScalarExpr]:
    """3D exact (u1, p1, u2, p2) callables:
    p_i = (mu/pi) e^{pi x}(sin(pi y) + sin(pi z)) -/+ (mu/(beta k_i))(e^{eta y} + e^{eta z})."""
    k1, k2 = dpp_params.k1, dpp_params.k2
    beta, mu = dpp_params.beta, dpp_params.mu
    eta = dpp_params.eta

    def p1(x, y, z):
        s = torch.sin(PI * y) + torch.sin(PI * z)
        return (mu / PI) * torch.exp(PI * x) * s - (mu / (beta * k1)) * (
            torch.exp(eta * y) + torch.exp(eta * z)
        )

    def p2(x, y, z):
        s = torch.sin(PI * y) + torch.sin(PI * z)
        return (mu / PI) * torch.exp(PI * x) * s + (mu / (beta * k2)) * (
            torch.exp(eta * y) + torch.exp(eta * z)
        )

    def _vel(sign, k):
        def u(x, y, z):
            e = torch.exp(PI * x)
            s = torch.sin(PI * y) + torch.sin(PI * z)
            dpx = mu * e * s
            dpy = mu * e * torch.cos(PI * y) + sign * (mu * eta / (beta * k)) * torch.exp(eta * y)
            dpz = mu * e * torch.cos(PI * z) + sign * (mu * eta / (beta * k)) * torch.exp(eta * z)
            return (-(k / mu) * dpx, -(k / mu) * dpy, -(k / mu) * dpz)

        return u

    return _vel(-1.0, k1), p1, _vel(1.0, k2), p2


def interpolate_exact(
    mesh: StructuredMesh,
    velocity_space: FunctionSpace,
    pressure_space: FunctionSpace,
    dpp_params: DPPParameters,
) -> Tuple[Function, Function, Function, Function]:
    """The 2D exact (u1, p1, u2, p2) interpolated into Functions on the
    spaces (and their device)."""
    u1_e, p1_e, u2_e, p2_e = exact_expressions(mesh, dpp_params)
    u1 = Function(velocity_space, name="u1_exact").interpolate(u1_e)
    p1 = Function(pressure_space, name="p1_exact").interpolate(p1_e)
    u2 = Function(velocity_space, name="u2_exact").interpolate(u2_e)
    p2 = Function(pressure_space, name="p2_exact").interpolate(p2_e)
    return u1, p1, u2, p2
