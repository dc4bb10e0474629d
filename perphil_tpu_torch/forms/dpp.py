"""DPP variational forms, lowered to stencil operators.

Counterpart of ``perphil_tpu/forms/dpp.py`` (the reference's
``perphil/forms/dpp.py``): a "form" is a small descriptor that already
knows its stencil lowering, and the solvers take the descriptors directly.

  - :func:`dpp_form`: the monolithic two-field bilinear form and the zero
    linear form;
  - :func:`dpp_delayed_form`: the Picard / fixed-stress split into two scalar
    problems with the cross pressure lagged onto the right-hand side;
  - :func:`dpp_splitted_form`: the nonlinear residual form for the Picard
    solves.

The weak forms, with ``xi = -(beta/mu) (p1 - p2)``:

    macro: (k1/mu) grad p1 . grad q1 dx - xi q1 dx
    micro: (k2/mu) grad p2 . grad q2 dx + xi q2 dx

The operators are imported where a descriptor lowers (``ops/assembly.py``
imports this package's spaces).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from perphil_tpu_torch.forms.spaces import Function, FunctionSpace, MixedFunctionSpace
from perphil_tpu_torch.models.dpp.parameters import DPPParameters


def _validate_mixed(W) -> None:
    if not hasattr(W, "num_sub_spaces") or W.num_sub_spaces() != 2:
        raise ValueError(f"Expected a 2-field MixedFunctionSpace, got {type(W)}")


@dataclass(frozen=True)
class DPPBilinearForm:
    """Monolithic two-field DPP bilinear form (descriptor)."""

    W: MixedFunctionSpace
    params: DPPParameters

    def operator(self):
        """Lower to the BC-eliminated stencil operator (``DPPOperator``)."""
        from perphil_tpu_torch.ops.assembly import DPPOperator

        return DPPOperator(self.W, self.params)


@dataclass(frozen=True)
class ZeroLinearForm:
    """The reference's zero forcing ``L = 0 * q * dx``."""

    W: object


@dataclass(frozen=True)
class FieldBilinearForm:
    """One scalar block ``(k/mu) grad p . grad q + (beta/mu) p q``."""

    V: FunctionSpace
    k: float
    beta: float
    mu: float

    def operator(self):
        """Lower to the BC-eliminated block (``FieldOperator``)."""
        from perphil_tpu_torch.ops.assembly import FieldOperator

        return FieldOperator(self.V, self.k, self.beta, self.mu)


@dataclass(frozen=True)
class FieldLinearForm:
    """The delayed form's lagged coupling right-hand side ``(beta/mu) M
    p_other`` (the ``rhs`` part of the reference's split)."""

    V: FunctionSpace
    beta: float
    mu: float
    lagged: Function

    def assemble(self) -> torch.Tensor:
        """The field mass apply of the lagged pressure (exact on interior
        rows; callers discard the boundary rows)."""
        from perphil_tpu_torch.ops.assembly import FieldOperator

        return FieldOperator(self.V, 0.0, self.beta, self.mu).mass_apply(self.lagged.data)


def dpp_form(
    W: MixedFunctionSpace, model_params: DPPParameters
) -> Tuple[DPPBilinearForm, ZeroLinearForm]:
    """Monolithic DPP bilinear and (zero) linear form of a 2-field space."""
    _validate_mixed(W)
    return DPPBilinearForm(W, model_params), ZeroLinearForm(W)


def dpp_delayed_form(
    macro_function_space: FunctionSpace,
    micro_function_space: FunctionSpace,
    model_params: DPPParameters,
    macro_pressure_initial_values: Function,
    micro_pressure_initial_values: Function,
) -> Tuple[Tuple[FieldBilinearForm, FieldLinearForm], Tuple[FieldBilinearForm, FieldLinearForm]]:
    """Picard-split forms with lagged cross pressures: the trial-side mass
    term stays in each bilinear form, the lagged coupling moves to the
    right-hand side."""
    p = model_params
    a_macro = FieldBilinearForm(macro_function_space, p.k1, p.beta, p.mu)
    L_macro = FieldLinearForm(macro_function_space, p.beta, p.mu, micro_pressure_initial_values)
    a_micro = FieldBilinearForm(micro_function_space, p.k2, p.beta, p.mu)
    L_micro = FieldLinearForm(micro_function_space, p.beta, p.mu, macro_pressure_initial_values)
    return (a_macro, L_macro), (a_micro, L_micro)


@dataclass(frozen=True)
class DPPResidualForm:
    """Nonlinear residual ``F(p1, p2)`` for the Picard solves."""

    W: MixedFunctionSpace
    params: DPPParameters

    def operator(self):
        """Lower to the BC-eliminated stencil operator (``DPPOperator``)."""
        from perphil_tpu_torch.ops.assembly import DPPOperator

        return DPPOperator(self.W, self.params)

    def __call__(
        self, z1: torch.Tensor, z2: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``F = A z - b`` on the BC-eliminated system (zero where the BCs
        hold)."""
        y1, y2 = self.operator().matvec(z1, z2)
        return y1 - b1, y2 - b2


def dpp_splitted_form(
    W: MixedFunctionSpace, model_params: DPPParameters
) -> Tuple[DPPResidualForm, Function]:
    """The residual form and a zero solution Function on ``W``."""
    _validate_mixed(W)
    return DPPResidualForm(W, model_params), Function(W)
