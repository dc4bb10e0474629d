"""Double porosity/permeability model parameters.

Counterpart of ``perphil_tpu/models/dpp/parameters.py``: fields ``k1, k2,
beta, mu, scale_contrast``, with ``k2`` defaulting to ``k1 / scale_contrast``
and the derived contrast ``eta = sqrt(beta (k1 + k2) / (k1 k2))``. Plain
floats, folded into the stencil weights and kernel parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class DPPParameters:
    """Container for DPP model constants.

    :param k1: macro-scale permeability (default 1.0).
    :param k2: micro-scale permeability; ``None`` -> ``k1 / scale_contrast``.
    :param beta: mass-transfer coefficient (default 1.0).
    :param mu: fluid viscosity (default 1.0).
    :param scale_contrast: permeability contrast used for the ``k2`` default.
    """

    k1: float = 1.0
    k2: Optional[float] = None
    beta: float = 1.0
    mu: float = 1.0
    scale_contrast: float = 1e2

    def __post_init__(self):
        object.__setattr__(self, "k1", float(self.k1))
        if self.k2 is None:
            object.__setattr__(self, "k2", self.k1 / self.scale_contrast)
        else:
            object.__setattr__(self, "k2", float(self.k2))
        object.__setattr__(self, "beta", float(self.beta))
        object.__setattr__(self, "mu", float(self.mu))

    @property
    def eta(self) -> float:
        """eta = sqrt(beta * (k1 + k2) / (k1 * k2))."""
        return math.sqrt(self.beta * (self.k1 + self.k2) / (self.k1 * self.k2))
