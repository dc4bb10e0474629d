from perphil_tpu_torch.utils.manufactured_solutions import (
    exact_expressions,
    exact_expressions_3d,
)
from perphil_tpu_torch.utils.postprocessing import h1_seminorm_error, l2_error

__all__ = [
    "exact_expressions",
    "exact_expressions_3d",
    "l2_error",
    "h1_seminorm_error",
]
