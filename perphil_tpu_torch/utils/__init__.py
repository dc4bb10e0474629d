from perphil_tpu_torch.utils.manufactured_solutions import (
    exact_expressions,
    exact_expressions_3d,
    interpolate_exact,
)
from perphil_tpu_torch.utils.postprocessing import (
    calculate_darcy_velocity_from_pressure,
    h1_seminorm_error,
    l2_error,
    slice_along_x,
    split_dpp_solution,
)

__all__ = [
    "exact_expressions",
    "exact_expressions_3d",
    "interpolate_exact",
    "l2_error",
    "h1_seminorm_error",
    "split_dpp_solution",
    "calculate_darcy_velocity_from_pressure",
    "slice_along_x",
]
