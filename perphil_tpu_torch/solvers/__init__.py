from perphil_tpu_torch.solvers.solver import Solution, solve_dpp, solve_dpp_nonlinear
from perphil_tpu_torch.solvers import parameters

__all__ = ["Solution", "solve_dpp", "solve_dpp_nonlinear", "parameters"]
