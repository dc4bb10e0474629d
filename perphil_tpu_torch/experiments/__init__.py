from perphil_tpu_torch.experiments.iterative_bench import (
    Approach,
    SolveResult,
    estimate_condition_numbers,
    solve_on_mesh,
)

__all__ = ["Approach", "SolveResult", "solve_on_mesh", "estimate_condition_numbers"]
