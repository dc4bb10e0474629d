"""2D h-convergence study of the conforming primal DPP formulation.

Counterpart of ``perphil_tpu/experiments/convergence_2d.py`` (the
reference's ``perphil/experiments/convergence_2d.py``): ``SolverSpec``,
``run_one`` (one row: {N, h, degree, quad, solver, it, res, e1_L2, e2_L2,
e1_H1s, e2_H1s}, the schema of
``notebooks/results-conforming-2d/convergence.csv``), ``_default_solvers``,
``compute_eoc`` (the schema of ``convergence_eoc.csv``) and ``main``, with
the same flags and CSVs and a ``--device`` flag (default: the card).

The published table: ``run_one`` at N = 4..128 for each
``iterative_bench.Approach`` but the Picard one, with
``SolverSpec(approach.value, params_for(approach))``::

    python -m perphil_tpu_torch.experiments.convergence_2d --Ns 4 8 16 32 64 128
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import numpy as np

from perphil_tpu_torch.config import DeviceLike
from perphil_tpu_torch.forms.spaces import Function, MixedFunctionSpace, create_function_spaces, mixed_space
from perphil_tpu_torch.mesh.structured import create_mesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC
from perphil_tpu_torch.solvers.parameters import FIELDSPLIT_LU_PARAMS, LINEAR_SOLVER_PARAMS, PLAIN_GMRES_PARAMS
from perphil_tpu_torch.solvers.solver import solve_dpp
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions
from perphil_tpu_torch.utils.postprocessing import h1_seminorm_error, l2_error


@dataclass(frozen=True)
class SolverSpec:
    name: str
    params: Dict


def _build_bcs(W: MixedFunctionSpace, p1_expr, p2_expr) -> List[DirichletBC]:
    """Dirichlet BCs on the whole boundary from the manufactured pressures."""
    return [DirichletBC(W.sub(0), p1_expr), DirichletBC(W.sub(1), p2_expr)]


def _errors_for_solution(solution: Function, p1_exact, p2_exact) -> Tuple[float, float, float, float]:
    """L2 and H1-seminorm errors of both fields."""
    p1_h, p2_h = solution.split()
    return (
        float(l2_error(p1_h, p1_exact)),
        float(l2_error(p2_h, p2_exact)),
        float(h1_seminorm_error(p1_h, p1_exact)),
        float(h1_seminorm_error(p2_h, p2_exact)),
    )


def run_one(
    N: int, solver: SolverSpec, quad: bool, degree: int, params: DPPParameters, device: DeviceLike = None
) -> dict:
    """One (mesh, solver) row of the study, solved on ``device``."""
    mesh = create_mesh(N, N, quadrilateral=quad)
    _, V = create_function_spaces(mesh, pressure_deg=degree, pressure_family="CG", device=device)
    W = mixed_space(V)
    _, p1_expr, _, p2_expr = exact_expressions(mesh, params)
    sol = solve_dpp(
        W, params, bcs=_build_bcs(W, p1_expr, p2_expr), solver_parameters=solver.params,
        options_prefix=f"dpp_{solver.name}",
    )
    e1_l2, e2_l2, e1_h1s, e2_h1s = _errors_for_solution(sol.solution, p1_expr, p2_expr)
    return {
        "N": N,
        "h": 1.0 / float(N),
        "degree": degree,
        "quad": int(quad),
        "solver": solver.name,
        "it": int(sol.iteration_number),
        "res": float(sol.residual_error),
        "e1_L2": e1_l2,
        "e2_L2": e2_l2,
        "e1_H1s": e1_h1s,
        "e2_H1s": e2_h1s,
    }


def _default_solvers(rtols: Iterable[float]) -> List[SolverSpec]:
    """The direct solve, then plain and fieldsplit GMRES at each rtol."""
    specs: List[SolverSpec] = [SolverSpec("mumps", LINEAR_SOLVER_PARAMS)]
    for rtol in rtols:
        gmres = dict(PLAIN_GMRES_PARAMS)
        gmres["ksp_rtol"] = rtol
        specs.append(SolverSpec(f"gmres_rtol={rtol:g}", gmres))
        fs = dict(FIELDSPLIT_LU_PARAMS)
        fs["ksp_type"] = "gmres"
        fs["ksp_rtol"] = rtol
        fs["ksp_atol"] = 1.0e-12
        specs.append(SolverSpec(f"fs-lu_gmres_rtol={rtol:g}", fs))
    return specs


def compute_eoc(rows: List[dict]) -> List[dict]:
    """Observed convergence slopes per (solver, error column): the least
    squares slope of log(err) against log(h)."""
    out = []
    solvers = sorted({r["solver"] for r in rows})
    for err in ("e1_L2", "e2_L2", "e1_H1s", "e2_H1s"):
        for s in solvers:
            sel = sorted((r["h"], r[err]) for r in rows if r["solver"] == s)
            if len(sel) < 2:
                continue
            h = np.log([x[0] for x in sel])
            e = np.log([x[1] for x in sel])
            out.append({"solver": s, "err": err, "slope": float(np.polyfit(h, e, 1)[0])})
    return out


def write_csv(path: Path, rows: List[dict], fieldnames: List[str]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(rows)
    print(f"Wrote {path}")


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="2D convergence experiment for conforming DPP (two pressures)")
    ap.add_argument("--Ns", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument(
        "--degree", type=int, default=1, choices=[1, 2, 3, 4],
        help="Pressure-space polynomial degree (Qp on quad meshes via ops/tensorfem; "
        "degree 2 on triangles via ops/simplexfem).",
    )
    ap.add_argument("--tri", action="store_true", help="Use triangles instead of quads")
    ap.add_argument("--rtols", type=float, nargs="+", default=[1e-8, 1e-10])
    ap.add_argument("--out", type=Path, default=Path("results/conforming-2d/convergence.csv"))
    ap.add_argument("--eoc-out", type=Path, default=None, help="Optional EOC-slope CSV (convergence_eoc.csv schema)")
    ap.add_argument("--device", default=None, help='where to solve (default: the card; "cpu" for the CPU)')
    args = ap.parse_args(argv)

    params = DPPParameters()
    rows = [
        run_one(N=N, solver=spec, quad=not args.tri, degree=args.degree, params=params, device=args.device)
        for N in args.Ns
        for spec in _default_solvers(args.rtols)
    ]
    write_csv(args.out, rows, list(rows[0].keys()))
    if args.eoc_out:
        write_csv(args.eoc_out, compute_eoc(rows), ["solver", "err", "slope"])


if __name__ == "__main__":
    main()
