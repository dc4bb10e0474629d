"""3D h-convergence study on unit-cube meshes (hex or tet).

Counterpart of ``perphil_tpu/experiments/convergence_3d.py``: the
monolithic DPP on unit-cube meshes (hex 8^3 -> 32^3 by default) with the
``exact_expressions_3d`` BCs, rows in the schema of ``convergence_2d`` (with
``hex`` for ``quad``), the direct solve and fieldsplit-LU GMRES; solves on
``device`` (default: the card).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

from perphil_tpu_torch.config import DeviceLike
from perphil_tpu_torch.experiments.convergence_2d import SolverSpec, compute_eoc, write_csv
from perphil_tpu_torch.forms.spaces import create_function_spaces, mixed_space
from perphil_tpu_torch.mesh.structured import create_cube_mesh
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC
from perphil_tpu_torch.solvers.parameters import FIELDSPLIT_LU_PARAMS, GMRES_PARAMS, LINEAR_SOLVER_PARAMS
from perphil_tpu_torch.solvers.solver import solve_dpp
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions_3d
from perphil_tpu_torch.utils.postprocessing import h1_seminorm_error, l2_error


def run_one_3d(
    N: int, solver: SolverSpec, hexahedral: bool, params: DPPParameters,
    quadrature_degree: int = 10, device: DeviceLike = None,
) -> dict:
    """One (mesh, solver) row on the N^3 cube, solved on ``device``."""
    mesh = create_cube_mesh(N, N, N, hexahedral=hexahedral)
    _, V = create_function_spaces(mesh, device=device)
    W = mixed_space(V)
    _, p1e, _, p2e = exact_expressions_3d(mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    sol = solve_dpp(W, params, bcs=bcs, solver_parameters=solver.params)
    p1h, p2h = sol.solution.split()
    return {
        "N": N,
        "h": 1.0 / N,
        "degree": 1,
        "hex": int(hexahedral),
        "solver": solver.name,
        "it": int(sol.iteration_number),
        "res": float(sol.residual_error),
        "e1_L2": float(l2_error(p1h, p1e, quadrature_degree)),
        "e2_L2": float(l2_error(p2h, p2e, quadrature_degree)),
        "e1_H1s": float(h1_seminorm_error(p1h, p1e, quadrature_degree)),
        "e2_H1s": float(h1_seminorm_error(p2h, p2e, quadrature_degree)),
    }


def default_solvers_3d() -> List[SolverSpec]:
    """The direct solve and fieldsplit-LU GMRES."""
    return [
        SolverSpec("mumps", LINEAR_SOLVER_PARAMS),
        SolverSpec("fs-lu_gmres", {**GMRES_PARAMS, **FIELDSPLIT_LU_PARAMS}),
    ]


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="3D convergence experiment (DPP)")
    ap.add_argument("--Ns", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--tet", action="store_true", help="tetrahedra instead of hexes")
    ap.add_argument("--out", type=Path, default=Path("results/conforming-3d/convergence_3d.csv"))
    ap.add_argument("--eoc-out", type=Path, default=None)
    ap.add_argument("--device", default=None, help='where to solve (default: the card; "cpu" for the CPU)')
    args = ap.parse_args(argv)

    params = DPPParameters()
    rows: List[Dict] = []
    for N in args.Ns:
        for spec in default_solvers_3d():
            row = run_one_3d(N, spec, hexahedral=not args.tet, params=params, device=args.device)
            rows.append(row)
            print(row)
    write_csv(args.out, rows, list(rows[0].keys()))
    if args.eoc_out:
        write_csv(args.eoc_out, compute_eoc(rows), ["solver", "err", "slope"])


if __name__ == "__main__":
    main()
