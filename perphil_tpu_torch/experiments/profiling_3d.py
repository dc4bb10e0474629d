"""3D performance profiling on unit-cube meshes.

Counterpart of ``perphil_tpu/experiments/profiling_3d.py`` (the reference's
``experiments/petsc_profiling_3d.py``): the 2D profiler
(``experiments/profiling.py::profile_solve``) on ``UnitCubeMesh(nx, nx,
nx)``, tetrahedral by default, with the 3D manufactured-solution BCs, and
the rows of ``petsc_perf_breakdown_3d.csv``.

``ordering_parity=True`` runs GMRES + ILU in the reference's numbering
(``pc_factor_mat_ordering_type: rcm``), which lands the published counts
6/8/12/15/17/20/26/29/33 at nx=4..40. Its engine is the port's open option:
the band engine on the card, the host engine on the CPU. The JAX package's
per-size engine policy (``perphil_tpu/experiments/profiling_3d.py:75-83``)
was measured on its TPU and is not ported. Each row's metadata records the
engine that ran (``engine``) and the backend that measured it
(``backend``), which the JAX package's rows did not always (a host engine
row there says ``wall`` where the regeneration code timed events).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from perphil_tpu_torch.config import DeviceLike
from perphil_tpu_torch.experiments.iterative_bench import Approach, default_model_params, params_for
from perphil_tpu_torch.experiments.profiling import (
    PerfResult,
    profile_solve,
    save_perf_csv,
    save_perf_json,
    splice_perf_csv,
)
from perphil_tpu_torch.forms.spaces import create_function_spaces, mixed_space
from perphil_tpu_torch.mesh.structured import create_cube_mesh
from perphil_tpu_torch.ops.assembly import DirichletBC
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions_3d


def run_perf_once_3d(
    nx: int,
    approach: Approach,
    repeats: int = 3,
    backend: str = "auto",
    hexahedral: bool = False,
    use_manufactured: bool = True,
    ordering_parity: bool = False,
    eager: bool = True,
    device: DeviceLike = None,
) -> PerfResult:
    """One profiled 3D solve on ``device``. ``ordering_parity`` affects
    GMRES + ILU only (the fieldsplit outer counts are 4 in any ordering);
    without it the structured envelope ILU, a stronger preconditioner,
    takes fewer iterations (4/7/12/16/25 at tet nx=4/8/16/24/40)."""
    mesh = create_cube_mesh(nx, nx, nx, hexahedral=hexahedral)
    _, V = create_function_spaces(mesh, device=device)
    W = mixed_space(V)
    params = default_model_params()
    if use_manufactured:
        _, p1e, _, p2e = exact_expressions_3d(mesh, params)
        bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    else:
        bcs = [DirichletBC(W.sub(0), 0.0), DirichletBC(W.sub(1), 0.0)]
    sp_dict = params_for(approach)
    parity = ordering_parity and approach == Approach.GMRES_ILU
    if parity:
        sp_dict["pc_factor_mat_ordering_type"] = "rcm"
    return profile_solve(
        W, params, bcs, approach, sp_dict, (nx, nx), eager=eager, repeats=repeats, backend=backend,
        metadata={"dim": 3, "element": mesh.element, "ordering": "rcm-parity" if parity else "natural"},
    )


def run_perf_sweep_3d(
    sizes: List[int],
    approaches: Optional[List[Approach]] = None,
    repeats: int = 3,
    backend: str = "auto",
    hexahedral: bool = False,
    ordering_parity: bool = False,
    device: DeviceLike = None,
) -> List[Dict[str, Any]]:
    """Sweep 3D sizes x approaches; a row that raises is printed and left
    out."""
    approaches = approaches or list(Approach)
    rows: List[Dict[str, Any]] = []
    for n in sizes:
        for ap in approaches:
            try:
                res = run_perf_once_3d(n, ap, repeats=repeats, backend=backend, hexahedral=hexahedral,
                                       ordering_parity=ordering_parity, device=device)
            except Exception as exc:
                print(f"[perf3d] nx={n} {ap.value}: FAILED ({type(exc).__name__}: {exc})")
                continue
            rows.append(res.to_dict())
            print(f"[perf3d] nx={n} {ap.value}: its={res.iterations} time_total={res.time_total:.4g}s")
    return rows


__all__ = [
    "run_perf_once_3d",
    "run_perf_sweep_3d",
    "save_perf_csv",
    "splice_perf_csv",
    "save_perf_json",
]
