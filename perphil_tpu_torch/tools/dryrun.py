"""Multi-rank dry runs of the sharded solves, and the launcher of rank
worlds (counterpart of the JAX package's ``dryrun_multichip`` /
``dryrun_multihost``).

    python -m perphil_tpu_torch.tools.dryrun multichip [N] [--device cpu|cuda]
    python -m perphil_tpu_torch.tools.dryrun multihost [P] [--device cpu|cuda]

``multichip N`` starts N ranks (processes, gloo on the CPU; NCCL needs a
card a rank) arranged as two mesh axes where N factors, e.g. 8 as (4, 2),
and runs the six paths of the JAX dry run at its sizes (N=7: 8 nodes an
axis): plain GMRES, GMRES + ILU(0), fieldsplit GMRES and the fast-diag
direct solve on hex, the Picard NGS solve on quads, and a degree-2
fieldsplit GMRES on a phantom-padded lattice. For each it asserts the
iteration count of the single-device solve and the fields within the JAX
dry run's tolerances (relative max: plain GMRES 3e-6, ILU 1e-7, direct
1e-8, the others 1e-9), then that the halo matvec equals K1 on the gathered
vector exactly, and prints one line a path. ``multihost P`` starts P
interpreters through ``initialize_from_env``'s environment contract and
solves 2D N=16 fieldsplit GMRES on a (P,) mesh against one process.

:func:`spawn_world` is the launcher the tests and ``experiments/scaling.py``
use: it starts one interpreter a rank with the environment contract
(``PERPHIL_COORDINATOR`` on a port bound to 0), runs a named task of
:data:`TASKS` on every rank and returns every rank's result.
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from perphil_tpu_torch.config import DeviceLike, resolve_device

#: ``name -> fn(args) -> result``: what a spawned rank runs (registered below).
TASKS: Dict[str, Callable] = {}

#: The JAX dry run's tolerances: relative max difference of the fields.
TOLERANCES = {"plain-gmres-3d": 3e-6, "gmres-ilu-3d": 1e-7, "direct-fastdiag-3d": 1e-8}
DEFAULT_TOL = 1e-9


def task(fn: Callable) -> Callable:
    TASKS[fn.__name__] = fn
    return fn


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(
    n_ranks: int, name: str, args: Optional[dict] = None, timeout: float = 600.0, threads: int = 1
) -> List[object]:
    """Run task ``name`` on ``n_ranks`` new interpreters joined into one
    process group; return every rank's result, by rank. A rank that fails
    or a world that outlasts ``timeout`` seconds raises, and every process
    is stopped."""
    args = dict(args or {})
    root = str(Path(__file__).resolve().parents[2])
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(n_ranks):
            env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
            env.update(
                PERPHIL_NUM_PROCESSES=str(n_ranks),
                PERPHIL_PROCESS_ID=str(rank),
                PERPHIL_COORDINATOR=f"127.0.0.1:{port}",
                OMP_NUM_THREADS=str(threads),
                PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""),
            )
            out = os.path.join(tmp, f"rank{rank}.pkl")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "perphil_tpu_torch.tools.dryrun", "_rank", name, json.dumps(args), out],
                env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            raise RuntimeError(f"{n_ranks}-rank world for {name!r} outlasted {timeout} s")
        failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            r = failed[0][0]
            raise RuntimeError(f"rank {r} of {n_ranks} failed ({failed[0][1]}) in {name!r}:\n{logs[r][-4000:]}")
        results = []
        for rank in range(n_ranks):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _rank_main(name: str, args_json: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from perphil_tpu_torch.parallel.distributed import initialize_from_env

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    args = json.loads(args_json)
    initialize_from_env(device=args.get("device"))
    try:
        result = TASKS[name](args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def mesh_axes(n: int) -> List[int]:
    """``n`` ranks as two mesh axes where it factors (8 -> (4, 2)), else one."""
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return [n // a, a] if a > 1 else [n]


def dryrun_size(axes: Sequence[int]) -> int:
    """The JAX dry run's N for a mesh: 8 nodes an axis or twice the axes'
    least common multiple, less one."""
    lcm = int(np.lcm.reduce(list(axes)))
    return max(2 * lcm, 8) - 1


def _rel_max(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def dryrun_cases(axes: Sequence[int], device, N: Optional[int] = None) -> List[tuple]:
    """The six dry-run paths on a mesh of ``axes`` (("z", "y") in 3D,
    ("y", "x") in 2D) at the JAX dry run's sizes: ``(label, W, bcs,
    options, nonlinear, mesh)`` each."""
    from perphil_tpu_torch.forms import create_function_spaces, mixed_space
    from perphil_tpu_torch.forms.spaces import FunctionSpace
    from perphil_tpu_torch.mesh import create_cube_mesh, create_mesh
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops.assembly import DirichletBC
    from perphil_tpu_torch.parallel.sharding import device_mesh
    from perphil_tpu_torch.solvers.parameters import (
        FIELDSPLIT_LU_PARAMS,
        GMRES_ILU_PARAMS,
        GMRES_PARAMS,
        LINEAR_SOLVER_PARAMS,
        PICARD_LU_SOLVER_PARAMS,
        PLAIN_GMRES_PARAMS,
    )
    from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions, exact_expressions_3d

    N = dryrun_size(axes) if N is None else N
    params = DPPParameters()
    W = mixed_space(create_function_spaces(create_cube_mesh(N, N, N, hexahedral=True), device=device)[1])
    _, p1e, _, p2e = exact_expressions_3d(W.mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    dm3 = device_mesh(axes, device=device)
    dm2 = device_mesh(axes, axis_names=("y", "x")[: len(axes)], device=device)
    W2 = mixed_space(create_function_spaces(create_mesh(N, N), device=device)[1])
    _, q1e, _, q2e = exact_expressions(W2.mesh, params)
    bcs2 = [DirichletBC(W2.sub(0), q1e), DirichletBC(W2.sub(1), q2e)]
    # degree 2 on 8 x 8 cells: a 17^2 lattice, phantom-padded to divisibility
    Wq = mixed_space(FunctionSpace(create_mesh(8, 8), degree=2, device=device))
    _, r1e, _, r2e = exact_expressions(Wq.mesh, params)
    bcsq = [DirichletBC(Wq.sub(0), r1e), DirichletBC(Wq.sub(1), r2e)]
    return [
        ("plain-gmres-3d", W, bcs, {**GMRES_PARAMS, **PLAIN_GMRES_PARAMS}, False, dm3),
        ("gmres-ilu-3d", W, bcs, GMRES_ILU_PARAMS, False, dm3),
        ("fieldsplit-gmres-3d", W, bcs, {**GMRES_PARAMS, **FIELDSPLIT_LU_PARAMS}, False, dm3),
        ("direct-fastdiag-3d", W, bcs, LINEAR_SOLVER_PARAMS, False, dm3),
        ("picard-ngs-2d", W2, bcs2, PICARD_LU_SOLVER_PARAMS, True, dm2),
        ("degree2-fieldsplit-2d", Wq, bcsq, {"ksp_type": "gmres", "pc_type": "fieldsplit", "ksp_rtol": 1e-8}, False, dm2),
    ]


def solve_case(case, sharded: bool):
    """One dry-run case, single-device or sharded: its ``Solution``."""
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.parallel.sharding import sharded_solve_dpp, sharded_solve_dpp_nonlinear
    from perphil_tpu_torch.solvers import solve_dpp, solve_dpp_nonlinear

    _, W, bcs, sp, nonlinear, dm = case
    if sharded:
        fn = sharded_solve_dpp_nonlinear if nonlinear else sharded_solve_dpp
        return fn(W, DPPParameters(), bcs, dm, solver_parameters=sp)
    return (solve_dpp_nonlinear if nonlinear else solve_dpp)(W, DPPParameters(), bcs, solver_parameters=sp)


def path_record(case, single, sol, fields: bool = False) -> dict:
    """A path's record: the sharded count and residual beside the
    single-device count, the fields' relative max difference, the tolerance
    (``fields``: and the sharded fields, numpy)."""
    label = case[0]
    diff = max(_rel_max(a.cpu(), b.cpu()) for a, b in zip(sol.solution.data, single.solution.data))
    record = dict(
        label=label, its=sol.iteration_number, single_its=single.iteration_number,
        residual=float(sol.residual_error), rel_diff=diff, tol=TOLERANCES.get(label, DEFAULT_TOL),
    )
    if fields:
        record["fields"] = [d.cpu().numpy() for d in sol.solution.data]
    return record


def run_paths(
    axes: Sequence[int], device, N: Optional[int] = None, halo_reps: int = 3, fields: bool = False
) -> List[dict]:
    """The six dry-run paths on this rank's share of a mesh of ``axes``,
    each beside the single-device solve of the same system, then the halo
    matvec beside K1 on the gathered vector. Returns one record a path (its
    last: the halo)."""
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops.assembly import DPPOperator
    from perphil_tpu_torch.parallel.halo import benchmark_vs_gathered

    cases = dryrun_cases(axes, device, N)
    records = [path_record(c, solve_case(c, False), solve_case(c, True), fields) for c in cases]
    _, W, _, _, _, dm3 = cases[0]
    bench = benchmark_vs_gathered(DPPOperator(W, DPPParameters()), dm3, reps=halo_reps)
    records.append(dict(label="halo", **bench))
    return records


def check_paths(records: List[dict]) -> None:
    """Raise unless every path met its single-device count and tolerance and
    the halo matvec equalled the gathered one."""
    for r in records[:-1]:
        if r["its"] != r["single_its"]:
            raise AssertionError(f"{r['label']}: sharded its={r['its']} != single-device its={r['single_its']}")
        if not np.isfinite(r["residual"]):
            raise AssertionError(f"{r['label']}: residual {r['residual']}")
        if not r["rel_diff"] < r["tol"]:
            raise AssertionError(f"{r['label']}: sharded solution deviates by {r['rel_diff']:.3e} (> {r['tol']:.0e})")
    if records[-1]["max_abs_diff"] != 0.0:
        raise AssertionError(f"halo-vs-gathered diff {records[-1]['max_abs_diff']:.3e}")


def report_lines(records: List[dict], n_ranks: int, axes: Sequence[int], N: int) -> List[str]:
    lines = [
        f"dryrun_multichip[{r['label']}]: its={r['its']} (single-device match), residual={r['residual']:.3e}, "
        f"max rel diff={r['rel_diff']:.2e}"
        for r in records[:-1]
    ]
    lines.append(
        f"dryrun_multichip: {n_ranks} ranks as {list(axes)}, N={N}^3 hex + N={N}^2 quad + degree-2, "
        f"{len(records) - 1} solver paths, all iteration counts == single-device, "
        f"halo-vs-gathered diff={records[-1]['max_abs_diff']:.2e}"
    )
    return lines


@task
def multichip(args: dict) -> List[dict]:
    import torch.distributed as dist

    records = run_paths(args["axes"], args.get("device"), fields=args.get("fields", False))
    if args.get("check", True) and dist.get_rank() == 0:
        check_paths(records)
    return records


@task
def batch(args: dict) -> List[object]:
    """Several tasks in one world, in order: ``args["tasks"]`` holds
    ``[name, args]`` pairs, each run with this world's device."""
    return [TASKS[name]({"device": args.get("device"), **sub}) for name, sub in args["tasks"]]


def dryrun_multichip(n_ranks: int = 8, device: DeviceLike = None, timeout: float = 900.0) -> List[str]:
    """Run the six paths on ``n_ranks`` ranks on ``device`` (None: the card,
    NCCL, a card a rank; "cpu": gloo) and print one line a path."""
    device = str(resolve_device(device))
    axes = mesh_axes(n_ranks)
    records = spawn_world(n_ranks, "multichip", {"axes": axes, "device": device}, timeout=timeout)[0]
    check_paths(records)
    lines = report_lines(records, n_ranks, axes, dryrun_size(axes))
    for ln in lines:
        print(ln, flush=True)
    return lines


def _multihost_problem(device):
    from perphil_tpu_torch.forms import create_function_spaces, mixed_space
    from perphil_tpu_torch.mesh import create_mesh
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops.assembly import DirichletBC
    from perphil_tpu_torch.solvers.parameters import FIELDSPLIT_LU_PARAMS, GMRES_PARAMS
    from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions

    W = mixed_space(create_function_spaces(create_mesh(16, 16), device=device)[1])
    params = DPPParameters()
    _, p1e, _, p2e = exact_expressions(W.mesh, params)
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    return W, params, bcs, {**GMRES_PARAMS, **FIELDSPLIT_LU_PARAMS}


def _summary(sol) -> dict:
    import torch

    z1, z2 = sol.solution.data
    znorm = float(torch.sqrt(torch.sum(z1 * z1) + torch.sum(z2 * z2)))
    return {"its": sol.iteration_number, "rnorm": sol.residual_error, "znorm": znorm}


@task
def multihost(args: dict) -> dict:
    import torch.distributed as dist

    from perphil_tpu_torch.parallel.distributed import global_device_mesh
    from perphil_tpu_torch.parallel.sharding import sharded_solve_dpp

    W, params, bcs, sp = _multihost_problem(args.get("device"))
    dm = global_device_mesh([dist.get_world_size()], axis_names=("y",), device=args.get("device"))
    return _summary(sharded_solve_dpp(W, params, bcs, dm, solver_parameters=sp))


def dryrun_multihost(n_procs: int = 2, device: DeviceLike = None, timeout: float = 600.0) -> dict:
    """``n_procs`` interpreters through the environment contract, against
    the same solve in this process (``device`` as in
    :func:`dryrun_multichip`)."""
    device = str(resolve_device(device))
    from perphil_tpu_torch.solvers import solve_dpp

    result = spawn_world(n_procs, "multihost", {"device": device}, timeout=timeout)[0]
    W, params, bcs, sp = _multihost_problem(device)
    ref = _summary(solve_dpp(W, params, bcs, solver_parameters=sp))
    if result["its"] != ref["its"] or abs(result["znorm"] - ref["znorm"]) > 1e-8 * ref["znorm"]:
        raise AssertionError(f"multihost {result} against one process {ref}")
    print(f"dryrun_multihost: {n_procs} processes, MPRESULT {json.dumps(result)} (one process: its={ref['its']})")
    return result


def _space(element: str, n: int, degree: int, device):
    from perphil_tpu_torch.forms import mixed_space
    from perphil_tpu_torch.forms.spaces import FunctionSpace
    from perphil_tpu_torch.mesh import create_cube_mesh, create_mesh

    if element in ("quad", "triangle"):
        mesh = create_mesh(n, n, quadrilateral=element == "quad")
    else:
        mesh = create_cube_mesh(n, n, n, hexahedral=element == "hex")
    return mixed_space(FunctionSpace(mesh, degree=degree, device=device))


def _manufactured_bcs(W):
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops.assembly import DirichletBC
    from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions, exact_expressions_3d

    exact = exact_expressions_3d if W.mesh.dim == 3 else exact_expressions
    _, p1e, _, p2e = exact(W.mesh, DPPParameters())
    return [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]


@task
def sharded_cases(args: dict) -> List[dict]:
    """Sharded solves of ``args["cases"]`` (each: element, n, degree,
    options, axes, names, nonlinear) on the manufactured solution; per case
    the count, the residual and the fields (numpy), or the error raised
    (its type and message)."""
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.parallel.sharding import device_mesh, sharded_solve_dpp, sharded_solve_dpp_nonlinear

    out = []
    for c in args["cases"]:
        W = _space(c["element"], c["n"], c.get("degree", 1), args.get("device"))
        dm = device_mesh(c["axes"], c.get("names"), device=args.get("device"))
        fn = sharded_solve_dpp_nonlinear if c.get("nonlinear") else sharded_solve_dpp
        try:
            sol = fn(W, DPPParameters(), _manufactured_bcs(W), dm, solver_parameters=c["options"])
        except (NotImplementedError, ValueError) as err:
            out.append(dict(error=type(err).__name__, message=str(err)))
            continue
        out.append(dict(
            its=sol.iteration_number, residual=float(sol.residual_error),
            fields=[d.cpu().numpy() for d in sol.solution.data],
        ))
    return out


@task
def halo_matvecs(args: dict) -> List[dict]:
    """The halo matvec and lift of ``args["cases"]`` (each: element, cells,
    axes, names) on stacked random fields from ``numpy.random.default_rng``
    (seed), gathered: the global results (numpy) and this rank's coords."""
    import torch

    from perphil_tpu_torch.interop import from_numpy_state
    from perphil_tpu_torch.ops.assembly import DPPOperator
    from perphil_tpu_torch.parallel.halo import COLLECTIVES, stacked_halo_apply
    from perphil_tpu_torch.parallel.sharding import device_mesh, mesh_padding

    out = []
    for c in args["cases"]:
        shape = tuple(n + 1 for n in reversed(c["cells"]))
        x = np.random.default_rng(c["seed"]).standard_normal((2,) + shape)
        state = from_numpy_state(c.get("params", {}), tuple(c["cells"]), c["element"], x[0], x[1], device="cpu")
        dm = device_mesh(c["axes"], c.get("names"), device=args.get("device"))
        op = DPPOperator(state.W, state.params, mesh_padding(shape, dm))
        pads = [v for p in reversed(op.padding) for v in (0, p)]
        xp = torch.nn.functional.pad(torch.as_tensor(x), pads)
        xl = dm.block(xp, stacked=True)
        COLLECTIVES.clear()
        y = {mode: dm.gather(stacked_halo_apply(op, dm, mode)(xl), stacked=True).numpy() for mode in ("matvec", "lift")}
        out.append(dict(padding=op.padding, coords=dm.coords, collectives=dict(COLLECTIVES), **y))
    return out


@task
def halo_bench(args: dict) -> dict:
    """``benchmark_vs_gathered`` of the halo matvec on a hex grid of
    ``args["n"]`` cells a side (padded to divisibility) on a (world,) slab
    mesh, and what ``make_global`` / ``replicate_scalar`` give this rank."""
    import torch
    import torch.distributed as dist

    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops.assembly import DPPOperator
    from perphil_tpu_torch.parallel.distributed import make_global, replicate_scalar
    from perphil_tpu_torch.parallel.halo import benchmark_vs_gathered
    from perphil_tpu_torch.parallel.sharding import device_mesh, mesh_padding

    W = _space("hex", args["n"], 1, args.get("device"))
    dm = device_mesh([dist.get_world_size()], ("z",), device=args.get("device"))
    op = DPPOperator(W, DPPParameters(), mesh_padding(W.mesh.node_shape, dm))
    grid = np.arange(np.prod(op.grid_shape), dtype=np.float64).reshape(op.grid_shape)
    return dict(
        bench=benchmark_vs_gathered(op, dm, reps=2),
        block=make_global(grid, dm).cpu().numpy(),
        scalar=replicate_scalar(float(dist.get_rank() + 7), dm),
        coords=dm.coords,
    )


@task
def scaling_world(args: dict):
    from perphil_tpu_torch.experiments.scaling import scaling_world as world

    return world(args)


def main(argv: Optional[List[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "_rank":
        _rank_main(*argv[1:4])
        return
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("multichip", "multihost"))
    parser.add_argument("n", nargs="?", type=int, default=None)
    # the dry run's ranks are CPU processes unless asked (the JAX dry run's
    # are virtual CPU devices): NCCL needs a card a rank
    parser.add_argument("--device", default="cpu", help="cpu (gloo ranks, the default) or cuda (NCCL ranks, a card each)")
    args = parser.parse_args(argv)
    if args.mode == "multichip":
        dryrun_multichip(args.n or 8, args.device)
    else:
        dryrun_multihost(args.n or 2, args.device)


if __name__ == "__main__":
    main()
