"""Strong/weak scaling harness over rank meshes.

Counterpart of ``perphil_tpu/experiments/scaling.py``: how the sharded solve
(``parallel/sharding.py``) scales with the number of ranks:

- **strong scaling**: fixed problem size, growing rank count —
  ``efficiency = t_1 / (k * t_k)``;
- **weak scaling**: the problem grown with the rank count so each rank's
  share stays constant (``N_k ~ N_1 * k^(1/dim)``) — ``efficiency = t_1 / t_k``.

Ranks are processes: for each rank count the harness starts a world of that
many interpreters (``tools/dryrun.py::spawn_world``), one slab of the grid
each along its outermost axis, and rank 0 returns the rows. Ranks on the
card run NCCL, one card each; ranks on the CPU run gloo and share the
host's cores, so their speedup and efficiency are left empty
(``measurement_class`` "cpu-gloo-validation") and only the halo, collective
and parity columns mean anything there. CSV schema:
``mode,devices,mesh_axes,N,dofs,approach,iterations,time_s,speedup,efficiency,``
``platform,halo_bytes_per_exchange,matvec_collectives,its_single_device,``
``iteration_parity,measurement_class``.

Usage::

    python -m perphil_tpu_torch.experiments.scaling [--mode strong weak]
        [--devices 1 2 4 8] [--n 64] [--dim 2] [--repeats 3] [--device cpu] [--out CSV]
"""

from __future__ import annotations

import csv
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from perphil_tpu_torch.config import DeviceLike, resolve_device

__all__ = ["ScalingRow", "run_scaling", "save_scaling_csv", "main"]


@dataclass
class ScalingRow:
    mode: str
    devices: int
    mesh_axes: str
    N: int
    dofs: int
    approach: str
    iterations: int
    time_s: float
    # speedup/efficiency: measured on ranks that own a card each; empty for
    # CPU ranks, which time-slice one host's cores
    speedup: Any
    efficiency: Any
    # "gpu" (NCCL ranks on cards) or "cpu" (gloo ranks)
    platform: str = "unknown"
    # bytes an interior rank sends an exchange: one plane each way along
    # every split axis, both fields, native f64
    halo_bytes_per_exchange: int = 0
    # collectives counted in parallel/halo.py: the halo matvec's, and one
    # GMRES iteration's (cp = plane exchanges, ar = all-reduces,
    # ag = all-gathers)
    matvec_collectives: str = ""
    # iteration-count parity with the single-device solve of the system
    its_single_device: int = -1
    iteration_parity: bool = False
    # "cpu-gloo-validation" rows carry no meaningful efficiency;
    # "gpu-nccl": ranks on cards
    measurement_class: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


def _halo_bytes(shape, mesh_shape, bytes_per_elem: int = 8) -> int:
    """Bytes an interior rank sends an exchange: one boundary plane each way
    along every split axis, both fields."""
    total = 0
    for ax, k in enumerate(mesh_shape):
        if k > 1:
            plane = 1
            for a, n in enumerate(shape):
                if a != ax:
                    plane *= int(n)
            total += 2 * plane
    return total * 2 * bytes_per_elem


def _weak_size(base_n: int, k: int, dim: int) -> int:
    """Grow N so cells a rank stay ~constant: N_k = N_1 * k^(1/dim)."""
    return max(1, round(base_n * k ** (1.0 / dim)))


def _count(fn) -> Dict[str, int]:
    from perphil_tpu_torch.parallel.halo import COLLECTIVES

    COLLECTIVES.clear()
    fn()
    return dict(COLLECTIVES)


def _fmt(c: Dict[str, int]) -> str:
    return f"cp={c.get('exchange', 0)};ar={c.get('all_reduce', 0)};ag={c.get('all_gather', 0)}"


def _collectives(W, params, bcs, dmesh, sp_dict, padding) -> str:
    """The halo matvec's collectives, and one GMRES iteration's (a solve
    capped at two iterations less one capped at one)."""
    import torch

    from perphil_tpu_torch.ops.assembly import DPPOperator
    from perphil_tpu_torch.parallel.halo import stacked_halo_matvec
    from perphil_tpu_torch.parallel.sharding import sharded_solve_dpp

    op = DPPOperator(W, params, padding)
    mv = stacked_halo_matvec(op, dmesh)
    x = torch.zeros((2,) + dmesh.local_shape(op.grid_shape), dtype=torch.float64, device=dmesh.device)
    matvec = _count(lambda: mv(x))
    if str(sp_dict.get("ksp_type", "gmres")) != "gmres":
        return "matvec:" + _fmt(matvec)
    one = _count(lambda: sharded_solve_dpp(W, params, bcs, dmesh, {**sp_dict, "ksp_max_it": 1}))
    two = _count(lambda: sharded_solve_dpp(W, params, bcs, dmesh, {**sp_dict, "ksp_max_it": 2}))
    step = {k: two.get(k, 0) - one.get(k, 0) for k in set(one) | set(two)}
    return "matvec:" + _fmt(matvec) + "|iteration:" + _fmt(step)


def _setup(N: int, dim: int, params, device):
    from perphil_tpu_torch.forms.spaces import create_function_spaces, mixed_space
    from perphil_tpu_torch.mesh.structured import create_cube_mesh, create_mesh
    from perphil_tpu_torch.ops.assembly import DirichletBC
    from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions, exact_expressions_3d

    if dim == 3:
        mesh = create_cube_mesh(N, N, N, hexahedral=True)
        exacts = exact_expressions_3d(mesh, params)
    else:
        mesh = create_mesh(N, N)
        exacts = exact_expressions(mesh, params)
    W = mixed_space(create_function_spaces(mesh, device=device)[1])
    _, p1e, _, p2e = exacts
    return W, [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scaling_world(args: dict) -> Optional[List[dict]]:
    """One rank of a world of ``args["k"]`` ranks: every approach and mode,
    timed; rank 0 returns the rows (speedup and efficiency still open)."""
    import torch.distributed as dist

    from perphil_tpu_torch.experiments.iterative_bench import Approach, default_model_params, params_for
    from perphil_tpu_torch.parallel.sharding import device_mesh, mesh_padding, sharded_solve_dpp
    from perphil_tpu_torch.solvers import solve_dpp

    device = resolve_device(args.get("device"))
    k, dim, base_n, repeats = args["k"], args["dim"], args["base_n"], args["repeats"]
    params = default_model_params()
    axis = ("z",) if dim == 3 else ("y",)
    dmesh = device_mesh([k], axis_names=axis, device=device)
    rows = []
    for ap_value in args["approaches"]:
        ap = Approach(ap_value)
        sp_dict = params_for(ap)
        for mode in args["modes"]:
            N = base_n if mode == "strong" else _weak_size(base_n, k, dim)
            W, bcs = _setup(N, dim, params, device)
            single = solve_dpp(W, params, bcs, solver_parameters=sp_dict).iteration_number
            sol = sharded_solve_dpp(W, params, bcs, dmesh, solver_parameters=sp_dict)  # warm
            _sync(device)
            dmesh.barrier()
            t0 = time.perf_counter()
            for _ in range(repeats):
                sol = sharded_solve_dpp(W, params, bcs, dmesh, solver_parameters=sp_dict)
            _sync(device)
            dt = (time.perf_counter() - t0) / repeats
            dof_shape = W.spaces[0].dof_mesh.node_shape
            padding = mesh_padding(dof_shape, dmesh)
            padded = tuple(n + p for n, p in zip(dof_shape, padding))
            collectives = _collectives(W, params, bcs, dmesh, sp_dict, padding if any(padding) else ())
            gpu = device.type == "cuda"
            rows.append(dict(
                mode=mode, devices=k, mesh_axes="x".join(str(s) for s in dmesh.shape), N=N, dofs=W.dim(),
                approach=ap.value, iterations=sol.iteration_number, time_s=dt, speedup="", efficiency="",
                platform="gpu" if gpu else "cpu", halo_bytes_per_exchange=_halo_bytes(padded, dmesh.shape),
                matvec_collectives=collectives, its_single_device=single,
                iteration_parity=sol.iteration_number == single,
                measurement_class="gpu-nccl" if gpu else "cpu-gloo-validation",
            ))
    return rows if dist.get_rank() == 0 else None


def run_scaling(
    modes: Sequence[str] = ("strong", "weak"),
    device_counts: Sequence[int] = (1, 2, 4, 8),
    base_n: int = 64,
    dim: int = 2,
    approaches: Optional[Sequence] = None,
    repeats: int = 3,
    device: DeviceLike = None,
    timeout: float = 1800.0,
) -> List[ScalingRow]:
    """Start a world of ranks for each count in ``device_counts`` on
    ``device`` (None: the card, NCCL, one card a rank; "cpu": gloo) and
    collect the rows; speedup and efficiency against the smallest count,
    on the card only."""
    from perphil_tpu_torch.experiments.iterative_bench import Approach
    from perphil_tpu_torch.tools.dryrun import spawn_world

    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        device_counts = [k for k in device_counts if k <= torch.cuda.device_count()]
    approaches = [Approach(a).value for a in (approaches or [Approach.SS_GMRES, Approach.GMRES_ILU])]
    rows: List[ScalingRow] = []
    for k in device_counts:
        args = dict(k=k, dim=dim, base_n=base_n, repeats=repeats, modes=list(modes),
                    approaches=approaches, device=str(dev))
        for r in spawn_world(k, "scaling_world", args, timeout=timeout)[0]:
            rows.append(ScalingRow(**r))
    for ap in approaches:
        for mode in modes:
            group = [r for r in rows if r.approach == ap and r.mode == mode]
            if not group or dev.type != "cuda":
                continue
            t1 = group[0].time_s
            for r in group:
                speedup = t1 / r.time_s if mode == "strong" else r.devices * t1 / r.time_s
                r.speedup = speedup
                r.efficiency = speedup / r.devices if mode == "strong" else t1 / r.time_s
    for r in rows:
        print(
            f"[scaling] {r.approach} {r.mode} k={r.devices} N={r.N}: its={r.iterations} "
            f"(1-dev {r.its_single_device}) t={r.time_s:.4g}s halo={r.halo_bytes_per_exchange}B "
            f"{r.matvec_collectives}",
            flush=True,
        )
    return rows


def save_scaling_csv(rows: List[ScalingRow], path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(ScalingRow.__dataclass_fields__))
        w.writeheader()
        for r in rows:
            w.writerow(r.to_dict())


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", nargs="+", default=["strong", "weak"])
    parser.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    parser.add_argument("--n", type=int, default=64)
    parser.add_argument("--dim", type=int, default=2, choices=(2, 3))
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", default=None, help="cpu: gloo ranks; default: the card, NCCL")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    rows = run_scaling(
        modes=args.mode, device_counts=args.devices, base_n=args.n, dim=args.dim,
        repeats=args.repeats, device=args.device,
    )
    out = args.out or (
        Path(__file__).resolve().parents[2] / "notebooks" / f"results-conforming-{args.dim}d" / "scaling" / "scaling_torch.csv"
    )
    save_scaling_csv(rows, out)
    print(f"[scaling] wrote {len(rows)} rows to {out}")


if __name__ == "__main__":
    main()
