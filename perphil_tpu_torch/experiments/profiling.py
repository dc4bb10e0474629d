"""Performance profiling of DPP solves (2D) with PETSc-compatible output.

Counterpart of ``perphil_tpu/experiments/profiling.py`` (the reference's
``experiments/petsc_profiling.py``): the same logical-event vocabulary
(``EVENT_ALIASES``, ``DEFAULT_LOGICAL_EVENTS``), result dataclass and
flattened CSV schema (``PerfResult.to_dict``: the 45 columns of
``petsc_perf_breakdown.csv`` in its order), backend waterfall,
warm-up/repeats protocol and memory metrics, over the port's solvers on
``device`` (default: the card).

Backends (a waterfall; every one is a measurement, no column is estimated):

  - ``events``: KSPSolve / SNESSolve are the solves' wall time, host clock
    after ``torch.cuda.synchronize()``; MatMult and PCApply are probes of
    the operator and the preconditioner the solve uses, timed with CUDA
    events over dependent applications (each rescaled by its norm, so the
    chain neither overflows nor underflows; the rescaling's two small
    kernels are inside the figure, an upper bound at the smallest meshes)
    and scaled by the applications a solve makes. FLOPs are analytic.
  - ``trace``: every component from ``torch.profiler``: each probe and the
    solves run in their own trace, and the column is the sum of the traced
    kernels' durations (CUDA activity, from the trace's kernel events); on
    the CPU, the operators' own CPU time. A trace with no kernel raises.
  - ``stage``: the solve event from the wall clock only (PETSc's log-stage
    analogue).
  - ``wall``: the wall clock only, attributed to KSPSolve.
  - ``auto``: events, then stage, then wall; ``trace`` is asked for by
    name. A backend that fails is printed and the next one runs; the row's
    ``metadata["backend"]`` is the one that measured it.

Every solve runs in one call at every size. The JAX package's relay
workarounds are not ported: the ``lax.scan`` / ``optimization_barrier``
chaining of repeats and probes with its ``CHAIN_BUDGET_S`` and
``CHAIN_TARGET_WINDOW_S``, ``_lifted_jit``, and the switch to the chunked
drivers above 20,000 / 60,000 DoF (a TPU worker faulted on long
executions). The chunked drivers stay as public functions
(:func:`build_chunked_plain_solver`, :func:`build_chunked_ngs_solver`).

Memory: peak and delta RSS (``resource.getrusage``), the card's
``torch.cuda.memory_stats`` (not measured on the CPU: empty columns) and
the analytic operator footprint standing in for PETSc's ``Mat.getInfo``.
The CSV writers use the ``csv`` module: the machines with the card have no
pandas.
"""

from __future__ import annotations

import csv
import json
import math
import resource
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

import perphil_tpu_torch
from perphil_tpu_torch.config import DeviceLike
from perphil_tpu_torch.experiments.iterative_bench import (
    Approach,
    build_mesh,
    build_spaces,
    default_bcs,
    default_model_params,
    params_for,
)
from perphil_tpu_torch.forms.spaces import MixedFunctionSpace
from perphil_tpu_torch.models.dpp.parameters import DPPParameters
from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator, bc_values_per_field
from perphil_tpu_torch.ops.stencil import compile_stencils
from perphil_tpu_torch.solvers.solver import (
    _build_linear_solver,
    _build_nonlinear_solver,
    _flatten_options,
    _freeze,
    _monolithic_pc,
)
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions

# raw/native event names to logical ones (reference EVENT_ALIASES)
EVENT_ALIASES: Dict[str, str] = {
    "KSPSolve": "KSPSolve",
    "SNESSolve": "SNESSolve",
    "SNESFunctionEval": "SNESFunctionEval",
    "SNESJacobianEval": "SNESJacobianEval",
    "PCSetUp": "PCSetUp",
    "PCApply": "PCApply",
    "MatMult": "MatMult",
    "MatAssemblyBegin": "MatAssemblyBegin",
    "MatAssemblyEnd": "MatAssemblyEnd",
    # the package's own spellings
    "krylov_solve": "KSPSolve",
    "pc_apply": "PCApply",
    "pc_setup": "PCSetUp",
    "operator_apply": "MatMult",
    "stencil_compile": "MatAssemblyBegin",
    "rhs_assembly": "MatAssemblyEnd",
}

DEFAULT_LOGICAL_EVENTS: List[str] = [
    "SNESJacobianEval",
    "PCApply",
    "SNESSolve",
    "SNESFunctionEval",
    "PCSetUp",
    "KSPSolve",
    "MatAssemblyEnd",
    "MatAssemblyBegin",
    "MatMult",
]

#: restart-aligned GMRES(30) chunk: 67 cycles, so a chunked solve restarts
#: where the whole one does
KSP_CHUNK = 2010
#: Picard sweeps a chunk: the sweeps are memoryless given the iterate, so
#: any chunk gives the whole solve's iterates
NGS_CHUNK = 500

#: the probes' applications: at most this many, fewer where one application
#: takes longer than a share of ``PROBE_WINDOW_S``
PROBE_REPS = 32
PROBE_WINDOW_S = 0.25


def ensure_logging() -> bool:
    """Check that the timing backend works: the role of the reference's
    ``ensure_petsc_logging``. The events backend needs the card and CUDA
    events; raises (naming CUDA) where either is missing."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the profiling backends time the card with CUDA events")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.ones(8, device="cuda").add_(1.0)
    end.record()
    end.synchronize()
    if not start.elapsed_time(end) >= 0.0:
        raise RuntimeError("CUDA events returned no elapsed time")
    return True


# the reference's name
ensure_petsc_logging = ensure_logging


def _get_rss_kb() -> float:
    """Per-process peak RSS in kB."""
    return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)


def _device_memory_stats(device: torch.device) -> Dict[str, Optional[float]]:
    """The card's allocator statistics (``torch.cuda.memory_stats``); None
    (an empty CSV cell) on the CPU, which has no device memory to read."""
    if device.type != "cuda":
        return {"device_bytes_in_use": None, "device_peak_bytes": None}
    stats = torch.cuda.memory_stats(device)
    return {
        "device_bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "device_peak_bytes": float(stats.get("allocated_bytes.all.peak", 0)),
    }


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def _stencil_nnz(mesh) -> int:
    K_st, M_st = compile_stencils(mesh)
    return int(np.count_nonzero(np.asarray(K_st) + np.asarray(M_st)))


def _matrix_info(mesh, W: MixedFunctionSpace) -> Dict[str, float]:
    """Analytic stand-in for PETSc's ``Mat.getInfo``: nnz and CSR bytes of
    the monolithic matrix the stencil operator represents (never
    materialised on the solve's path)."""
    per_row = _stencil_nnz(mesh)
    n = mesh.num_vertices
    nnz = 2 * n * (2 * per_row)  # 2 fields x (diagonal block + coupling block)
    return {"mat_nz_used": float(nnz), "mat_memory_bytes": float(nnz * 12 + 2 * n * 4)}


def _analytic_flops(mesh, its: int, approach: Approach) -> Dict[str, float]:
    """Analytic FLOP attribution (PETSc's numbers are instrumented
    estimates too)."""
    n = mesh.num_vertices
    per_row = _stencil_nnz(mesh)
    matmult_1 = 2.0 * (2 * n) * (2 * per_row)  # 2 flops per stored entry
    d = mesh.dim
    m = int(np.prod([c - 1 for c in mesh.cells]) ** (1.0 / d)) + 1
    fastdiag_1 = 2 * 2 * d * 2.0 * (m ** (d + 1))  # 2 fields, forward + backward, d products
    flops = {e: 0.0 for e in DEFAULT_LOGICAL_EVENTS}
    flops["MatMult"] = matmult_1 * max(its, 1)
    if approach in (Approach.SS_GMRES, Approach.MONOLITHIC_MUMPS):
        flops["PCApply"] = fastdiag_1 * max(its, 1)
    elif approach in (Approach.GMRES_ILU, Approach.SS_GMRES_ILU):
        # ILU(0)'s L/U sweeps touch the entries of one matvec: the
        # monolithic factor, and SS-GMRES+ILU's two half-size blocks
        flops["PCApply"] = matmult_1 * max(its, 1)
    flops["KSPSolve"] = flops["MatMult"] + flops["PCApply"] + 4.0 * (2 * n) * max(its, 1)
    return flops


@dataclass
class PerfResult:
    """Result of a profiled DPP solve (the reference's ``PerfResult``).

    ``to_dict`` flattens it to the columns of ``petsc_perf_breakdown.csv``
    in that file's order: the scalars and the metadata, ``time_total``,
    ``time_total_repeats``, ``time_*``, ``flops_*`` / ``mflops_*``,
    ``flops_total``, ``mem_*`` and ``measurement_class``. The provenance
    column ``measurement_class``: ``cuda`` (the card), ``host-cpu`` (the
    host engine's C++ kernels: the ordering-parity ILU off the card),
    ``cpu-x64`` (the CPU).
    """

    approach: str
    nx: int
    ny: int
    dofs: int
    num_cells: int
    iterations: Optional[int]
    residual: float
    times: Dict[str, float]
    flops: Dict[str, float]
    metadata: Dict[str, Any]
    memory: Optional[Dict[str, Optional[float]]] = None
    time_total: float = 0.0
    time_total_repeats: float = 0.0
    measurement_class: str = ""

    def to_dict(self) -> Dict[str, Any]:
        base: Dict[str, Any] = {
            "approach": self.approach,
            "nx": self.nx,
            "ny": self.ny,
            "dofs": self.dofs,
            "num_cells": self.num_cells,
            "iterations": self.iterations,
            "residual": self.residual,
            "metadata": dict(self.metadata),
            "time_total": float(self.time_total),
            "time_total_repeats": float(self.time_total_repeats),
        }
        for k, v in self.times.items():
            base[f"time_{k}"] = v
        for k, v in self.flops.items():
            base[f"flops_{k}"] = v
            t = self.times.get(k, 0.0)
            base[f"mflops_{k}"] = (v / t / 1e6) if t > 0.0 else 0.0
        base["flops_total"] = float(sum(self.flops.values()))
        for k, v in (self.memory or {}).items():
            base[f"mem_{k}"] = v
        base["measurement_class"] = self.measurement_class
        return base


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lift_norm(op: DPPOperator, g1: torch.Tensor, g2: torch.Tensor) -> float:
    """``||b - A x0||`` at the BC lift x0, the chunked drivers' reference
    norm for ``rtol``."""
    bdry = op._mask_arrays[0]
    b1, b2 = op.lifted_rhs(g1, g2)
    r1, r2 = op.residual(torch.where(bdry, g1, 0.0), torch.where(bdry, g2, 0.0), b1, b2)
    return math.sqrt(float(torch.vdot(r1.reshape(-1), r1.reshape(-1)) + torch.vdot(r2.reshape(-1), r2.reshape(-1))))


def _chunked(build: Callable, W, params, sp_dict, chunk: int, prefix: str, rtol: float, max_it: int) -> Callable:
    """The chunked drivers' host loop: a solve of at most ``chunk``
    iterations by ``build`` (``_build_linear_solver`` /
    ``_build_nonlinear_solver``), then continuations (``_x0_continuation``)
    from the last iterate with ``atol = max(rtol ||r0||, atol)`` until that
    tolerance or ``{prefix}_max_it``, the last chunk clamped to what is
    left (PETSc stops hard there). ``rtol`` and ``max_it``: the defaults of
    ``{prefix}_rtol`` and ``{prefix}_max_it``."""
    base = dict(sp_dict)
    rtol = float(base.get(f"{prefix}_rtol", rtol))
    atol = float(base.get(f"{prefix}_atol", 1e-50))
    max_total = int(base.get(f"{prefix}_max_it", max_it))
    first = build(W, params, _freeze({**base, f"{prefix}_max_it": min(chunk, max_total)}))
    op = DPPOperator(W, params)

    def step(budget: int) -> Callable:
        return build(W, params, _freeze({**base, f"{prefix}_max_it": budget, "_x0_continuation": True}))

    def solve(g1: torch.Tensor, g2: torch.Tensor):
        tol = max(rtol * _lift_norm(op, g1, g2), atol)
        z1, z2, its, norm = first(g1, g2)
        total = int(its)
        while float(norm) > tol and total < max_total:
            z1, z2, its, norm = step(min(chunk, max_total - total))(g1, g2, z1, z2, tol)
            total += int(its)
        return z1, z2, total, norm

    return solve


def build_chunked_plain_solver(W, params, sp_dict, chunk: int = KSP_CHUNK) -> Callable:
    """One long GMRES solve, ``(g1, g2) -> (z1, z2, its, rnorm)``, as a host
    loop of solves of at most ``chunk`` iterations. A ``chunk`` that is a
    multiple of the restart length restarts where the whole solve does."""
    return _chunked(_build_linear_solver, W, params, sp_dict, chunk, "ksp", 1e-5, 10000)


def build_chunked_ngs_solver(W, params, sp_dict, chunk: int = NGS_CHUNK) -> Callable:
    """The ngs Picard solve, ``(g1, g2) -> (z1, z2, its, fnorm)``, as a host
    loop of solves of at most ``chunk`` sweeps; the sweeps are memoryless
    given the iterate, so the chunked solve's iterates are the whole
    solve's."""
    return _chunked(_build_nonlinear_solver, W, params, sp_dict, chunk, "snes", 1e-8, 50)


class _Trace:
    """``torch.profiler`` around a block; :meth:`device_seconds` is the sum
    of the kernels' durations in its trace (the card: CUDA activity, the
    trace's ``kernel`` events), or on the CPU the operators' own time."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts)

    def __enter__(self) -> "_Trace":
        self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        _synchronize(self.device)
        self.prof.__exit__(*exc)

    def device_seconds(self) -> float:
        if self.device.type == "cuda":
            with tempfile.TemporaryDirectory(prefix="perphil_trace_") as tmp:
                path = Path(tmp) / "trace.json"
                self.prof.export_chrome_trace(str(path))
                events = json.loads(path.read_text()).get("traceEvents", [])
            kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
            if not kernels:
                raise RuntimeError("the trace holds no kernel: CUDA activity tracing (CUPTI) recorded nothing")
            return sum(float(e["dur"]) for e in kernels) * 1e-6
        total = sum(e.self_cpu_time_total for e in self.prof.key_averages())
        if total <= 0:
            raise RuntimeError("the trace holds no operator time")
        return total * 1e-6


def _solve_wall(solver: Callable, g1, g2, repeats: int, device: torch.device):
    """``(wall, out)``: ``repeats`` solves back to back, host clock after a
    synchronise on each side; ``out`` the last solve's result."""
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(max(1, repeats)):
        out = solver(g1, g2)
    _synchronize(device)
    return time.perf_counter() - t0, out


def _time_applied(fn: Callable, x: torch.Tensor, device: torch.device, device_time: bool = False) -> float:
    """Seconds of one application of the linear map ``fn`` (stacked fields
    to stacked fields): dependent applications, each rescaled by its 2-norm,
    timed with CUDA events on the card (host clock on the CPU) or, with
    ``device_time``, summed from a trace. At most :data:`PROBE_REPS`
    applications, fewer where one takes more than a share of
    :data:`PROBE_WINDOW_S` (an inner-Krylov preconditioner at 2D N=256)."""

    def step(v: torch.Tensor) -> torch.Tensor:
        y = fn(v)
        return y / torch.linalg.vector_norm(y)

    _synchronize(device)
    t0 = time.perf_counter()
    v = step(x)  # warm-up
    _synchronize(device)
    one = time.perf_counter() - t0
    reps = max(2, min(PROBE_REPS, int(PROBE_WINDOW_S / max(one, 1e-9))))
    if device_time:
        with _Trace(device) as tr:
            for _ in range(reps):
                v = step(v)
        return tr.device_seconds() / reps
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            v = step(v)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        v = step(v)
    return (time.perf_counter() - t0) / reps


def _pc_probe(op: DPPOperator, approach: Approach, solver: Callable, sp_dict: Dict) -> Optional[Callable]:
    """The preconditioner application the solve uses, standalone: the
    solver's own (``pc_apply``: the ordering-parity ILU's level-scheduled
    apply) or ``_monolithic_pc`` of the options (the fused roles apply the
    same preconditioner inside their kernel); None where there is none."""
    if approach == Approach.PLAIN_GMRES:
        return None
    flat = _flatten_options(sp_dict)
    if str(flat.get("ksp_type", "gmres")) == "preonly":
        return None  # direct solves: the factor's application is the solve
    if str(flat.get("pc_type", "none")) in ("", "none"):
        return None
    if str(flat.get("pc_factor_mat_ordering_type", "natural")) == "rcm":
        return getattr(solver, "pc_apply", None)  # the host engine has no standalone apply
    return _monolithic_pc(op, flat)


def _profile_with_events(
    solver: Callable,
    g1: torch.Tensor,
    g2: torch.Tensor,
    op: DPPOperator,
    approach: Approach,
    logical_events: List[str],
    repeats: int,
    sp_dict: Dict,
    source: str = "events",
):
    """The events / trace backends: ``(times, wall, out)``. The solve's
    event is the wall of ``repeats`` solves (events) or their traced kernel
    time (trace); MatMult and PCApply are the probes' per-application
    times scaled by the applications the solves made. ``out`` is the last
    solve's result."""
    device = op.W.device
    device_time = source == "trace"
    times = {e: 0.0 for e in logical_events}
    if device_time:
        _synchronize(device)
        t0 = time.perf_counter()
        with _Trace(device) as tr:
            for _ in range(max(1, repeats)):
                out = solver(g1, g2)
        wall = time.perf_counter() - t0  # time_total stays the wall clock
        solve_time = tr.device_seconds()
    else:
        wall, out = _solve_wall(solver, g1, g2, repeats, device)
        solve_time = wall
    its = int(out[2])

    solve_event = "SNESSolve" if approach == Approach.PICARD_MUMPS else "KSPSolve"
    times[solve_event] = solve_time
    if approach == Approach.PICARD_MUMPS:
        times["KSPSolve"] = solve_time  # the inner linear work is the solve
        times["SNESFunctionEval"] = 0.0

    # applications a solve: restarted GMRES(30) applies the operator once a
    # Krylov step and once a restart cycle (its initial residual); the
    # direct and Picard solves its + 1
    gmres_like = approach in (Approach.PLAIN_GMRES, Approach.GMRES_ILU, Approach.SS_GMRES, Approach.SS_GMRES_ILU)
    ncyc = max(1, -(-its // 30)) if gmres_like else 1
    napp = (its + ncyc) * max(1, repeats)

    x = torch.stack([g1, g2])
    times["MatMult"] = _time_applied(op.stacked_matvec(), x, device, device_time) * napp
    pc = _pc_probe(op, approach, solver, sp_dict)
    if pc is not None:
        times["PCApply"] = _time_applied(pc, x, device, device_time) * napp
    return times, wall, out


def _measurement_class(solver: Callable, device: torch.device) -> str:
    """The row's provenance: ``host-cpu`` for the host engine's C++
    kernels, ``cuda`` on the card, ``cpu-x64`` on the CPU."""
    if getattr(solver, "engine", None) == "host":
        return "host-cpu"
    return "cuda" if device.type == "cuda" else "cpu-x64"


def _metadata(device: torch.device, backend: str, repeats: int, **extra) -> Dict[str, Any]:
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "perphil_tpu_torch_version": perphil_tpu_torch.__version__,
        "backend": backend,
        "repeats": repeats,
        **extra,
        "device": _device_name(device),
    }


def _measure(
    solver: Callable,
    g1: torch.Tensor,
    g2: torch.Tensor,
    op: DPPOperator,
    approach: Approach,
    logical_events: List[str],
    repeats: int,
    backend: str,
    sp_dict: Dict,
):
    """The backend waterfall (``auto``: events, stage, wall; a named
    backend, then wall): ``(times, wall, out, backend_used)``. A backend
    that raises is printed and the next one runs; the last always is wall,
    so a row never ships without a measured time."""
    device = op.W.device
    backends = [backend] if backend != "auto" else ["events", "stage", "wall"]
    if backends[-1] != "wall":
        backends.append("wall")
    times = {e: 0.0 for e in logical_events}
    for name in backends:
        try:
            if name in ("events", "trace"):
                ev, wall, out = _profile_with_events(
                    solver, g1, g2, op, approach, logical_events, repeats, sp_dict, source=name
                )
                times.update(ev)
            else:
                wall, out = _solve_wall(solver, g1, g2, repeats, device)
                event = "SNESSolve" if name == "stage" and approach == Approach.PICARD_MUMPS else "KSPSolve"
                times[event] = wall
            return times, wall, out, name
        except Exception as exc:
            # fall through to the next backend, never silently
            print(f"[perf] backend {name!r} failed: {type(exc).__name__}: {exc}")
            if name == "wall":
                raise
    raise AssertionError("unreachable: the waterfall ends with wall")


def run_perf_once(
    nx: int,
    ny: int,
    approach: Approach,
    eager: bool = True,
    logical_events: Optional[List[str]] = None,
    force_nonzero_rhs: bool = False,
    bc_values: Optional[List[float]] = None,
    repeats: int = 5,
    backend: str = "auto",  # "auto" | "events" | "trace" | "stage" | "wall"
    use_manufactured: bool = True,
    quadrilateral: bool = True,
    device: DeviceLike = None,
) -> PerfResult:
    """One profiled 2D solve on ``device``: the solver's build (PCSetUp),
    a warm-up solve when ``eager``, the RSS snapshot, the backend
    waterfall, and the iterations and residual of its last solve."""
    mesh = build_mesh(nx, ny, quadrilateral=quadrilateral)
    _, _, W = build_spaces(mesh, device)
    params = default_model_params()
    if use_manufactured:
        _, p1e, _, p2e = exact_expressions(mesh, params)
        bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    elif force_nonzero_rhs:
        v = bc_values or [1.0, 0.0]
        bcs = [DirichletBC(W.sub(0), v[0]), DirichletBC(W.sub(1), v[1])]
    else:
        bcs = default_bcs(W)
    return profile_solve(W, params, bcs, approach, params_for(approach), (nx, ny), eager=eager,
                         logical_events=logical_events, repeats=repeats, backend=backend)


def profile_solve(
    W: MixedFunctionSpace,
    params: DPPParameters,
    bcs: List[DirichletBC],
    approach: Approach,
    sp_dict: Dict,
    size: Tuple[int, int],
    eager: bool = True,
    logical_events: Optional[List[str]] = None,
    repeats: int = 5,
    backend: str = "auto",
    metadata: Optional[Dict[str, Any]] = None,
) -> PerfResult:
    """The measurement the 2D and 3D drivers share: the approach's solve
    (options ``sp_dict``) on ``W`` with ``bcs``; ``size`` is the row's
    ``(nx, ny)``, ``metadata`` what the row's metadata adds. A solver that
    names its engine (the ordering-parity ILU's ``engine``) has it
    recorded."""
    device, mesh = W.device, W.mesh
    logical_events = list(dict.fromkeys((logical_events or []) + DEFAULT_LOGICAL_EVENTS))
    g1, g2 = bc_values_per_field(W, bcs)
    op = DPPOperator(W, params)

    # PCSetUp: the solver's construction (stencils, factorisations,
    # eigendecompositions, the kernels' tables)
    _synchronize(device)
    t0 = time.perf_counter()
    if approach == Approach.PICARD_MUMPS:
        solver = _build_nonlinear_solver(W, params, _freeze(sp_dict))
    else:
        solver = _build_linear_solver(W, params, _freeze(sp_dict))
    _synchronize(device)
    t_setup = time.perf_counter() - t0

    if eager:  # the warm-up: kernel loads and first-use tables
        solver(g1, g2)
        _synchronize(device)
    rss_before_kb = _get_rss_kb()
    times, wall_total, out, backend_used = _measure(
        solver, g1, g2, op, approach, logical_events, repeats, backend, sp_dict
    )
    times["PCSetUp"] = t_setup
    times["MatAssemblyBegin"] = 0.0
    times["MatAssemblyEnd"] = 0.0
    its = int(out[2])

    rss_after_kb = _get_rss_kb()
    memory: Dict[str, Optional[float]] = {
        "rss_peak_kb": rss_after_kb,
        "rss_delta_kb": max(0.0, rss_after_kb - rss_before_kb),
    }
    memory.update(_matrix_info(mesh, W))
    memory.update(_device_memory_stats(device))
    extra = dict(metadata or {})
    if getattr(solver, "engine", None) is not None:
        extra["engine"] = solver.engine
    return PerfResult(
        approach=approach.value,
        nx=size[0],
        ny=size[1],
        dofs=W.dim(),
        num_cells=mesh.num_cells,
        iterations=its,
        residual=float(out[3]),
        times=times,
        flops=_analytic_flops(mesh, its, approach),
        metadata=_metadata(device, backend_used, repeats, **extra),
        memory=memory,
        time_total=wall_total / max(1, repeats),
        time_total_repeats=wall_total,
        measurement_class=_measurement_class(solver, device),
    )


def run_perf_sweep(
    sizes: List[int],
    approaches: Optional[List[Approach]] = None,
    repeats: int = 5,
    backend: str = "auto",
    use_manufactured: bool = True,
    device: DeviceLike = None,
) -> List[Dict[str, Any]]:
    """Sweep mesh sizes x approaches. A row that raises is printed and
    left out, and the sweep goes on (a study keeps its other rows)."""
    approaches = approaches or list(Approach)
    rows: List[Dict[str, Any]] = []
    for n in sizes:
        for ap in approaches:
            try:
                res = run_perf_once(n, n, ap, repeats=repeats, backend=backend,
                                    use_manufactured=use_manufactured, device=device)
            except Exception as exc:
                print(f"[perf] nx={n} {ap.value}: FAILED ({type(exc).__name__}: {exc})")
                continue
            rows.append(res.to_dict())
            print(f"[perf] nx={n} {ap.value}: its={res.iterations} time_total={res.time_total:.4g}s")
    return rows


def _cell(v: Any) -> str:
    """A value as pandas' ``to_csv`` writes it: None and NaN empty, every
    other value its ``str``."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return str(v)


def _write(path: Path, columns: List[str], rows: List[Dict[str, Any]]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([_cell(r.get(c)) for c in columns])


def save_perf_csv(rows: List[Dict[str, Any]], path) -> None:
    """CSV export: one column a key, in the order of first appearance."""
    columns = list(dict.fromkeys(k for r in rows for k in r))
    _write(Path(path), columns, rows)


def splice_perf_csv(rows: List[Dict[str, Any]], path) -> None:
    """Merge ``rows`` into an existing profiling CSV on (approach, nx): the
    measured rows replace their old versions, every other row stays, the
    file keeps its columns (a new row's other keys are dropped, its missing
    ones left empty), sorted by (nx, approach). A file that does not exist
    yet is written as :func:`save_perf_csv` writes it."""
    path = Path(path)
    if not path.exists() or not rows:
        save_perf_csv(rows, path)
        return
    with path.open(newline="") as f:
        reader = csv.DictReader(f)
        columns = list(reader.fieldnames or [])
        old = list(reader)
    keys = {(str(r["approach"]), int(r["nx"])) for r in rows}
    keep = [r for r in old if (str(r["approach"]), int(r["nx"])) not in keys]
    merged = keep + [{c: r.get(c) for c in columns} for r in rows]
    merged.sort(key=lambda r: (int(r["nx"]), str(r["approach"])))
    _write(path, columns, merged)


def save_perf_json(rows: List[Dict[str, Any]], path) -> None:
    """JSON export."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        json.dump(rows, f, indent=2, default=str)
