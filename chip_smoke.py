#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``perphil_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

  1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions, and switches TF32 off for f32 products (TF32 would stall the
     mixed-precision refinement);
  2. builds the CUDA kernels K1-K5 from ``perphil_tpu_torch/csrc``;
  3. checks each kernel against its plain PyTorch twin on the card, at the
     shapes the main path gives it: K1-K3, then the fused GMRES roles K5
     (2D N=8) and K4 (2D N=64 pc none and jacobi, 3D tet nx=16), which must
     equal their twin in iteration count and within 1e-13 relative;
  4. drives the direct path — ``solve_dpp`` with ``LINEAR_SOLVER_PARAMS`` at
     2D quad N=4 and N=16 (golden errors) and 3D tet nx=4, and with
     ``TPU_DIRECT_PARAMS`` at 3D hex 64^3 and 128^3 (f64 relative residual
     < 1e-10) — with every launch counter reset just before, and fails if a
     kernel of the path did not run;
  5. drives the Krylov path the same way — ``solve_dpp`` with
     ``PLAIN_GMRES_PARAMS`` at 2D quad N=4/8/16/64 and 3D tet nx=4/16, held
     to the published PETSc counts 10/40/292/3307 and 27/750, with
     ``GMRES_JACOBI_PARAMS`` at 2D N=16 (33), and with ``PLAIN_GMRES_PARAMS``
     at 2D N=128 beyond the fused envelope (the host loop with the K1
     matvec, whose rounding differs from the CPU twin's: 11765 +- 2);
  6. times each kernel and its twin, and the 64^3/128^3 solves, with CUDA
     events (medians).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises, so
the exit code is non-zero and no result line is printed. Without a CUDA
device the script exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# reference: notebooks/results-conforming-2d/convergence.csv (MUMPS rows)
GOLDEN = {
    4: (1965.7375371673206, 196572.59548715068, 30018.89318007683),
    16: (154.91204152557083, 15491.16888191997, 9247.8237859725),
}
DIRECT_KERNELS = {
    "fused_dpp_apply": ("perphil_tpu_torch/csrc/dpp_apply.cu", "perphil_tpu/ops/pallas_kernels.py:85"),
    "fused_direct_solve": ("perphil_tpu_torch/csrc/fused_direct.cu", "perphil_tpu/ops/pallas_direct.py:228"),
    "fused_simplicial_direct_solve": (
        "perphil_tpu_torch/csrc/fused_pcg.cu", "perphil_tpu/ops/pallas_direct.py:491",
    ),
}
KRYLOV_KERNELS = {
    "fused_gmres_df": ("perphil_tpu_torch/csrc/fused_gmres.cu", "perphil_tpu/ops/pallas_gmres.py:2368"),
    "fused_gmres_ef64": ("perphil_tpu_torch/csrc/fused_gmres.cu", "perphil_tpu/ops/pallas_gmres.py:2323"),
}
KERNELS = {**DIRECT_KERNELS, **KRYLOV_KERNELS}
# published PETSc counts of plain GMRES(30):
# notebooks/results-conforming-2d/petsc_profiling/petsc_perf_breakdown.csv and
# notebooks/results-conforming-3d/petsc_profiling/petsc_perf_breakdown_3d.csv
KRYLOV_CASES = [  # element, N, preset, count, slack, kernel the route launches
    ("quad", 4, "PLAIN_GMRES_PARAMS", 10, 0, "fused_gmres_ef64"),
    ("quad", 8, "PLAIN_GMRES_PARAMS", 40, 0, "fused_gmres_ef64"),
    ("quad", 16, "PLAIN_GMRES_PARAMS", 292, 0, "fused_gmres_df"),
    ("quad", 64, "PLAIN_GMRES_PARAMS", 3307, 0, "fused_gmres_df"),
    ("tet", 4, "PLAIN_GMRES_PARAMS", 27, 0, "fused_gmres_ef64"),
    ("tet", 16, "PLAIN_GMRES_PARAMS", 750, 0, "fused_gmres_df"),
    ("quad", 16, "GMRES_JACOBI_PARAMS", 33, 0, "fused_gmres_df"),
    ("quad", 128, "PLAIN_GMRES_PARAMS", 11765, 2, "fused_dpp_apply"),
]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def newton_rhs(op, bcs):
    """The solver's Krylov right-hand side: ``b - A x0`` with x0 the BC lift."""
    import torch

    g1, g2 = (bc.grid_values(op.mesh) for bc in bcs)
    b1, b2 = op.lifted_rhs(g1, g2)
    bdry = op._mask_arrays[0]
    x01, x02 = torch.where(bdry, g1, 0.0), torch.where(bdry, g2, 0.0)
    return torch.stack(op.residual(x01, x02, b1, b2)).contiguous()


def time_ms(fn, repeats: int = 10, warmup: int = 2) -> float:
    """Median wall time of ``fn`` on the card (CUDA events), in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def problem(element: str, n: int, device):
    """Manufactured-solution DPP problem on ``device``: (W, params, bcs, exact p1, exact p2)."""
    from perphil_tpu_torch.forms import create_function_spaces, mixed_space
    from perphil_tpu_torch.mesh import create_cube_mesh, create_mesh
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops.assembly import DirichletBC
    from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions, exact_expressions_3d

    if element in ("quad", "triangle"):
        mesh = create_mesh(n, n, quadrilateral=element == "quad")
        _, p1e, _, p2e = exact_expressions(mesh, DPPParameters())
    else:
        mesh = create_cube_mesh(n, n, n, hexahedral=element == "hex")
        _, p1e, _, p2e = exact_expressions_3d(mesh, DPPParameters())
    _, V = create_function_spaces(mesh, device=device)
    W = mixed_space(V)
    params = DPPParameters()
    return W, params, [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)], p1e, p2e


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import perphil_tpu_torch

    check(
        Path(perphil_tpu_torch.__file__).resolve().parent == HERE / "perphil_tpu_torch",
        "perphil_tpu_torch is imported from this checkout",
    )
    from perphil_tpu_torch.ops import _cuda
    from perphil_tpu_torch.ops.assembly import DPPOperator, dpp_stencils
    from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply, fused_dpp_apply_plain
    from perphil_tpu_torch.ops.fused_direct import fused_direct_solve, fused_simplicial_direct_solve
    from perphil_tpu_torch.ops.fused_gmres import FusedGMRESSolver
    from perphil_tpu_torch.solvers import parameters as sp
    from perphil_tpu_torch.solvers import solve_dpp
    from perphil_tpu_torch.solvers.solver import _build_linear_solver, _freeze
    from perphil_tpu_torch.utils.postprocessing import h1_seminorm_error, l2_error

    # -- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.BUILD_INFO
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s, cached={info['cached']})")
    print(f"library: {info['path']}")
    for line in str(info.get("log", "")).splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    # -- 3. kernels against their twins (not counted) ---------------------
    results = {}
    rng = torch.Generator(device="cpu").manual_seed(0)

    def randn(shape, dtype=torch.float64):
        return torch.randn(shape, generator=rng, dtype=torch.float64).to(dev, dtype)

    W64, params, _, _, _ = problem("hex", 64, dev)
    W128, _, _, _, _ = problem("hex", 128, dev)
    k1_cases = [
        ("quad16", problem("quad", 16, dev)[0], torch.float64, 1e-13),
        ("hex64", W64, torch.float64, 1e-13),
        ("hex128", W128, torch.float64, 1e-13),
        ("hex64-f32", W64, torch.float32, 2e-6),
        ("hex128-f32", W128, torch.float32, 2e-6),
    ]
    for tag, W, dtype, tol in k1_cases:
        S = dpp_stencils(W.mesh, params)
        z1, z2 = randn(W.mesh.node_shape, dtype), randn(W.mesh.node_shape, dtype)
        for mode in ("matvec", "lift"):
            y = fused_dpp_apply(z1, z2, *S, mode=mode)
            yp = fused_dpp_apply_plain(z1, z2, *S, mode=mode)
            torch.cuda.synchronize()
            err = max(rel(a, b) for a, b in zip(y, yp))
            print(f"K1 {tag} {mode}: max rel diff vs twin {err:.3e} (bound {tol:g})")
            check(err <= tol, f"K1 {tag} {mode}")
        if tag in ("hex64", "hex128"):
            y = fused_dpp_apply(z1, z2, *S)
            yp = fused_dpp_apply_plain(z1, z2, *S)
            results[f"fused_dpp_apply@{tag}"] = dict(
                max_abs_err=max(float((a - b).abs().max()) for a, b in zip(y, yp)),
                ms=time_ms(lambda: fused_dpp_apply(z1, z2, *S), repeats=50),
                plain_ms=time_ms(lambda: fused_dpp_apply_plain(z1, z2, *S), repeats=50),
                shape=f"{tag} f64 matvec",
            )
    results["fused_dpp_apply"] = results["fused_dpp_apply@hex128"]

    for n in (4, 16):
        W, params, bcs, _, _ = problem("quad", n, dev)
        op = DPPOperator(W, params)
        k2 = fused_direct_solve(op)
        b = torch.stack(op.lifted_rhs(*[bc.grid_values(W.mesh) for bc in bcs])).contiguous()
        x, xp = k2.launch(b), k2.plain(b)
        torch.cuda.synchronize()
        err = rel(x, xp)
        print(f"K2 quad N={n}: max rel diff vs twin {err:.3e} (bound 1e-11)")
        check(err <= 1e-11, f"K2 quad N={n}")
        if n == 16:
            results["fused_direct_solve"] = dict(
                max_abs_err=float((x - xp).abs().max()),
                ms=time_ms(lambda: k2.launch(b)),
                plain_ms=time_ms(lambda: k2.plain(b)),
                shape="quad 16^2",
            )

    W, params, bcs, _, _ = problem("tet", 4, dev)
    op = DPPOperator(W, params)
    k3 = fused_simplicial_direct_solve(op)
    b = torch.stack(op.lifted_rhs(*[bc.grid_values(W.mesh) for bc in bcs])).contiguous()
    (x, its), (xp, its_p) = k3.launch(b), k3.plain(b)
    its = int(its.item())
    err = rel(x, xp)
    print(f"K3 tet nx=4: max rel diff vs twin {err:.3e} (bound 1e-11), iterations {its} vs twin {its_p}")
    check(err <= 1e-11 and abs(its - its_p) <= 2, "K3 tet nx=4")
    results["fused_simplicial_direct_solve"] = dict(
        max_abs_err=float((x - xp).abs().max()),
        ms=time_ms(lambda: k3.launch(b)),
        plain_ms=time_ms(lambda: k3.plain(b)),
        shape="tet 4^3",
    )
    torch.cuda.synchronize()

    # the fused GMRES roles against their twin (on the card), on the
    # solver's own right-hand sides; the twin is timed in its check run
    gmres_kw = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    role_cases = [  # element, N, pc, role, timed kernel repeats
        ("quad", 8, "none", "fused_gmres_ef64", 5), ("quad", 64, "none", "fused_gmres_df", 2),
        ("quad", 64, "jacobi", "fused_gmres_df", 3), ("tet", 16, "none", "fused_gmres_df", 2),
    ]
    for element, n, pc, role, reps in role_cases:
        W, params, bcs, _, _ = problem(element, n, dev)
        op = DPPOperator(W, params)
        r = newton_rhs(op, bcs)
        solver = FusedGMRESSolver(op, pc, role, **gmres_kw)
        got = solver.launch(r)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = solver.plain(r)
        end.record()
        torch.cuda.synchronize()
        abs_err = float((got.x - ref.x).abs().max())
        err = abs_err / float(ref.x.abs().max())
        tag = f"{element} N={n} pc {pc}"
        print(f"{role} {tag}: iterations {got.iterations} vs twin {ref.iterations}, "
              f"max rel diff vs twin {err:.3e} (bound 1e-13), max abs diff {abs_err:.3e}")
        check(got.iterations == ref.iterations and got.converged == ref.converged, f"{role} {tag} count")
        check(err <= 1e-13, f"{role} {tag} vs twin")
        results[f"{role}@{tag}"] = dict(
            max_abs_err=abs_err, ms=time_ms(lambda: solver.launch(r), repeats=reps, warmup=0),
            plain_ms=start.elapsed_time(end), shape=f"{tag}, {got.iterations} iterations",
        )
    results["fused_gmres_ef64"] = results["fused_gmres_ef64@quad N=8 pc none"]
    results["fused_gmres_df"] = results["fused_gmres_df@quad N=64 pc none"]

    # -- 4. the direct path, counted --------------------------------------
    cases = [("quad", 4, "LINEAR_SOLVER_PARAMS"), ("quad", 16, "LINEAR_SOLVER_PARAMS"),
             ("tet", 4, "LINEAR_SOLVER_PARAMS"), ("hex", 64, "TPU_DIRECT_PARAMS"),
             ("hex", 128, "TPU_DIRECT_PARAMS")]
    setups = [problem(e, n, dev) for e, n, _ in cases]
    torch.cuda.synchronize()
    _cuda.KERNEL_LAUNCHES.clear()
    sols, per_case = [], []
    for (W, params, bcs, _, _), (_, _, preset) in zip(setups, cases):
        before = dict(_cuda.KERNEL_LAUNCHES)
        sols.append(solve_dpp(W, params, bcs, solver_parameters=getattr(sp, preset)))
        per_case.append({k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items()
                         if v != before.get(k, 0)})
    torch.cuda.synchronize()
    launches = dict(_cuda.KERNEL_LAUNCHES)
    print(f"direct-path kernel launches, all cases: {launches}")
    for name in DIRECT_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} launched on the direct path")

    for (element, n, preset), (W, params, bcs, p1e, p2e), sol, counts in zip(
        cases, setups, sols, per_case
    ):
        z1, z2 = sol.solution.data
        check(sol.iteration_number == 1 and sol.residual_error == 0.0, "preonly reports 1 / 0.0")
        check(bool(torch.isfinite(z1).all() and torch.isfinite(z2).all()), "finite solution")
        check(z1.device == dev and tuple(z1.shape) == W.mesh.node_shape, "solution on the card")
        # f64 relative residual with the plain operator (no kernel involved)
        S = dpp_stencils(W.mesh, params)
        g1, g2 = (bc.grid_values(W.mesh) for bc in bcs)
        b1, b2 = fused_dpp_apply_plain(g1, g2, *S, mode="lift")
        y1, y2 = fused_dpp_apply_plain(z1, z2, *S, mode="matvec")
        rres = math.sqrt(float(((b1 - y1) ** 2).sum() + ((b2 - y2) ** 2).sum())) / math.sqrt(
            float((b1 ** 2).sum() + (b2 ** 2).sum())
        )
        line = f"solve_dpp {element} N={n} {preset}: launches {counts}, f64 rel residual {rres:.3e}"
        check(rres < 1e-10, f"{element} N={n} residual")
        if n <= 16:
            p1h, p2h = sol.solution.split()
            e = (l2_error(p1h, p1e), l2_error(p2h, p2e), h1_seminorm_error(p1h, p1e))
            line += f", L2 p1 {e[0]!r}, L2 p2 {e[1]!r}, H1 p1 {e[2]!r}"
            if element == "quad":
                worst = max(abs(a - g) / g for a, g in zip(e, GOLDEN[n]))
                line += f" (golden max rel diff {worst:.3e})"
                check(worst < 1e-10, f"golden errors at N={n}")
            # against the same solve on the CPU (plain twins)
            Wc, pc, bcc, _, _ = problem(element, n, "cpu")
            ref = solve_dpp(Wc, pc, bcc, solver_parameters=getattr(sp, preset)).solution.data
            cpu_diff = max(rel(a.cpu(), r) for a, r in zip((z1, z2), ref))
            line += f", vs CPU twin path {cpu_diff:.3e}"
            check(cpu_diff < 1e-10, f"{element} N={n} vs CPU")
        print(line)
    torch.cuda.synchronize()

    # -- 5. the Krylov path, counted --------------------------------------
    ksetups = [problem(e, n, dev) for e, n, *_ in KRYLOV_CASES]
    torch.cuda.synchronize()
    _cuda.KERNEL_LAUNCHES.clear()
    ksols, kcounts, kwall = [], [], []
    for (W, params, bcs, _, _), (_, _, preset, *_) in zip(ksetups, KRYLOV_CASES):
        before = dict(_cuda.KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        ksols.append(solve_dpp(W, params, bcs, solver_parameters=getattr(sp, preset)))
        torch.cuda.synchronize()
        kwall.append(time.perf_counter() - t0)
        kcounts.append({k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items()
                        if v != before.get(k, 0)})
    torch.cuda.synchronize()
    krylov_launches = dict(_cuda.KERNEL_LAUNCHES)
    print(f"Krylov-path kernel launches, all cases: {krylov_launches}")
    for name in KRYLOV_KERNELS:
        check(krylov_launches.get(name, 0) > 0, f"{name} launched on the Krylov path")
    launches.update({name: krylov_launches[name] for name in KRYLOV_KERNELS})

    for (element, n, preset, count, slack, kernel), (W, params, bcs, _, _), sol, counts, wall in zip(
        KRYLOV_CASES, ksetups, ksols, kcounts, kwall
    ):
        z1, z2 = sol.solution.data
        its = sol.iteration_number
        check(counts.get(kernel, 0) > 0, f"{element} N={n} {preset} ran {kernel}")
        check(bool(torch.isfinite(z1).all() and torch.isfinite(z2).all()), "finite solution")
        check(z1.device == dev and tuple(z1.shape) == W.mesh.node_shape, "solution on the card")
        # the true residual against the Newton-step system's initial one
        op = DPPOperator(W, params)
        r0 = float(newton_rhs(op, bcs).norm())
        S = dpp_stencils(W.mesh, params)
        g1, g2 = (bc.grid_values(W.mesh) for bc in bcs)
        b1, b2 = fused_dpp_apply_plain(g1, g2, *S, mode="lift")
        y1, y2 = fused_dpp_apply_plain(z1, z2, *S, mode="matvec")
        rres = math.sqrt(float(((b1 - y1) ** 2).sum() + ((b2 - y2) ** 2).sum())) / r0
        bound = 1e-5 if "JACOBI" in preset else 1e-7  # Jacobi stops on the preconditioned norm
        line = (f"solve_dpp {element} N={n} {preset}: iterations {its} (published {count}"
                f"{f' +-{slack}' if slack else ''}), launches {counts}, wall {wall * 1e3:.2f} ms "
                f"({wall * 1e6 / max(its, 1):.2f} us/iteration), |b - A x| / |r0| {rres:.3e}")
        check(abs(its - count) <= slack, f"{element} N={n} {preset} count")
        check(rres < bound, f"{element} N={n} {preset} residual")
        if n <= 16:
            Wc, pc, bcc, _, _ = problem(element, n, "cpu")
            ref = solve_dpp(Wc, pc, bcc, solver_parameters=getattr(sp, preset))
            cpu_diff = max(rel(a.cpu(), r) for a, r in zip((z1, z2), ref.solution.data))
            line += f", vs CPU twin path {cpu_diff:.3e} ({ref.iteration_number} iterations)"
            # the inputs differ by K1's rounding of the lift; the solve
            # amplifies that in plain GMRES's stagnation tail
            check(ref.iteration_number == its and cpu_diff < 1e-8, f"{element} N={n} {preset} vs CPU")
        print(line)
    torch.cuda.synchronize()

    # -- 6. end-to-end solve times ----------------------------------------
    for (element, n, preset), (W, params, bcs, _, _) in zip(cases, setups):
        if n < 64:
            continue
        solver = _build_linear_solver(W, params, _freeze(getattr(sp, preset)))
        g1, g2 = (bc.grid_values(W.mesh) for bc in bcs)
        ms = time_ms(lambda: solver(g1, g2), repeats=10)
        print(f"hex {n}^3 {preset}: lift + direct solve median {ms:.4f} ms (CUDA events, 10 runs) on {smi}")
    for name, r in results.items():
        if name not in ("fused_dpp_apply", "fused_gmres_df", "fused_gmres_ef64"):
            print(f"{name.split('@')[0]} [{r['shape']}]: kernel {r['ms']:.4f} ms, "
                  f"plain twin {r['plain_ms']:.4f} ms (median, CUDA events) on {smi}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
