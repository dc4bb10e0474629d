#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``perphil_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

  1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions, and switches TF32 off for f32 products (TF32 would stall the
     mixed-precision refinement);
  2. builds the CUDA kernels K1-K8, ``structured_ilu_apply``, ``fused_ngs``
     and ``band_trisolve`` from
     ``perphil_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel), and
     checks that each fused GMRES role's static shared memory leaves the
     budget its launches plan with;
  3. checks that a space built with no ``device`` lies on the card, then each
     kernel against its plain PyTorch twin on the card, at the
     shapes the main path gives it: K1 in both modes and precisions and
     both entries (the stacked one bit for bit the pair's), timed with its
     launches queued, beside one ``conv3d``, and the host wall of one
     ``stacked_matvec()`` call at 2D N=128; K2 (quad N=4/16/64, hex nx=16,
     hex nx=32 on a cluster of 8 blocks) and K3 (tri N=8, tet nx=4/12, tet
     nx=32 on 16 blocks), their device time (launches queued)
     apart from their call time, beside an empty kernel's (the floor) and
     one ``torch.linalg.solve`` on the dense system; the fused GMRES roles K5
     (2D N=8), K4 (2D N=16/64/128 pc none, N=64 jacobi, tet nx=16/32/40),
     K7 (2D N=64/128/256), K6 (2D N=64, tet nx=8/32), K8 (2D N=16/64/128), equal
     counts and bits (K6 within 1e-10; the twin bounded to a few steps at
     N=256 ILU and N=128 SS-GMRES+ILU), with the blocks, the leaves a
     thread, what lived in shared memory, the time and the time per
     iteration, and beside the sizes the TPU's gate sent to the host loop,
     that loop's time on the same case; ``structured_ilu_apply`` at 2D N=128
     (monolithic) and on a 129^2 field system, bit-equal;
  4. drives the direct path — ``solve_dpp`` with ``LINEAR_SOLVER_PARAMS`` at
     2D quad N=4 and N=16 (golden errors), 3D tet nx=4, 16 and 32 (the
     last two on K3's cluster placement) and 2D tri N=151 (past K3's gate:
     ``cg`` with K1), and with ``TPU_DIRECT_PARAMS`` at 3D hex 64^3 and
     128^3 (f64 relative residual < 1e-10) — with every launch counter reset
     just before, checks each solve's route by its launches, and fails if a
     kernel of the path did not run;
  5. drives the Krylov path the same way — ``solve_dpp`` with
     ``PLAIN_GMRES_PARAMS`` at 2D quad N=4/8/16/64/128 and 3D tet
     nx=4/12/16/20/24/32/36/40, held to the published PETSc counts
     10/40/292/3307/11765 (+-2) and 27/465/750/1068/1460/2439/3057/3652, and
     with ``GMRES_JACOBI_PARAMS`` at 2D N=16 (33);
  6. drives the preconditioned path the same way — ``GMRES_ILU_PARAMS`` at
     2D N=4..256 (5/7/11/20/42/74/117, K7; +-2 at N=128/256) and tet nx=4/8
     (4/7), SS-GMRES at 2D N=16/64 and tet nx=8/32 (4, K6) and at N=256 (4, the
     host loop), SS-GMRES+ILU at 2D N=16/64/128 (4, K8);
     ``FIELDSPLIT_GMRES_PARAMS`` at N=16 (4); GMRES+ILU at N=512 (no
     published count; the host loop with ``structured_ilu_apply``);
  7. drives the Picard path — first ``fused_ngs`` against its twin at 2D
     N=16/64/128 (equal counts; x, fn and f0 bit for bit) and at N=255 with
     both capped at 100 iterations, its time and µs a phase at N=128, the
     Gauss-Seidel mode of
     the ILU sweep (``structured_ilu_apply[gs]``) against its twin at tri
     N=16 and tet nx=4 (bit for bit), and the host loop against the kernel at
     N=64 and N=128 in turns (host clock); then, counted,
     ``solve_dpp_nonlinear`` with ``PICARD_LU_SOLVER_PARAMS`` at 2D
     N=4/8/16/32/64/128, held to the published 16/63/194/635/1673/5135 with
     ``fn <= max(rtol f0, atol)`` and one ``fused_ngs`` launch a solve, the
     lexicographic ngs at tri N=16 and tet nx=4 (one GS-mode launch an
     iteration), and ``block_gs``, ``RICHARDSON_SOLVER_PARAMS`` and
     ``KSP_PREONLY_PARAMS`` at N=16, each against the CPU twin path;
  8. drives the ordering-parity ILU path (``parity_path``) — first
     ``band_trisolve`` against its twin at tet nx=4/16/24/40 (a lower and an
     upper factor, max abs diff over max abs <= 1e-13), timed with CUDA
     events beside the twin, its bound and, at nx=16/24,
     ``torch.linalg.solve_triangular`` on the dense factor; the whole band
     apply at nx=40 against the sequential factor solves and its build's
     device memory against ``band_plan``; then, counted, ``solve_dpp`` with
     ``GMRES_ILU_PARAMS`` + ``pc_factor_mat_ordering_type: rcm`` on the
     device engine at tet nx=4/8/12/16/20/24/32/36/40, held to the published
     6/8/12/15/17/20/26/29/33 exactly with four ``band_trisolve`` launches an
     apply and no K7 launch, and the host engine at nx=4 and 40 with the
     same counts, timed in turns with the device engine (host clock);
  9. drives the parallel-prefix trisolves (``partri_path``) — the partri
     ILU apply against ``structured_ilu_apply`` on the same factor at 2D
     N=128/256 monolithic, a 2D N=256 field and tet nx=16 monolithic, the
     partri GS sweep against ``structured_ilu_apply[gs]`` at tri N=16 / tet
     nx=4 (max rel diff <= 1e-12), both timed with CUDA events beside the
     maps' bytes and bound and the build's peak memory within
     ``partri_peak``; then, counted, the host GMRES loop with
     ``trisolve_backend=partri`` landing the published 74/117 exactly at 2D
     N=128/256, and the lexicographic Picard at tri N=16 / tet nx=4 with
     ``trisolve_backend=partri``; after the count, the same Picard with the
     option left open (the wavefront on the card) and on the CPU, with equal
     counts;
 10. drives the conditioning analysis (``conditioning_path``) —
     ``estimate_condition_numbers`` with Lanczos on the card at 2D
     N=16/32/64 and hex N=8, the dense host SVD at hex N=4, each against the
     published CSV (1e-8 at N=16/32, 1e-5 at N=64, 1e-10 in 3D), and tet
     nx=4's Lanczos κ (the monolithic inverse through K3, counted) against
     the dense SVD;
 11. times each kernel and its twin, and the 64^3/128^3 solves, with CUDA
     events, and the cached direct solves at 2D N=16 and tet nx=4 (K2, K3)
     with the host clock, and works out each kernel's bound from this run's
     shapes and iteration counts.

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
_CSRC = "perphil_tpu_torch/csrc/"
_GMRES_TPU = "perphil_tpu/ops/pallas_gmres.py"
DIRECT_KERNELS = {
    "fused_dpp_apply": (_CSRC + "dpp_apply.cu", "perphil_tpu/ops/pallas_kernels.py:85"),
    "fused_direct_solve": (_CSRC + "fused_direct.cu", "perphil_tpu/ops/pallas_direct.py:228"),
    "fused_simplicial_direct_solve": (_CSRC + "fused_pcg.cu", "perphil_tpu/ops/pallas_direct.py:491"),
}
KRYLOV_KERNELS = {
    "fused_gmres_df": (_CSRC + "fused_gmres_pc_none.cu", _GMRES_TPU + ":2368"),
    "fused_gmres_ef64": (_CSRC + "fused_gmres_pc_none.cu", _GMRES_TPU + ":2323"),
}
PRECOND_KERNELS = {
    # the pc_type branches of _build_cycle (:1204) that build each role's data
    "fused_gmres_df[fieldsplit_lu]": (_CSRC + "fused_gmres_pc_fieldsplit_lu.cu", _GMRES_TPU + ":1237"),
    "fused_gmres_df[ilu]": (_CSRC + "fused_gmres_pc_ilu.cu", _GMRES_TPU + ":1229"),
    "fused_gmres_df[fieldsplit_ilu]": (_CSRC + "fused_gmres_pc_fieldsplit_ilu.cu", _GMRES_TPU + ":1232"),
    # the apply is XLA in the JAX package, not Pallas
    "structured_ilu_apply": (_CSRC + "ilu_apply.cu", "perphil_tpu/ops/ilu.py:716"),
}
PICARD_KERNELS = {
    # the JAX package's ngs while-loop (XLA, no Pallas) and its GS sweep
    "fused_ngs": (_CSRC + "fused_ngs.cu", "perphil_tpu/solvers/solver.py:1852"),
    "structured_ilu_apply[gs]": (_CSRC + "ilu_apply.cu", "perphil_tpu/ops/ilu.py:840"),
}
PARITY_KERNELS = {
    # the JAX package's band trisolve is a lax.scan of dense matvecs (XLA, no Pallas)
    "band_trisolve": (_CSRC + "band_trisolve.cu", "perphil_tpu/ops/bandsolve.py:164"),
}
KERNELS = {**DIRECT_KERNELS, **KRYLOV_KERNELS, **PRECOND_KERNELS, **PICARD_KERNELS, **PARITY_KERNELS}
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
    ("quad", 128, "PLAIN_GMRES_PARAMS", 11765, 2, "fused_gmres_df"),
    # 3D plain counts: petsc_perf_breakdown_3d.csv
    ("tet", 12, "PLAIN_GMRES_PARAMS", 465, 0, "fused_gmres_df"),
    ("tet", 20, "PLAIN_GMRES_PARAMS", 1068, 0, "fused_gmres_df"),
    ("tet", 24, "PLAIN_GMRES_PARAMS", 1460, 0, "fused_gmres_df"),
    ("tet", 32, "PLAIN_GMRES_PARAMS", 2439, 0, "fused_gmres_df"),
    ("tet", 36, "PLAIN_GMRES_PARAMS", 3057, 0, "fused_gmres_df"),
    ("tet", 40, "PLAIN_GMRES_PARAMS", 3652, 0, "fused_gmres_df"),
]
# the preconditioned presets: 2D counts from petsc_perf_breakdown.csv
# ("GMRES + ILU PC", "Scale-Splitting GMRES [+ ILU PC]"); the 3D ILU counts
# are the natural-order structured ILU's (the published 3D row is the RCM
# ordering-parity ILU's); FIELDSPLIT_GMRES_PARAMS at N=16: the JAX package's
# count. The +-2 at 2D N=128/256 is the published counts' slack against the
# route that serves them (the fused roles since the envelope is the card's).
PRECOND_CASES = [  # element, N, preset, count, slack, kernel the route launches
    ("quad", 4, "GMRES_ILU_PARAMS", 5, 0, "fused_gmres_df[ilu]"),
    ("quad", 8, "GMRES_ILU_PARAMS", 7, 0, "fused_gmres_df[ilu]"),
    ("quad", 16, "GMRES_ILU_PARAMS", 11, 0, "fused_gmres_df[ilu]"),
    ("quad", 32, "GMRES_ILU_PARAMS", 20, 0, "fused_gmres_df[ilu]"),
    ("quad", 64, "GMRES_ILU_PARAMS", 42, 0, "fused_gmres_df[ilu]"),
    ("tet", 4, "GMRES_ILU_PARAMS", 4, 0, "fused_gmres_df[ilu]"),
    ("tet", 8, "GMRES_ILU_PARAMS", 7, 0, "fused_gmres_df[ilu]"),
    ("quad", 16, "SS-GMRES", 4, 0, "fused_gmres_df[fieldsplit_lu]"),
    ("quad", 64, "SS-GMRES", 4, 0, "fused_gmres_df[fieldsplit_lu]"),
    ("tet", 8, "SS-GMRES", 4, 0, "fused_gmres_df[fieldsplit_lu]"),
    ("tet", 32, "SS-GMRES", 4, 0, "fused_gmres_df[fieldsplit_lu]"),
    ("quad", 16, "SS-GMRES+ILU", 4, 0, "fused_gmres_df[fieldsplit_ilu]"),
    ("quad", 64, "SS-GMRES+ILU", 4, 0, "fused_gmres_df[fieldsplit_ilu]"),
    ("quad", 128, "GMRES_ILU_PARAMS", 74, 2, "fused_gmres_df[ilu]"),
    ("quad", 256, "GMRES_ILU_PARAMS", 117, 2, "fused_gmres_df[ilu]"),
    # K6's slices and line buffers at N=256 exceed the launch budget: the host loop
    ("quad", 256, "SS-GMRES", 4, 0, "fused_dpp_apply"),
    ("quad", 128, "SS-GMRES+ILU", 4, 0, "fused_gmres_df[fieldsplit_ilu]"),
    ("quad", 16, "FIELDSPLIT_GMRES_PARAMS", 4, 0, "fused_dpp_apply"),
    # beyond the envelope (526,338 values), no published count: the host loop
    # with the standalone ILU apply
    ("quad", 512, "GMRES_ILU_PARAMS", None, 0, "structured_ilu_apply"),
]

# the reference's Picard column: petsc_perf_breakdown-with-picard.csv,
# "Scaling-Splitting Picard with MUMPS"
PICARD_COUNTS = {4: 16, 8: 63, 16: 194, 32: 635, 64: 1673, 128: 5135}
# fused_ngs at 2D N=255 (the plan's last size with 255 cells a side; no
# published count), held to its twin with both capped at this many iterations
NGS_CAP_255 = 100
PICARD_CASES = [  # element, N, preset, count (None: the CPU twin path's), kernel the route launches
    *[("quad", n, "PICARD_LU_SOLVER_PARAMS", c, "fused_ngs") for n, c in PICARD_COUNTS.items()],
    ("triangle", 16, "PICARD_LU_SOLVER_PARAMS", None, "structured_ilu_apply[gs]"),
    ("tet", 4, "PICARD_LU_SOLVER_PARAMS", None, "structured_ilu_apply[gs]"),
    ("quad", 16, "BLOCK_GS", None, "fused_dpp_apply"),
    ("quad", 16, "RICHARDSON_SOLVER_PARAMS", None, "fused_dpp_apply"),
    ("quad", 16, "KSP_PREONLY_PARAMS", 1, "fused_gmres_df[fieldsplit_lu]"),
]

# the ordering-parity ILU's column (pc_factor_mat_ordering_type=rcm, "GMRES +
# ILU PC", ordering rcm-parity): petsc_perf_breakdown_3d.csv, tet nx=4..40
PARITY_COUNTS = {4: 6, 8: 8, 12: 12, 16: 15, 20: 17, 24: 20, 32: 26, 36: 29, 40: 33}
PARITY_HOST_SIZES = (4, 40)  # the host engine, in turns with the device engine
PARITY_KERNEL_SIZES = (4, 16, 24, 40)  # band_trisolve against its twin
PARITY_LIBRARY_SIZES = (16, 24)  # torch.linalg.solve_triangular on the dense factor
PARITY_TABLE_SIZE = 24  # the kernel line's shape: the largest with a library time

# NVIDIA's H100 SXM data sheet: HBM3 bandwidth, FP64 and FP32 outside the
# tensor cores (the kernels use none)
HBM_BYTES_PER_S = 3.35e12
FP64_PER_S = 34e12
FP32_PER_S = 67e12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def presets():
    from perphil_tpu_torch.solvers import parameters as sp

    return {
        "PLAIN_GMRES_PARAMS": sp.PLAIN_GMRES_PARAMS,
        "GMRES_JACOBI_PARAMS": sp.GMRES_JACOBI_PARAMS,
        "GMRES_ILU_PARAMS": sp.GMRES_ILU_PARAMS,
        "SS-GMRES": {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS},
        "SS-GMRES+ILU": {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_ILU_PARAMS},
        "FIELDSPLIT_GMRES_PARAMS": {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_PARAMS},
        "LINEAR_SOLVER_PARAMS": sp.LINEAR_SOLVER_PARAMS,
        "TPU_DIRECT_PARAMS": sp.TPU_DIRECT_PARAMS,
        "PICARD_LU_SOLVER_PARAMS": sp.PICARD_LU_SOLVER_PARAMS,
        "BLOCK_GS": {**sp.PICARD_LU_SOLVER_PARAMS, "snes_type": "block_gs"},
        "RICHARDSON_SOLVER_PARAMS": sp.RICHARDSON_SOLVER_PARAMS,
        "KSP_PREONLY_PARAMS": sp.KSP_PREONLY_PARAMS,
        "GMRES_ILU_RCM": {**sp.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm"},
        "GMRES_ILU_RCM_HOST": {**sp.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm",
                               "pc_band_execution": "host"},
        # the host routes' ILU and GS on the parallel-prefix trisolves (left open: the wavefront on the card)
        "GMRES_ILU_PARTRI": {**sp.GMRES_ILU_PARAMS, "trisolve_backend": "partri"},
        "PICARD_LU_PARTRI": {**sp.PICARD_LU_SOLVER_PARAMS, "trisolve_backend": "partri"},
    }


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


def queued_ms(fn, calls: int = 100, repeats: int = 3) -> float:
    """Device time of one ``fn()`` in ms (CUDA events, median of
    ``repeats``): ``calls`` calls back to back, queued behind a sleep on the
    stream, so that the host's time to launch them stays out of the window
    (checked: the sleep outlasts the launching)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clocks
        events[1].record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        events[2].record()
        torch.cuda.synchronize()
        check(events[0].elapsed_time(events[1]) > host_ms, "the sleep outlasts the launches it hides")
        times.append(events[1].elapsed_time(events[2]) / calls)
    return statistics.median(times)


def timed_once(fn):
    """``fn()`` once, and its time on the card (CUDA events), in ms."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    # the card is the port's default device: only the CPU is asked for by name
    _, V = create_function_spaces(mesh, device=device) if device == "cpu" else create_function_spaces(mesh)
    check(device == "cpu" or V.device == device, "a space built with no device lies on the card")
    W = mixed_space(V)
    params = DPPParameters()
    return W, params, [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)], p1e, p2e


# -- bounds: the least time for each kernel's work, from this run's shapes and
# iteration counts. Operations count each multiply, add and divide the
# kernel's algorithm does; bytes count each input read once and each output
# written once.


def bound(nbytes: float, flops64: float, flops32: float = 0.0):
    """(bound in ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops64 / FP64_PER_S + flops32 / FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _nnz(st) -> int:
    import numpy as np

    return int(np.count_nonzero(st))


def matvec_flops(mesh, params) -> int:
    """One BC-eliminated two-field matvec (S1 z1 + C z2, C z1 + S2 z2)."""
    from perphil_tpu_torch.ops.assembly import dpp_stencils

    S1, S2, C = dpp_stencils(mesh, params)
    return 2 * mesh.num_interior_vertices * (_nnz(S1) + _nnz(S2) + 2 * _nnz(C))


def transform_flops(mesh) -> int:
    """One separable fast-diag transform of one field's interior (all axes)."""
    inner = [n - 2 for n in mesh.node_shape]
    nint = math.prod(inner)
    return sum(2 * n * nint for n in inner)


def ilu_apply_flops(ilu) -> int:
    return ilu.nrows * (2 * (len(ilu.lower) + len(ilu.upper)) + 1)


def ilu_bytes(ilu) -> int:
    return 8 * ilu.factors.numel() + 4 * (ilu.level_ptr.numel() + ilu.level_rows.numel())


def gmres_flops(L: int, its: int, m: int, apply_flops: int):
    """Restarted GMRES(m) over L values, ``its`` steps: (flops without the
    preconditioner, number of operator + preconditioner applications)."""
    total, applies, left = 0, 0, its
    while True:
        j = min(m, left)
        applies += 1 + j
        total += apply_flops + 5 * L  # residual, its norm and scaling
        total += sum(apply_flops + 4 * (k + 1) * L + 4 * L for k in range(j))  # CGS, norm, scale
        total += 2 * j * L  # the update
        left -= j
        if left <= 0 or j == 0:
            return total, applies


def fused_gmres_work(solver, op, its: int):
    """(bytes, f64 flops) of one fused GMRES solve of ``its`` steps; the
    fieldsplit roles' inner work from the kernel's own counts of its last
    launch (``solver.launch_inner``: the twin applies P(b - A x0) once more)."""
    from perphil_tpu_torch.ops.fused_gmres import INNER_TOLS

    mesh, p = op.mesh, op.params
    n = mesh.num_vertices
    L = 2 * n
    core, applies = gmres_flops(L, its, solver.restart, matvec_flops(mesh, p))
    nbytes = 3 * 8 * L  # b, x0 in; x out
    pc = 0
    if solver.pc_type == "jacobi":
        pc, nbytes = applies * L, nbytes + 8 * L
    elif solver.pc_type == "ilu":
        pc, nbytes = applies * ilu_apply_flops(solver.ilu), nbytes + ilu_bytes(solver.ilu)
    elif solver.pc_type in INNER_TOLS:
        from perphil_tpu_torch.ops.assembly import dpp_stencils
        from perphil_tpu_torch.ops.stencil import compile_stencils

        n_int = mesh.num_interior_vertices
        S1, _, _ = dpp_stencils(mesh, p)
        if solver.field_ilu is not None:
            inner_pc = ilu_apply_flops(solver.field_ilu[0])
            nbytes += sum(ilu_bytes(f) for f in solver.field_ilu)
        else:
            inner_pc = 2 * transform_flops(mesh) + n_int
            nbytes += 8 * (solver.sc.numel() + sum(S.numel() for S in solver.field_fd[0].mats))
        coupling = n_int * (2 * _nnz(compile_stencils(mesh)[1]) + 1) + n
        inner_its, inner_solves = solver.launch_inner
        pc = (
            applies * coupling
            + inner_solves * (inner_pc + 4 * n)
            + inner_its * (2 * n_int * _nnz(S1) + inner_pc + 12 * n)
        )
    return nbytes, core + pc


def picard_inputs(op, bcs):
    """The Picard solves' start: the lifted right-hand side b and the BC
    lift x0, stacked."""
    import torch

    g1, g2 = (bc.grid_values(op.mesh) for bc in bcs)
    bdry = op._mask_arrays[0]
    b = torch.stack(op.lifted_rhs(g1, g2)).contiguous()
    return b, torch.stack([torch.where(bdry, g1, 0.0), torch.where(bdry, g2, 0.0)]).contiguous()


def fused_ngs_work(solver, its: int):
    """(bytes, f64 flops) of one fused NGS solve of ``its`` iterations: a
    residual row is 18 products, 18 sums and a difference; an update a
    divide and a sum; the norm a square and a sum a row; colour 0 reuses the
    norm's residual. Bytes: b and x0 read, x written, the colour lists
    (2 bytes an entry) and the bounds and push tables (4 bytes) read once."""
    import numpy as np

    colors = solver.sweeper.colors
    interior = np.tile(~solver.sweeper.mesh.boundary_mask().ravel(), 2)
    nint, c0 = int(interior.sum()), int((interior & (colors == 0)).sum())
    per_it = (nint - c0) * 39 + c0 * 2 + nint * 39
    tables = 2 * nint + 4 * (solver.cptr.numel() + solver.sends.numel())
    return 3 * 8 * colors.size + tables, nint * 39 + its * per_it


def dense_system(op, b):
    """The library yardstick of the direct kernels: the BC-eliminated
    operator materialised as a dense (2n, 2n) f64 matrix on b's device (the
    plain matvec of each unit vector) and b flat, for one
    ``torch.linalg.solve`` call."""
    import torch

    from perphil_tpu_torch.ops.assembly import dpp_stencils
    from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain

    S = dpp_stencils(op.mesh, op.params)
    units = torch.eye(b.numel(), dtype=torch.float64, device=b.device).reshape((-1,) + tuple(b.shape))
    A = torch.stack([torch.stack(fused_dpp_apply_plain(e[0], e[1], *S)).reshape(-1) for e in units], dim=1)
    return A, b.reshape(-1)


def library_solve(op, b, x, what: str) -> float:
    """Time one torch.linalg.solve on the dense system (CUDA events around
    each call: it reads its status back) after holding it to the kernel's
    solution x."""
    import torch

    A, rhs = dense_system(op, b)
    err = rel(torch.linalg.solve(A, rhs), x.reshape(-1))
    print(f"{what}: torch.linalg.solve on the dense {A.shape[0]} x {A.shape[1]} system, max rel diff vs the kernel {err:.3e}")
    check(err <= 1e-10, f"{what}: the dense solve computes the kernel's solution")
    return time_ms(lambda: torch.linalg.solve(A, rhs), repeats=20)


def dense_factor(M, device):
    """A strictly lower per-field factor block as the dense unit lower
    triangular matrix on ``device``: the input of the library yardstick
    ``torch.linalg.solve_triangular`` (the port never calls it)."""
    import numpy as np
    import torch

    coo = M.tocoo()
    D = torch.zeros(M.shape, dtype=torch.float64, device=device)
    rows, cols = (torch.from_numpy(a.astype(np.int64)).to(device) for a in (coo.row, coo.col))
    D[rows, cols] = torch.from_numpy(coo.data.astype(np.float64)).to(device)
    D.diagonal().add_(1.0)
    return D


def parity_factor(nx: int):
    """(mesh, perm, combined ILU(0) factor, bandwidth) of the tet nx parity
    system, factored on the host."""
    from perphil_tpu_torch.mesh import create_cube_mesh
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops import _native
    from perphil_tpu_torch.ops import bandsolve as bs
    from perphil_tpu_torch.ops.ordering import parity_system

    mesh = create_cube_mesh(nx, nx, nx)
    _, perm, Ap = parity_system(mesh, DPPParameters())
    Fc, _ = _native.native_ilu0(Ap)
    return mesh, perm, Fc, bs.factor_bandwidth(Fc, mesh.num_vertices)


def band_factor_time(P, r, lower: bool, n: int, bw: int, repeats: int = 20):
    """``band_trisolve`` on one packed factor: (ms by CUDA events, bytes the
    solve needs, its bound as ``bound`` gives it)."""
    from perphil_tpu_torch.ops import bandsolve as bs

    B = P.shape[1]
    ms = time_ms(lambda: bs.tri_apply(P, r, lower, B - bw), repeats=repeats)
    nbytes, flops = bs.tri_apply_traffic(n, B, B - bw, lower)
    return ms, nbytes, bound(nbytes, flops)


def parity_path(dev, smi, randn, results, t_start):
    """Phase 8, the ordering-parity ILU (``pc_factor_mat_ordering_type=rcm``):
    ``band_trisolve`` against its twin at tet nx=4/16/24/40 (a lower and an
    upper factor, CUDA events beside the twin, the bound and, at nx=16/24,
    ``torch.linalg.solve_triangular`` on the dense factor), the whole band
    apply at nx=40 against the sequential factor solves and its build's
    device memory against ``band_plan``; then, counted, ``solve_dpp`` on the
    device engine at tet nx=4..40 held to the published
    6/8/12/15/17/20/26/29/33 with four ``band_trisolve`` launches an apply,
    K1 as the outer matvec (one an apply, plus the lift and the Newton-step
    residual) and no K7, and the host engine at nx=4 and 40 with the same counts, in
    turns with the device engine. Adds the kernel's entries to ``results``
    and returns the phase's launches of its kernels."""
    import numpy as np
    import scipy.sparse as sparse
    import scipy.sparse.linalg as spla
    import torch

    from perphil_tpu_torch.ops import _cuda
    from perphil_tpu_torch.ops import bandsolve as bs
    from perphil_tpu_torch.ops.assembly import DPPOperator, dpp_stencils
    from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain
    from perphil_tpu_torch.solvers import solve_dpp
    from perphil_tpu_torch.solvers.solver import _build_linear_solver, _freeze

    PRESETS = presets()

    # band_trisolve against its twin (not counted), a lower and an upper
    # factor of field 1 at each size, on the factor's blocks; the library
    # yardstick beside it where the dense factor fits comfortably
    for nx in PARITY_KERNEL_SIZES:
        mesh, perm, Fc, bw = parity_factor(nx)
        nv = mesh.num_vertices
        parts = bs.split_monolithic_factor(Fc, nv)
        B = bs.band_block_size(bw)
        for tag, M, lower in (("L11", parts[0], True), ("U11", parts[3], False)):
            P = bs.build_blocks(M, B, lower, dev)
            nb = P.shape[0]
            r = randn(nb * B)
            y = bs.tri_apply(P, r, lower, B - bw)
            torch.cuda.synchronize()
            yp, plain_ms = timed_once(lambda: bs.tri_apply_plain(P, r, lower, B - bw))
            abs_err = float((y - yp).abs().max())
            err = abs_err / float(yp.abs().max())
            ms, nbytes, kbound = band_factor_time(P, r, lower, nv, bw)
            line = (f"band_trisolve tet nx={nx} {tag}: bandwidth {bw}, B {B}, nb {nb}, "
                    f"needs {nbytes / 1e6:.1f} MB (packed {8 * nb * B * B / 1e6:.1f} MB), "
                    f"max abs diff vs twin {abs_err:.3e} ({err:.3e} of max), {ms:.4f} ms, twin {plain_ms:.4f} ms, "
                    f"bound {kbound[0]:.4f} ms, {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s of the needed bytes")
            check(err <= 1e-13, f"band_trisolve tet nx={nx} {tag} vs twin")
            entry = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound=kbound,
                         shape=f"tet nx={nx} {tag}, B {B}, nb {nb}")
            if nx in PARITY_LIBRARY_SIZES and lower:
                D = dense_factor(M, dev)
                rd = r[:nv, None].contiguous()
                ref = torch.linalg.solve_triangular(D, rd, upper=False, unitriangular=True)
                lib_err = rel(y[:nv], ref[:, 0])
                check(lib_err <= 1e-12, f"solve_triangular computes band_trisolve's solution at nx={nx}")
                entry["library_ms"] = time_ms(
                    lambda: torch.linalg.solve_triangular(D, rd, upper=False, unitriangular=True), repeats=10)
                line += (f"; torch.linalg.solve_triangular on the dense {nv} x {nv} factor {entry['library_ms']:.4f} ms "
                         f"(max rel diff {lib_err:.3e})")
                del D, rd, ref
            print(line)
            results[f"band_trisolve@tet{nx}-{tag}"] = entry
            del P, y, yp
        if nx == max(PARITY_KERNEL_SIZES):
            # the whole apply against the sequential factor solves (scipy), and
            # the build's device memory against its plan
            plan = bs.band_plan(nv, bw)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            band = bs.build_band_parity_ilu(Fc, perm, nv, mesh.node_shape, dev)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            print(f"band engine build tet nx={nx}: peak {peak} B of device memory, plan {plan.total_bytes} B "
                  f"(packed {plan.packed_bytes} B)")
            check(plan.packed_bytes <= peak <= plan.total_bytes, "the band engine's build stays within its plan")
            rn = randn((2,) + tuple(mesh.node_shape))
            z = band.apply(rn)
            rp = rn.reshape(-1).cpu().numpy()[perm]
            Lf = (sparse.tril(Fc, -1) + sparse.eye(Fc.shape[0])).tocsr()
            Uf = sparse.triu(Fc).tocsr()
            zref = spla.spsolve_triangular(Uf, spla.spsolve_triangular(Lf, rp, lower=True, unit_diagonal=True),
                                           lower=False)
            zp = z.reshape(-1).cpu().numpy()[perm]
            apply_err = float(np.abs(zp - zref).max() / np.abs(zref).max())
            apply_ms = time_ms(lambda: band.apply(rn), repeats=10)
            print(f"BandParityILU.apply tet nx={nx}: {apply_ms:.4f} ms (4 band_trisolve launches, CUDA events), "
                  f"max rel diff vs the sequential factor solves {apply_err:.3e}")
            check(apply_err <= 1e-13, "the band apply computes U^-1 L^-1 r")
            del band, z
    torch.cuda.synchronize()
    print(f"[{time.perf_counter() - t_start:.1f} s] band_trisolve checked against its twin")

    # the path, counted: solve_dpp with pc_factor_mat_ordering_type=rcm on
    # the device engine at every published size, each solve through
    # band_trisolve and never through K7
    rcm = PRESETS["GMRES_ILU_RCM"]
    psetups = [problem("tet", n, dev) for n in PARITY_COUNTS]
    torch.cuda.synchronize()
    _cuda.KERNEL_LAUNCHES.clear()
    psols, pcounts, pwalls = [], [], []
    for W, params, bcs, _, _ in psetups:
        before = dict(_cuda.KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        psols.append(solve_dpp(W, params, bcs, solver_parameters=rcm))
        torch.cuda.synchronize()
        pwalls.append(time.perf_counter() - t0)
        pcounts.append({k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items() if v != before.get(k, 0)})
    phase = dict(_cuda.KERNEL_LAUNCHES)
    print(f"ordering-parity path kernel launches, all cases: {phase}")
    for name in (*PARITY_KERNELS, "fused_dpp_apply"):
        check(phase.get(name, 0) > 0, f"{name} launched on the ordering-parity path")
    check(phase.get("fused_gmres_df[ilu]", 0) == 0, "no K7 launch on the ordering-parity path")
    parity_cached = {}
    for (n, count), (W, params, bcs, _, _), sol, counts, wall in zip(PARITY_COUNTS.items(), psetups, psols, pcounts,
                                                                     pwalls):
        z1, z2 = sol.solution.data
        its = sol.iteration_number
        solver = _build_linear_solver(W, params, _freeze(rcm))
        check(solver.engine == "device", f"tet nx={n}: the band engine serves the card")
        applies = 1 + math.ceil(its / rcm.get("ksp_gmres_restart", 30)) + its
        check(counts.get("band_trisolve", 0) == 4 * applies, f"tet nx={n}: four band_trisolve launches an apply")
        # K1: the lift and the Newton-step residual, then one matvec an apply
        check(counts.get("fused_dpp_apply", 0) == 2 + applies, f"tet nx={n}: K1 is the outer matvec")
        check(bool(torch.isfinite(z1).all() and torch.isfinite(z2).all()), "finite solution")
        check(z1.device == dev and tuple(z1.shape) == W.mesh.node_shape, "solution on the card")
        op = DPPOperator(W, params)
        r0 = float(newton_rhs(op, bcs).norm())
        S = dpp_stencils(W.mesh, params)
        g1, g2 = (bc.grid_values(W.mesh) for bc in bcs)
        b1, b2 = fused_dpp_apply_plain(g1, g2, *S, mode="lift")
        y1, y2 = fused_dpp_apply_plain(z1, z2, *S, mode="matvec")
        rres = math.sqrt(float(((b1 - y1) ** 2).sum() + ((b2 - y2) ** 2).sum())) / r0
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver(g1, g2)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        parity_cached[n] = statistics.median(walls)
        line = (f"solve_dpp tet nx={n} GMRES+ILU rcm (device engine): iterations {its} (expected {count}), "
                f"launches {counts}, first solve {wall * 1e3:.2f} ms (host set-up included), cached solve "
                f"{parity_cached[n]:.2f} ms ({parity_cached[n] * 1e3 / its:.2f} us/iteration; host clock, median of 3), "
                f"|b - A x| / |r0| {rres:.3e}")
        check(its == count, f"tet nx={n} ordering-parity count")
        check(rres < 1e-5, f"tet nx={n} ordering-parity residual")
        if n <= 8:
            Wc, pc, bcc, _, _ = problem("tet", n, "cpu")
            ref = solve_dpp(Wc, pc, bcc, solver_parameters=rcm)  # the host engine on the CPU
            cpu_diff = max(rel(a.cpu(), r) for a, r in zip((z1, z2), ref.solution.data))
            line += f", vs the CPU's host engine {cpu_diff:.3e} ({ref.iteration_number} iterations)"
            check(ref.iteration_number == its and cpu_diff < 1e-10, f"tet nx={n} rcm vs CPU")
        print(line)
    # the host engine at the smallest and largest published mesh: the same
    # counts, the solve timed in turns with the device engine (host clock)
    host = PRESETS["GMRES_ILU_RCM_HOST"]
    for n in PARITY_HOST_SIZES:
        W, params, bcs, _, _ = psetups[list(PARITY_COUNTS).index(n)]
        before = dict(_cuda.KERNEL_LAUNCHES)
        sol = solve_dpp(W, params, bcs, solver_parameters=host)
        used = {k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items() if v != before.get(k, 0)}
        solvers = {"host": _build_linear_solver(W, params, _freeze(host)),
                   "device": _build_linear_solver(W, params, _freeze(rcm))}
        check(solvers["host"].engine == "host" and used.get("band_trisolve", 0) == 0, f"tet nx={n}: the host engine")
        check(sol.iteration_number == PARITY_COUNTS[n], f"tet nx={n} host engine count")
        dev_sol = psols[list(PARITY_COUNTS).index(n)]
        diff = max(rel(a, b) for a, b in zip(sol.solution.data, dev_sol.solution.data))
        check(sol.solution.data[0].device == dev and diff < 1e-8, f"tet nx={n}: host and device engines agree")
        g1, g2 = (bc.grid_values(W.mesh) for bc in bcs)
        walls = {"host": [], "device": []}
        for side in ("host", "device", "device", "host"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solvers[side](g1, g2)
            torch.cuda.synchronize()
            walls[side].append((time.perf_counter() - t0) * 1e3)
        print(f"solve_dpp tet nx={n} GMRES+ILU rcm: host engine {sol.iteration_number} iterations, launches {used}, "
              f"fields within {diff:.3e} of the device engine's; cached solve host engine "
              f"{' / '.join(f'{w:.2f}' for w in walls['host'])} ms, device engine "
              f"{' / '.join(f'{w:.2f}' for w in walls['device'])} ms (host clock, in turns) on {smi}")
    torch.cuda.synchronize()
    print(f"[{time.perf_counter() - t_start:.1f} s] ordering-parity path done")
    results["band_trisolve"] = results[f"band_trisolve@tet{PARITY_TABLE_SIZE}-L11"]
    return {k: v for k, v in phase.items() if k in PARITY_KERNELS}


PARTRI_APPLY_CASES = [("quad", 128, "monolithic"), ("quad", 256, "monolithic"), ("quad", 256, "field"),
                      ("tet", 16, "monolithic")]  # PartriILU against structured_ilu_apply
PARTRI_GS_CASES = [("triangle", 16), ("tet", 4)]  # PartriGS against structured_ilu_apply[gs]
# the published GMRES + ILU counts (petsc_perf_breakdown.csv) the host loop
# with the partri ILU lands exactly
PARTRI_GMRES_COUNTS = {128: 74, 256: 117}
PARTRI_PICARD_CASES = [("triangle", 16), ("tet", 4)]  # the lexicographic Picard on partri, then left open


def partri_path(dev, smi, randn, t_start):
    """Phase 9, the parallel-prefix trisolves (``trisolve_backend``): the
    partri ILU apply (``PartriILU``, torch ops) against
    ``structured_ilu_apply`` on the same factor at 2D N=128/256 monolithic,
    one 2D N=256 field and tet nx=16 monolithic, and the partri GS sweep
    against ``structured_ilu_apply[gs]`` at tri N=16 / tet nx=4 (max
    relative difference <= 1e-12), both timed with CUDA events beside the
    bytes of the maps an apply reads and their bound, the build's time and
    its peak memory, held within ``partri_peak``; then, counted, the host
    GMRES loop (``krylov.gmres``, K1, ``_monolithic_pc`` with
    ``trisolve_backend=partri``) landing the published 74/117 exactly at 2D
    N=128/256, and ``solve_dpp_nonlinear`` on partri at tri N=16 / tet nx=4;
    after the count, the same Picard with the option left open (the
    wavefront kernel on the card) and on the CPU (partri), with equal
    counts. Returns the counted run's launches."""
    import torch

    from perphil_tpu_torch.ops import _cuda
    from perphil_tpu_torch.ops import ilu
    from perphil_tpu_torch.ops.assembly import DPPOperator
    from perphil_tpu_torch.ops.krylov import gmres
    from perphil_tpu_torch.ops.partri import nbytes
    from perphil_tpu_torch.solvers import solve_dpp_nonlinear
    from perphil_tpu_torch.solvers.solver import _freeze, _monolithic_pc, _trisolve_backend

    PRESETS = presets()
    # the partri apply against the wavefront kernel on the same factor (not counted)
    for element, n, kind in PARTRI_APPLY_CASES:
        W, params, _, _, _ = problem(element, n, dev)
        mesh = W.mesh
        sys = (ilu.build_monolithic_system(mesh, params) if kind == "monolithic"
               else ilu.build_field_system(mesh, params.k1, params.beta, params.mu))
        r = randn(sys.nrows)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pc, build_ms = timed_once(lambda: ilu.PartriILU.for_system(sys, dev))  # the host factorisation too
        z = pc.apply_flat(r)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        plan, peak_plan = ilu.partri_plan(mesh.node_shape, sys.nfields), ilu.partri_peak(mesh.node_shape, sys.nfields)
        check(peak <= peak_plan, f"partri ILU {element} N={n} {kind}: the build's peak within partri_peak")
        maps = nbytes(pc)
        wave = ilu.StructuredILU0(sys, dev)
        zw = wave.launch(r)
        torch.cuda.synchronize()
        err = rel(z, zw)
        check(err <= 1e-12, f"partri ILU {element} N={n} {kind} vs structured_ilu_apply")
        ms = time_ms(lambda: pc.apply_flat(r), repeats=20)
        wave_ms = time_ms(lambda: wave.launch(r), repeats=20)
        nbytes_apply = maps + 2 * 8 * pc.nrows
        pbound = bound(nbytes_apply, maps / 4)  # every stored map entry: one multiply and one add
        wbound = bound(ilu_bytes(wave) + 2 * 8 * pc.nrows, ilu_apply_flops(wave))
        print(f"partri ILU {element} N={n} {kind}: {pc.nrows} rows, max rel diff vs structured_ilu_apply {err:.3e} "
              f"(bound 1e-12); apply {ms:.4f} ms, structured_ilu_apply {wave_ms:.4f} ms (CUDA events, median of 20); "
              f"maps {maps} B read an apply (partri_plan {plan} B), bound {pbound[0]:.4f} ms ({pbound[1]}, "
              f"{nbytes_apply / (ms * 1e-3) / 1e12:.3f} TB/s of them), the wavefront's bound {wbound[0]:.4f} ms; "
              f"build {build_ms:.1f} ms (the host factorisation included), peak {peak} B of device memory with "
              f"one apply (partri_peak {peak_plan} B) on {smi}")
        del pc, wave, z, zw
    for element, n in PARTRI_GS_CASES:
        W, params, _, _, _ = problem(element, n, dev)
        swp = ilu.PartriGS.for_monolithic(W.mesh, params, dev)
        wave = ilu.GaussSeidelSweeper.for_monolithic(W.mesh, params, dev)
        x, bb = randn(swp.nrows), randn(swp.nrows)
        z, zw = swp.sweep(x, bb), wave.launch(x, bb)
        torch.cuda.synchronize()
        err = rel(z, zw)
        check(err <= 1e-12, f"partri GS {element} N={n} vs structured_ilu_apply[gs]")
        ms = time_ms(lambda: swp.sweep(x, bb), repeats=20)
        wave_ms = time_ms(lambda: wave.launch(x, bb), repeats=20)
        print(f"partri GS {element} N={n}: {swp.nrows} rows, max rel diff vs structured_ilu_apply[gs] {err:.3e} "
              f"(bound 1e-12); sweep {ms:.4f} ms, structured_ilu_apply[gs] {wave_ms:.4f} ms (CUDA events, median of "
              f"20); maps {nbytes(swp)} B on {smi}")
    torch.cuda.synchronize()
    print(f"[{time.perf_counter() - t_start:.1f} s] partri checked against the wavefront kernels")

    # the path, counted: the host GMRES loop and the lexicographic Picard
    # with trisolve_backend=partri
    gsetups = {n: problem("quad", n, dev) for n in PARTRI_GMRES_COUNTS}
    psetups = [problem(e, n, dev) for e, n in PARTRI_PICARD_CASES]
    flat = dict(_freeze(PRESETS["GMRES_ILU_PARTRI"]))
    kw = {k: PRESETS["GMRES_ILU_PARTRI"][f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    torch.cuda.synchronize()
    _cuda.KERNEL_LAUNCHES.clear()
    for n, count in PARTRI_GMRES_COUNTS.items():
        W, params, bcs, _, _ = gsetups[n]
        op = DPPOperator(W, params)
        r = newton_rhs(op, bcs)
        t0 = time.perf_counter()
        pc = _monolithic_pc(op, flat)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        check(pc.__self__.trisolve_backend == "partri", f"2D N={n}: trisolve_backend=partri builds partri")
        before = dict(_cuda.KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        res = gmres(op.stacked_matvec(), r, M_inv=pc, restart=int(flat.get("ksp_gmres_restart", 30)), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = {k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items() if v != before.get(k, 0)}
        print(f"host GMRES + partri ILU 2D N={n}: iterations {res.iterations} (published {count}), launches {used}, "
              f"ILU set-up {setup * 1e3:.1f} ms, solve {wall * 1e3:.2f} ms ({wall * 1e6 / res.iterations:.2f} "
              f"us/iteration; host clock) on {smi}")
        check(res.iterations == count, f"2D N={n}: the host GMRES + partri ILU lands {count}")
        check(used.get("fused_dpp_apply", 0) > res.iterations and "structured_ilu_apply" not in used,
              f"2D N={n}: K1 is the matvec, the ILU runs no wavefront kernel")
        check(bool(torch.isfinite(res.x).all()), "finite solution")
        del pc
    picard = []
    for (element, n), (W, params, bcs, _, _) in zip(PARTRI_PICARD_CASES, psetups):
        before = dict(_cuda.KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        sol = solve_dpp_nonlinear(W, params, bcs, solver_parameters=PRESETS["PICARD_LU_PARTRI"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = {k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items() if v != before.get(k, 0)}
        check("structured_ilu_apply[gs]" not in used and used.get("fused_dpp_apply", 0) > 0,
              f"{element} N={n}: trisolve_backend=partri sweeps with partri, K1 residuals")
        check(bool(all(torch.isfinite(d).all() for d in sol.solution.data)), "finite solution")
        picard.append((sol, used, wall))
    torch.cuda.synchronize()
    phase = dict(_cuda.KERNEL_LAUNCHES)
    print(f"partri path kernel launches (the counted run): {phase}")
    check(phase.get("fused_dpp_apply", 0) > 0, "fused_dpp_apply launched on the partri path")
    check(not {"structured_ilu_apply", "structured_ilu_apply[gs]"} & set(phase),
          "the partri path launches no wavefront kernel")

    # after the count: the option left open (the wavefront on the card) and the CPU's partri
    for (element, n), (W, params, bcs, _, _), (sol, used, wall) in zip(PARTRI_PICARD_CASES, psetups, picard):
        check(_trisolve_backend("", W.mesh.node_shape, 2, W.device) == "wavefront",
              f"{element} N={n}: left open, the card takes the wavefront")
        before = dict(_cuda.KERNEL_LAUNCHES)
        wave = solve_dpp_nonlinear(W, params, bcs, solver_parameters=PRESETS["PICARD_LU_SOLVER_PARAMS"])
        torch.cuda.synchronize()
        wave_used = {k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items() if v != before.get(k, 0)}
        Wc, pc_, bcc, _, _ = problem(element, n, "cpu")
        ref = solve_dpp_nonlinear(Wc, pc_, bcc, solver_parameters=PRESETS["PICARD_LU_SOLVER_PARAMS"])
        cpu_diff = max(rel(a.cpu(), b) for a, b in zip(sol.solution.data, ref.solution.data))
        print(f"solve_dpp_nonlinear {element} N={n} PICARD_LU_SOLVER_PARAMS, trisolve_backend=partri: iterations "
              f"{sol.iteration_number}, launches {used}, wall {wall * 1e3:.1f} ms (host clock); left open (the "
              f"wavefront) {wave.iteration_number}, launches {wave_used}; the CPU's partri {ref.iteration_number} "
              f"(fields within {cpu_diff:.3e}) on {smi}")
        check(wave_used.get("structured_ilu_apply[gs]") == wave.iteration_number,
              f"{element} N={n}: left open, one GS-mode launch an iteration")
        check(sol.iteration_number == wave.iteration_number == ref.iteration_number and cpu_diff < 1e-8,
              f"{element} N={n} partri vs the wavefront and the CPU")
    torch.cuda.synchronize()
    print(f"[{time.perf_counter() - t_start:.1f} s] partri path done")
    return phase


# the published condition numbers: notebooks/results-conforming-2d/conditioning/
# conditioning.csv and results-conforming-3d/conditioning/conditioning_3d.csv
COND_CASES = [  # element, N, sparse (Lanczos on the card) or dense (host SVD), bound on the rel error
    ("quad", 16, True, 1e-8), ("quad", 32, True, 1e-8),
    ("quad", 64, True, 1e-5),  # k = 100 Lanczos steps leave ~4.3e-6 (the route's own convergence)
    ("hex", 4, False, 1e-10), ("hex", 8, True, 1e-10),
]


def conditioning_path(dev, smi, t_start):
    """Phase 10, the conditioning analysis: ``estimate_condition_numbers``
    with Lanczos on the card at 2D N=16/32/64 and hex N=8 and the dense host
    SVD at hex N=4, each against the published CSV; then tet nx=4's Lanczos
    κ (its inverse through K3) against the dense SVD, counted. Prints κ, the
    relative error and the wall time of each."""
    import numpy as np
    import torch

    from perphil_tpu_torch.experiments.iterative_bench import estimate_condition_numbers
    from perphil_tpu_torch.ops import _cuda

    keys = ("monolithic", "macro", "micro")

    def published(path):
        rows = np.loadtxt(HERE / "notebooks" / path, delimiter=",", skiprows=1, ndmin=2)
        return {int(r[0]): tuple(r[2:5]) for r in rows}

    tables = {"quad": published("results-conforming-2d/conditioning/conditioning.csv"),
              "hex": published("results-conforming-3d/conditioning/conditioning_3d.csv")}
    for element, n, sparse, tol in COND_CASES:
        W = problem(element, n, dev)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conds = estimate_condition_numbers(W, num_of_factors=50 if sparse else None, use_sparse=sparse)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        errs = [abs(conds[k] - ref) / ref for k, ref in zip(keys, tables[element][n])]
        print(f"conditioning {element} N={n} ({'Lanczos on the card' if sparse else 'dense host SVD'}): "
              + ", ".join(f"{k} {conds[k]!r} (rel err {e:.3e})" for k, e in zip(keys, errs))
              + f"; bound {tol:g}; wall {wall * 1e3:.1f} ms (host clock) on {smi}")
        check(max(errs) <= tol, f"conditioning {element} N={n} against the published CSV")
    W = problem("tet", 4, dev)[0]
    torch.cuda.synchronize()
    _cuda.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    conds = estimate_condition_numbers(W, num_of_factors=50, use_sparse=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phase = dict(_cuda.KERNEL_LAUNCHES)
    dense = estimate_condition_numbers(W, num_of_factors=None, use_sparse=False)
    errs = [abs(conds[k] - dense[k]) / dense[k] for k in keys]
    print(f"conditioning tet N=4 (Lanczos on the card, the monolithic inverse through K3): "
          + ", ".join(f"{k} {conds[k]!r} (rel err vs the dense SVD {e:.3e})" for k, e in zip(keys, errs))
          + f"; launches {phase}; wall {wall * 1e3:.1f} ms (host clock) on {smi}")
    check(max(errs) <= 1e-6, "conditioning tet N=4: Lanczos against the dense SVD")
    check(phase.get("fused_simplicial_direct_solve", 0) > 0, "K3 launched on the conditioning path")
    print(f"[{time.perf_counter() - t_start:.1f} s] conditioning path done")
    return phase


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

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
    from perphil_tpu_torch.ops.assembly import DPPOperator, FieldOperator, dpp_stencils
    from perphil_tpu_torch.ops.fused_apply import (
        box_boundary,
        fused_dpp_apply,
        fused_dpp_apply_plain,
        fused_dpp_apply_stacked,
    )
    from perphil_tpu_torch.ops.fused_direct import K2, K3, fused_direct_solve, fused_simplicial_direct_solve
    from perphil_tpu_torch.ops.fused_gmres import (
        MAX_SMEM_PER_BLOCK,
        SMEM_BUDGET,
        FusedGMRESSolver,
        launch_geometry,
        static_smem,
    )
    from perphil_tpu_torch.ops.ilu import StructuredILU0
    from perphil_tpu_torch.solvers import parameters as sp
    from perphil_tpu_torch.solvers import solve_dpp
    from perphil_tpu_torch.ops.krylov import _norm, gmres
    from perphil_tpu_torch.solvers.solver import (
        _build_linear_solver,
        _build_nonlinear_solver,
        _freeze,
        _monolithic_pc,
    )
    from perphil_tpu_torch.utils.postprocessing import h1_seminorm_error, l2_error

    PRESETS = presets()

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
    t_start = time.perf_counter()

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.BUILD_INFO
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s, cached={info['cached']})")
    print(f"library: {info['path']}")
    # ptxas -v, one line a kernel: registers, stack, spills, static shared memory
    entry, stack = "", ""
    for line in str(info.get("log", "")).splitlines():
        text = line.split("ptxas info    :")[-1].strip()
        if "Compiling entry function" in line:
            entry = text.split("'")[1]
        elif "spill" in line:
            stack = text
        elif "Used" in line and entry:
            print(f"  ptxas {entry[:72]}: {text}; {stack}")
            entry = ""
    # what each fused GMRES role's static shared memory leaves of the budget
    # its launches plan with (the launcher refuses a role that leaves less)
    for pc in ("none", "jacobi", "ilu", "fieldsplit_lu", "fieldsplit_ilu"):
        margins = [MAX_SMEM_PER_BLOCK - static_smem(pc, d) - SMEM_BUDGET for d in (2, 3)]
        print(f"  fused GMRES pc {pc}: static shared memory {static_smem(pc, 3)} B, "
              f"{min(margins)} B over the {SMEM_BUDGET} B budget")
        check(min(margins) >= 0, f"fused GMRES pc {pc} leaves the shared-memory budget")

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
        ("tet40", problem("tet", 40, dev)[0], torch.float64, 1e-13),  # the ordering-parity path's largest
        ("hex64-f32", W64, torch.float32, 2e-6),
        ("hex128-f32", W128, torch.float32, 2e-6),
    ]
    for tag, W, dtype, tol in k1_cases:
        S = dpp_stencils(W.mesh, params)
        z = torch.stack([randn(W.mesh.node_shape, dtype), randn(W.mesh.node_shape, dtype)])
        z1, z2 = z[0], z[1]
        for mode in ("matvec", "lift"):
            y = fused_dpp_apply(z1, z2, *S, mode=mode)
            ys = fused_dpp_apply_stacked(z, *S, mode=mode)
            yp = fused_dpp_apply_plain(z1, z2, *S, mode=mode)
            torch.cuda.synchronize()
            err = max(rel(a, b) for a, b in zip(y, yp))
            print(f"K1 {tag} {mode}: max rel diff vs twin {err:.3e} (bound {tol:g}), "
                  f"max abs diff {max(float((a - b).abs().max()) for a, b in zip(y, yp)):.3e}")
            check(err <= tol, f"K1 {tag} {mode}")
            check(torch.equal(ys, torch.stack(y)), f"K1 {tag} {mode}: the stacked entry is the pair entry")
        if tag in ("hex64", "hex128"):
            k1_inputs = (W, S, z1, z2)
            y = fused_dpp_apply_stacked(z, *S)
            yp = fused_dpp_apply_plain(z1, z2, *S)
            n = W.mesh.num_vertices
            results[f"fused_dpp_apply@{tag}"] = dict(
                max_abs_err=max(float((a - b).abs().max()) for a, b in zip(y, yp)),
                ms=queued_ms(lambda: fused_dpp_apply_stacked(z, *S)),
                plain_ms=time_ms(lambda: fused_dpp_apply_plain(z1, z2, *S), repeats=50),
                bound=bound(4 * 8 * n, matvec_flops(W.mesh, params)),
                shape=f"{tag} f64 matvec",
            )
    # the library yardstick of K1: one conv3d of the interior-masked stacked
    # fields with the (2, 2, 3, 3, 3) stencil weight; it leaves the boundary
    # rows (identity) out, and the port never calls it
    W, S, z1, z2 = k1_inputs  # hex128, f64
    S1, S2, C = S
    inner = ~box_boundary(W.mesh.node_shape, dev)
    zin = torch.stack([torch.where(inner, z1, 0.0), torch.where(inner, z2, 0.0)])[None].contiguous()
    wt = torch.tensor(np.stack([np.stack([S1, C]), np.stack([C, S2])]), device=dev)
    conv = F.conv3d(zin, wt, padding=1)[0]
    y = fused_dpp_apply(z1, z2, *S)
    conv_err = max(rel(torch.where(inner, c, 0.0), torch.where(inner, k, 0.0)) for c, k in zip(conv, y))
    print(f"K1 hex128 vs conv3d on the interior: max rel diff {conv_err:.3e}")
    check(conv_err <= 1e-12, "conv3d computes K1's interior rows")
    results["fused_dpp_apply"] = dict(
        results["fused_dpp_apply@hex128"],
        library_ms=queued_ms(lambda: F.conv3d(zin, wt, padding=1), calls=10),
    )
    # K1 at 2D N=128 (one f64 matvec of 2 x 129^2 values: the shape the host
    # loops gave it there): its device time, and the host wall of one
    # op.stacked_matvec() call, 1000 back to back and one synchronise
    Wq = problem("quad", 128, dev)[0]
    opq = DPPOperator(Wq, params)
    S = dpp_stencils(Wq.mesh, params)
    zq = torch.stack([randn(Wq.mesh.node_shape), randn(Wq.mesh.node_shape)])
    mv = opq.stacked_matvec()
    y, yp = mv(zq), fused_dpp_apply_plain(zq[0], zq[1], *S)
    err = max(rel(a, b) for a, b in zip(y, yp))
    check(err <= 1e-13, "K1 quad128 matvec")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        mv(zq)
    torch.cuda.synchronize()
    host_ms = time.perf_counter() - t0  # ms a call: seconds over 1000
    key = "fused_dpp_apply@quad128"
    results[key] = dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(y, yp)),
        ms=queued_ms(lambda: mv(zq)),
        plain_ms=time_ms(lambda: fused_dpp_apply_plain(zq[0], zq[1], *S), repeats=50),
        bound=bound(4 * 8 * Wq.mesh.num_vertices, matvec_flops(Wq.mesh, params)),
        shape="quad 129^2 f64 matvec",
    )
    print(f"K1 quad128 matvec: max rel diff vs twin {err:.3e}, device {results[key]['ms']:.4f} ms "
          f"(bound {results[key]['bound'][0]:.6f} ms), op.stacked_matvec() host wall {host_ms:.4f} ms a call "
          f"(1000 calls, one synchronise)")

    # K2 and K3 against their twins at the main path's shapes (quad N=4/16,
    # tet nx=4) and each placement's largest published shape (one block:
    # quad N=64, hex nx=16, tet nx=12; a cluster: hex nx=32 on 8 blocks, tet
    # nx=32 on 16); the device time (launches queued) apart from the call's
    # (events around the Python call), beside the floor of both: an empty
    # kernel through the same ctypes interface
    lib, stream = _cuda.library(), torch.cuda.current_stream().cuda_stream

    def empty():
        _cuda.check(lib.perphil_empty_launch(stream), "perphil_empty_launch")

    floor = (queued_ms(empty), time_ms(empty, repeats=50))
    print(f"launch floor (an empty kernel through ctypes): device {floor[0]:.4f} ms, call {floor[1]:.4f} ms")
    for element, n in (("quad", 4), ("quad", 16), ("quad", 64), ("hex", 16), ("hex", 32), ("triangle", 8),
                       ("tet", 4), ("tet", 12), ("tet", 32)):
        W, params, bcs, _, _ = problem(element, n, dev)
        op = DPPOperator(W, params)
        b = torch.stack(op.lifted_rhs(*[bc.grid_values(W.mesh) for bc in bcs])).contiguous()
        name = "K2" if W.mesh.is_tensor_product else "K3"
        if name == "K2":
            solver = fused_direct_solve(op)
            x, xp = solver.launch(b), solver.plain(b)
            counts = ""
        else:
            solver = fused_simplicial_direct_solve(op)
            (x, its), (xp, its_p) = solver.launch(b), solver.plain(b)
            its = int(its.item())
            counts = f", iterations {its} vs twin {its_p}"
            check(abs(its - its_p) <= 2, f"K3 {element} N={n} iterations")
        torch.cuda.synchronize()
        err = rel(x, xp)
        check(err <= 1e-11, f"{name} {element} N={n} vs twin")
        device_ms = queued_ms(lambda: solver.launch(b))
        call_ms = time_ms(lambda: solver.launch(b), repeats=20)
        print(f"{name} {element} N={n}: {solver.last_placement}, max rel diff vs twin {err:.3e} (bound 1e-11)"
              f"{counts}; device {device_ms:.4f} ms, call {call_ms:.4f} ms (floor {floor[0]:.4f} / {floor[1]:.4f})")
        nv, nint = W.mesh.num_vertices, W.mesh.num_interior_vertices
        if (element, n) == ("quad", 16):
            solve32 = 2 * 2 * transform_flops(W.mesh) + 10 * nint  # 2 fields, 2 ways, 2x2 solves
            refine = solver.refinements
            results["fused_direct_solve"] = dict(
                max_abs_err=float((x - xp).abs().max()), ms=device_ms, call_ms=call_ms,
                plain_ms=time_ms(lambda: solver.plain(b)),
                bound=bound(
                    4 * 8 * nv,
                    refine * (matvec_flops(W.mesh, params) + 4 * nv),
                    (refine + 1) * solve32,
                ),
                shape="quad 16^2",
                library_ms=library_solve(op, b, x, "K2 quad N=16"),
            )
        elif (element, n) == ("tet", 4):
            pcg_step = matvec_flops(W.mesh, params) + 2 * 2 * transform_flops(W.mesh) + 2 * nint + 24 * nv
            results["fused_simplicial_direct_solve"] = dict(
                max_abs_err=float((x - xp).abs().max()), ms=device_ms, call_ms=call_ms,
                plain_ms=time_ms(lambda: solver.plain(b)),
                bound=bound(4 * 8 * nv, (its + 1) * pcg_step),
                shape=f"tet 4^3, {its} PCG iterations",
                library_ms=library_solve(op, b, x, "K3 tet nx=4"),
            )
    torch.cuda.synchronize()

    # the fused GMRES roles against their twin (on the card), on the
    # solver's own right-hand sides; the twin is timed in its check run
    gmres_kw = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    role_cases = [  # element, N, pc, role (None: the pc's), bound on the rel diff, kernel repeats,
        # the host loop's preset where the TPU's gate sent the case there (None: no host-loop run),
        # max_it of the twin's comparison where the whole twin would take long (None: the whole solve)
        ("quad", 8, "none", "fused_gmres_ef64", 0.0, 5, None, None),
        ("quad", 16, "none", None, 0.0, 5, None, None),
        ("quad", 64, "none", None, 0.0, 3, None, None),
        ("quad", 64, "jacobi", None, 0.0, 3, None, None),
        ("tet", 16, "none", None, 0.0, 3, None, None),
        ("quad", 64, "ilu", None, 0.0, 3, None, None),
        ("quad", 64, "fieldsplit_lu", None, 1e-10, 3, None, None),
        ("tet", 8, "fieldsplit_lu", None, 1e-10, 3, None, None),
        ("quad", 16, "fieldsplit_ilu", None, 1e-12, 3, None, None),
        ("quad", 64, "fieldsplit_ilu", None, 0.0, 3, None, None),
        # the published sizes the TPU's gate leaves to the host loop (8, 8,
        # 32 and 8 leaves a thread in 2D); the host loop timed beside each
        ("quad", 128, "none", None, 0.0, 3, "PLAIN_GMRES_PARAMS", None),
        ("quad", 128, "ilu", None, 0.0, 3, "GMRES_ILU_PARAMS", None),
        ("quad", 256, "ilu", None, 0.0, 3, "GMRES_ILU_PARAMS", 20),
        ("quad", 128, "fieldsplit_ilu", None, 0.0, 3, "SS-GMRES+ILU", 2),
        ("tet", 32, "none", None, 0.0, 3, "PLAIN_GMRES_PARAMS", None),  # 16 leaves
        ("tet", 40, "none", None, 0.0, 3, "PLAIN_GMRES_PARAMS", None),  # 32 leaves
        # 3D preconditioned at 16 leaves: K6's eigenbases outside shared memory
        ("tet", 32, "fieldsplit_lu", None, 1e-10, 3, "SS-GMRES", None),
    ]
    for element, n, pc, role, tol, reps, host_preset, twin_its in role_cases:
        W, params, bcs, _, _ = problem(element, n, dev)
        op = DPPOperator(W, params)
        r = newton_rhs(op, bcs)
        solver = FusedGMRESSolver(op, pc, role, **gmres_kw)
        got = solver.launch(r)
        torch.cuda.synchronize()
        # the twin on the whole solve, or where that takes long on the first
        # twin_its steps (the whole solve's count is held on the paths below)
        cmp = solver if twin_its is None else FusedGMRESSolver(op, pc, role, **{**gmres_kw, "max_it": twin_its})
        mine = got if twin_its is None else cmp.launch(r)
        torch.cuda.synchronize()
        ref, plain_ms = timed_once(lambda: cmp.plain(r))
        abs_err = float((mine.x - ref.x).abs().max())
        err = abs_err / float(ref.x.abs().max())
        tag = f"{element} N={n} pc {pc}"
        print(f"{solver.role} {tag}: iterations {mine.iterations} vs twin {ref.iterations}"
              + (f" (max_it {twin_its}; the whole solve {got.iterations})" if twin_its else "")
              + f", max rel diff vs twin {err:.3e} (bound {tol:g}), max abs diff {abs_err:.3e}"
              + (f", twin inner PCG {cmp.inner_iterations} iterations in {cmp.inner_solves} solves"
                 if cmp.inner_solves else ""))
        check(mine.iterations == ref.iterations and mine.converged == ref.converged, f"{solver.role} {tag} count")
        check(err <= tol, f"{solver.role} {tag} vs twin")
        geo = solver.last_geometry
        blocks = geo.blocks
        check(blocks > 1 or r.numel() <= 512, f"{solver.role} {tag} spreads over more than one block")
        ms = time_ms(lambda: solver.launch(r), repeats=reps, warmup=1)
        print(f"  {solver.role} {tag}: {blocks} blocks, {launch_geometry(r.numel()).leaves} leaves a thread, "
              f"{got.iterations} iterations, basis slice in shared memory: {geo.basis_smem}, "
              f"ILU z in shared memory: {geo.ilu_z_smem}, matvec input in shared memory: {geo.input_smem}, "
              f"inner p in shared memory: {geo.p_smem}, "
              f"eigenbases in shared memory: {geo.s_smem}, {ms:.4f} ms, "
              f"{ms * 1e3 / max(got.iterations, 1):.3f} us/iteration")
        if cmp.inner_solves:
            twin = (cmp.inner_iterations, cmp.inner_solves)
            # krylov.gmres applies P(b - A x0) twice (the first norm, then the
            # first cycle); the kernel once: its counts lack one application's
            cmp.inner_iterations = cmp.inner_solves = 0
            cmp.plain_pc()(r)
            once = (twin[0] - cmp.inner_iterations, twin[1] - cmp.inner_solves)
            inner_its, inner_solves = solver.launch_inner
            line = (f"  {solver.role} {tag}: kernel inner PCG {inner_its} iterations in {inner_solves} solves "
                    f"(compared run: kernel {cmp.launch_inner[0]} in {cmp.launch_inner[1]}, twin {twin[0]} in "
                    f"{twin[1]}, {once[0]} in {once[1]} without its repeated first application), "
                    f"{ms * 1e3 / max(inner_its, 1):.3f} us per inner iteration")
            if cmp.field_ilu is not None:
                # bit for bit, so the same inner work; the whole kernel's time over every level swept
                check(cmp.launch_inner == once, f"{solver.role} {tag} inner counts")
                levels = 2 * solver.field_ilu[0].num_levels * (inner_its + inner_solves)
                line += f", {ms * 1e3 / levels:.4f} us per sweep level ({levels} levels)"
            print(line)
        if host_preset is not None:
            # the same solve on the host loop, as solve_dpp ran it where the
            # TPU's gate sent it: krylov.gmres, the K1 matvec, the preset's
            # preconditioner
            flat = dict(_freeze(PRESETS[host_preset]))
            mv, pc_host = op.stacked_matvec(), _monolithic_pc(op, flat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = gmres(mv, r, M_inv=pc_host, restart=int(flat.get("ksp_gmres_restart", 30)), **gmres_kw)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            print(f"  host loop {host_preset} {tag}: {host.iterations} iterations, {host_ms:.2f} ms "
                  f"({host_ms * 1e3 / max(host.iterations, 1):.2f} us/iteration; host clock), "
                  f"fused {ms:.4f} ms: {host_ms / ms:.1f}x")
        results[f"{solver.role}@{tag}"] = dict(
            max_abs_err=abs_err, ms=ms,
            plain_ms=plain_ms, bound=bound(*fused_gmres_work(solver, op, got.iterations)),
            shape=f"{tag}, {got.iterations} iterations, {blocks} blocks"
            + (f"; twin on the first {twin_its}" if twin_its else ""),
        )
    results["fused_gmres_ef64"] = results["fused_gmres_ef64@quad N=8 pc none"]
    results["fused_gmres_df"] = results["fused_gmres_df@quad N=64 pc none"]
    results["fused_gmres_df[ilu]"] = results["fused_gmres_df[ilu]@quad N=64 pc ilu"]
    results["fused_gmres_df[fieldsplit_lu]"] = results["fused_gmres_df[fieldsplit_lu]@quad N=64 pc fieldsplit_lu"]
    results["fused_gmres_df[fieldsplit_ilu]"] = results["fused_gmres_df[fieldsplit_ilu]@quad N=64 pc fieldsplit_ilu"]

    print(f"[{time.perf_counter() - t_start:.1f} s] fused GMRES roles checked")

    # the standalone ILU apply: the monolithic factor at 2D N=128 and one
    # field's on 129^2 nodes, against the plain sweep, bit for bit
    W, params, _, _, _ = problem("quad", 128, dev)
    for tag, pc in (
        ("monolithic 2D N=128", StructuredILU0.for_monolithic(W.mesh, params)),
        ("field 129^2", StructuredILU0.for_field(FieldOperator(W.sub(0), params.k1, params.beta, params.mu))),
    ):
        r = randn(pc.nrows)
        z = pc.launch(r)
        torch.cuda.synchronize()
        zp, plain_ms = timed_once(lambda: pc.plain(r))
        abs_err = float((z - zp).abs().max())
        print(f"structured_ilu_apply {tag}: {pc.nrows} rows, {pc.num_levels} levels, "
              f"max abs diff vs plain sweep {abs_err:.3e} (bound 0)")
        check(abs_err == 0.0, f"structured_ilu_apply {tag} vs plain sweep")
        geo = pc.last_geometry
        ms = time_ms(lambda: pc.launch(r), repeats=20)
        print(f"  structured_ilu_apply {tag}: widest level {pc.max_level_rows} rows, {geo.stages} stages, "
              f"z in shared memory: {geo.z_smem}, {geo.bytes} B dynamic, {ms:.4f} ms, "
              f"{ms * 1e3 / (2 * pc.num_levels):.3f} us/level")
        results[f"structured_ilu_apply@{tag}"] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
            bound=bound(ilu_bytes(pc) + 2 * 8 * pc.nrows, ilu_apply_flops(pc)), shape=tag,
        )
    results["structured_ilu_apply"] = results["structured_ilu_apply@monolithic 2D N=128"]

    def drive(cases):
        """Solve each case with every launch counter reset just before the
        phase; returns (setups, solutions, per-case launches, walls, phase
        launches)."""
        setups = [problem(c[0], c[1], dev) for c in cases]
        torch.cuda.synchronize()
        _cuda.KERNEL_LAUNCHES.clear()
        sols, counts, walls = [], [], []
        for (W, params, bcs, _, _), case in zip(setups, cases):
            before = dict(_cuda.KERNEL_LAUNCHES)
            t0 = time.perf_counter()
            sols.append(solve_dpp(W, params, bcs, solver_parameters=PRESETS[case[2]]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append({k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items()
                           if v != before.get(k, 0)})
        return setups, sols, counts, walls, dict(_cuda.KERNEL_LAUNCHES)

    print(f"[{time.perf_counter() - t_start:.1f} s] kernels checked against their twins")

    # -- 4. the direct path, counted --------------------------------------
    # element, N, preset, route: K2 or K3 once a solve; "cg": the lumped
    # fast-diag PCG on the host with one K1 matvec an iteration (tri N=151,
    # the first triangle mesh past K3's gate); "mixed": past K2's plan, the
    # mixed-precision solver with K1 residuals (64^3/128^3 hex). tet nx=16
    # and 32 run K3 on a thread block cluster (2 and 16 blocks)
    cases = [("quad", 4, "LINEAR_SOLVER_PARAMS", K2), ("quad", 16, "LINEAR_SOLVER_PARAMS", K2),
             ("tet", 4, "LINEAR_SOLVER_PARAMS", K3), ("tet", 16, "LINEAR_SOLVER_PARAMS", K3),
             ("tet", 32, "LINEAR_SOLVER_PARAMS", K3), ("triangle", 151, "LINEAR_SOLVER_PARAMS", "cg"),
             ("hex", 64, "TPU_DIRECT_PARAMS", "mixed"), ("hex", 128, "TPU_DIRECT_PARAMS", "mixed")]
    setups, sols, per_case, _, launches = drive(cases)
    print(f"direct-path kernel launches, all cases: {launches}")
    for name in DIRECT_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} launched on the direct path")

    for (element, n, preset, route), (W, params, bcs, p1e, p2e), sol, counts in zip(
        cases, setups, sols, per_case
    ):
        z1, z2 = sol.solution.data
        check(sol.iteration_number == 1 and sol.residual_error == 0.0, "preonly reports 1 / 0.0")
        if route in (K2, K3):
            check(counts.get(route) == 1, f"{element} N={n} {preset} ran {route} once")
        else:  # no fused direct kernel; K1 for the lift and each matvec or residual
            check(counts.get(K2, 0) == counts.get(K3, 0) == 0 and counts.get("fused_dpp_apply", 0) > 1,
                  f"{element} N={n} {preset} took the {route} route")
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
        line = (f"solve_dpp {element} N={n} {preset}: launches {counts} "
                f"(K1: {counts.get('fused_dpp_apply', 0)} a solve), f64 rel residual {rres:.3e}")
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
            ref = solve_dpp(Wc, pc, bcc, solver_parameters=PRESETS[preset]).solution.data
            cpu_diff = max(rel(a.cpu(), r) for a, r in zip((z1, z2), ref))
            line += f", vs CPU twin path {cpu_diff:.3e}"
            check(cpu_diff < 1e-10, f"{element} N={n} vs CPU")
        print(line)
    torch.cuda.synchronize()

    print(f"[{time.perf_counter() - t_start:.1f} s] direct path done")

    # -- 5/6. the Krylov and preconditioned paths, counted ----------------
    def check_krylov(title, kcases, kernels):
        ksetups, ksols, kcounts, kwall, phase = drive(kcases)
        print(f"{title} kernel launches, all cases: {phase}")
        for name in kernels:
            check(phase.get(name, 0) > 0, f"{name} launched on the {title}")
        for (element, n, preset, count, slack, kernel), (W, params, bcs, _, _), sol, counts, wall in zip(
            kcases, ksetups, ksols, kcounts, kwall
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
            # preconditioned presets stop on the preconditioned norm
            bound_r = 1e-7 if preset == "PLAIN_GMRES_PARAMS" else 1e-5
            expected = "no published count" if count is None else f"expected {count}" + (f" +-{slack}" if slack else "")
            line = (f"solve_dpp {element} N={n} {preset}: iterations {its} ({expected}), "
                    f"launches {counts}, wall {wall * 1e3:.2f} ms "
                    f"({wall * 1e6 / max(its, 1):.2f} us/iteration), |b - A x| / |r0| {rres:.3e}")
            if preset not in ("PLAIN_GMRES_PARAMS", "GMRES_JACOBI_PARAMS"):
                # the wall above includes the host set-up (ILU factor,
                # eigenbases); a second solve reuses the cached solver
                solver = _build_linear_solver(W, params, _freeze(PRESETS[preset]))
                t0 = time.perf_counter()
                solver(g1, g2)
                torch.cuda.synchronize()
                solve = time.perf_counter() - t0
                line += f", cached solve {solve * 1e3:.2f} ms ({solve * 1e6 / max(its, 1):.2f} us/iteration)"
            check(its < sp.GMRES_PARAMS["ksp_max_it"] if count is None else abs(its - count) <= slack,
                  f"{element} N={n} {preset} count")
            check(rres < bound_r, f"{element} N={n} {preset} residual")
            if n <= 16:
                Wc, pc, bcc, _, _ = problem(element, n, "cpu")
                ref = solve_dpp(Wc, pc, bcc, solver_parameters=PRESETS[preset])
                cpu_diff = max(rel(a.cpu(), r) for a, r in zip((z1, z2), ref.solution.data))
                line += f", vs CPU twin path {cpu_diff:.3e} ({ref.iteration_number} iterations)"
                # the inputs differ by K1's rounding of the lift; the solve
                # amplifies that in plain GMRES's stagnation tail
                check(ref.iteration_number == its and cpu_diff < 1e-8, f"{element} N={n} {preset} vs CPU")
            print(line)
        torch.cuda.synchronize()
        print(f"[{time.perf_counter() - t_start:.1f} s] {title} done")
        return phase

    launches.update({k: v for k, v in check_krylov("Krylov path", KRYLOV_CASES, KRYLOV_KERNELS).items()
                     if k in KRYLOV_KERNELS})
    launches.update({k: v for k, v in check_krylov("preconditioned path", PRECOND_CASES, PRECOND_KERNELS).items()
                     if k in PRECOND_KERNELS})

    # -- 7. the Picard path ------------------------------------------------
    from perphil_tpu_torch.ops.fused_ngs import FusedNGSSolver, ngs_host_loop
    from perphil_tpu_torch.ops.ilu import GaussSeidelSweeper
    from perphil_tpu_torch.solvers import solve_dpp_nonlinear

    picard = sp.PICARD_LU_SOLVER_PARAMS
    snes_kw = dict(rtol=picard["snes_rtol"], atol=picard["snes_atol"], max_it=picard["snes_max_it"])
    # fused_ngs against its twin (not counted), bit for bit, at N=16/64 and
    # the published column's largest mesh, and at the plan's last published
    # size N=255 with both capped at NGS_CAP_255 iterations; the twin timed
    # in its check run
    ngs_solvers = {}
    for n in (16, 64, 128, 255):
        W, params, bcs, _, _ = problem("quad", n, dev)
        op = DPPOperator(W, params)
        b, x0 = picard_inputs(op, bcs)
        solver = FusedNGSSolver(op, **{**snes_kw, **({"max_it": NGS_CAP_255} if n == 255 else {})})
        got = solver.launch(b, x0)
        torch.cuda.synchronize()
        ref, plain_ms = timed_once(lambda: solver.plain(b, x0))
        abs_err = float((got.x - ref.x).abs().max())
        count = NGS_CAP_255 if n == 255 else PICARD_COUNTS[n]
        print(f"fused_ngs quad N={n}: {solver.plan}, iterations {got.iterations} vs twin {ref.iterations} "
              + (f"(capped at {count})" if n == 255 else f"(published {count})")
              + f", fn {got.residual_norm!r} vs twin {ref.residual_norm!r}, f0 {got.initial_norm!r} vs twin "
              f"{ref.initial_norm!r}, x bit-equal {torch.equal(got.x, ref.x)}, max abs diff {abs_err:.3e}; "
              f"twin {plain_ms:.1f} ms")
        check(got.iterations == ref.iterations == count, f"fused_ngs N={n} count")
        check(torch.equal(got.x, ref.x) and got.residual_norm == ref.residual_norm
              and got.initial_norm == ref.initial_norm, f"fused_ngs N={n} bit for bit with its twin")
        if n != 255:
            ngs_solvers[n] = (op, b, x0, solver)
        if n == 128:
            ms = time_ms(lambda: solver.launch(b, x0), repeats=5, warmup=1)
            phases = got.iterations * (solver.sweeper.ncolors + 1)
            results["fused_ngs"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound=bound(*fused_ngs_work(solver, got.iterations)),
                shape=f"quad 128^2, {got.iterations} iterations, {solver.plan.blocks} blocks, "
                      f"{solver.sweeper.ncolors} colours",
            )
            print(f"  fused_ngs quad N=128: {ms:.3f} ms (CUDA events, median of 5), "
                  f"{ms * 1e3 / got.iterations:.3f} us/iteration, {ms * 1e3 / phases:.4f} us/phase "
                  f"({solver.sweeper.ncolors} colours and the norm an iteration)")
    # the host loop (the route beyond the kernel's plan) against the kernel,
    # in turns host, kernel, kernel, host (host clock around a call and a
    # synchronise)
    for n in (64, 128):
        if n not in ngs_solvers:
            W, params, bcs, _, _ = problem("quad", n, dev)
            op = DPPOperator(W, params)
            ngs_solvers[n] = (op, *picard_inputs(op, bcs), FusedNGSSolver(op, **snes_kw))
        op, b, x0, solver = ngs_solvers[n]
        walls, counts = {"host loop": [], "kernel": []}, {}
        for side in ("host loop", "kernel", "kernel", "host loop"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ngs_host_loop(op, solver.sweeper, b, x0, **snes_kw) if side == "host loop" else solver.launch(b, x0)
            torch.cuda.synchronize()
            walls[side].append((time.perf_counter() - t0) * 1e3)
            counts[side] = res.iterations
        print(f"NGS quad N={n}: host loop {counts['host loop']} iterations, "
              f"{' / '.join(f'{w:.1f}' for w in walls['host loop'])} ms; kernel {counts['kernel']} iterations, "
              f"{' / '.join(f'{w:.2f}' for w in walls['kernel'])} ms (host clock, in turns)")
        check(counts["kernel"] == PICARD_COUNTS[n], f"fused_ngs N={n} count")
        # K1 sums in another order than the kernel: a knife edge may move the host loop's count
        check(abs(counts["host loop"] - counts["kernel"]) <= 2, f"NGS host loop N={n} count")
    # the ILU sweep's Gauss-Seidel mode against its twin, bit for bit, on the
    # lexicographic ngs meshes the path below drives
    for element, n in (("triangle", 16), ("tet", 4)):
        W, params, _, _, _ = problem(element, n, dev)
        swp = GaussSeidelSweeper.for_monolithic(W.mesh, params)
        x, bb = randn(swp.nrows), randn(swp.nrows)
        z = swp.launch(x, bb)
        torch.cuda.synchronize()
        zp, plain_ms = timed_once(lambda: swp.plain(x, bb))
        abs_err = float((z - zp).abs().max())
        geo = swp.last_geometry
        ms = time_ms(lambda: swp.launch(x, bb), repeats=20)
        print(f"structured_ilu_apply[gs] {element} N={n}: {swp.nrows} rows, {swp.num_levels} levels, widest "
              f"{swp.max_level_rows}, {geo.stages} stages, z in shared memory: {geo.z_smem}, max abs diff vs "
              f"plain sweep {abs_err:.3e} (bound 0), {ms:.4f} ms, {ms * 1e3 / swp.num_levels:.3f} us/level")
        check(abs_err == 0.0, f"structured_ilu_apply[gs] {element} N={n} vs plain sweep")
        if element == "triangle":
            noffs = len(swp.deltas)
            results["structured_ilu_apply[gs]"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound=bound(8 * swp.nrows * (noffs + 3) + 4 * (swp.num_levels + 1 + swp.nrows),
                            swp.nrows * (2 * (noffs - 1) + 1)),
                shape=f"tri 16^2 monolithic, {swp.num_levels} levels",
            )
    print(f"[{time.perf_counter() - t_start:.1f} s] Picard kernels checked against their twins")

    # the path, counted: every launch counter reset just before
    psetups = [problem(c[0], c[1], dev) for c in PICARD_CASES]
    f0s = []
    for (W, params, bcs, _, _) in psetups:
        op = DPPOperator(W, params)
        b, x0 = picard_inputs(op, bcs)
        f0s.append(float(_norm(b - op.stacked_matvec()(x0))))
    torch.cuda.synchronize()
    _cuda.KERNEL_LAUNCHES.clear()
    psols, pcounts, pwalls = [], [], []
    for (W, params, bcs, _, _), case in zip(psetups, PICARD_CASES):
        before = dict(_cuda.KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        psols.append(solve_dpp_nonlinear(W, params, bcs, solver_parameters=PRESETS[case[2]]))
        torch.cuda.synchronize()
        pwalls.append(time.perf_counter() - t0)
        pcounts.append({k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items() if v != before.get(k, 0)})
    phase = dict(_cuda.KERNEL_LAUNCHES)
    print(f"Picard path kernel launches, all cases: {phase}")
    for name in PICARD_KERNELS:
        check(phase.get(name, 0) > 0, f"{name} launched on the Picard path")
    launches.update({k: v for k, v in phase.items() if k in PICARD_KERNELS})
    for (element, n, preset, count, kernel), (W, params, bcs, _, _), sol, counts, wall, f0 in zip(
        PICARD_CASES, psetups, psols, pcounts, pwalls, f0s
    ):
        z1, z2 = sol.solution.data
        its, fn = sol.iteration_number, sol.residual_error
        check(bool(torch.isfinite(z1).all() and torch.isfinite(z2).all()), "finite solution")
        check(z1.device == dev and tuple(z1.shape) == W.mesh.node_shape, "solution on the card")
        check(counts.get(kernel, 0) > 0, f"{element} N={n} {preset} ran {kernel}")
        opts = PRESETS[preset]
        tol = max(opts.get("snes_rtol", 1e-8) * f0, opts.get("snes_atol", 1e-50))
        line = (f"solve_dpp_nonlinear {element} N={n} {preset}: iterations {its}"
                + ("" if count is None else f" (expected {count})")
                + f", fn {fn!r} (f0 {f0!r}, tol {tol!r}), launches {counts}, wall {wall * 1e3:.2f} ms "
                f"({wall * 1e6 / max(its, 1):.2f} us/iteration)")
        if kernel == "fused_ngs":
            check(counts.get(kernel) == 1, f"{element} N={n} ran fused_ngs once")
            # the cached solve: the lift (one K1) and the kernel
            solver = _build_nonlinear_solver(W, params, _freeze(PRESETS[preset]))
            g1, g2 = (bc.grid_values(W.mesh) for bc in bcs)
            t0 = time.perf_counter()
            solver(g1, g2)
            torch.cuda.synchronize()
            line += f", cached solve {(time.perf_counter() - t0) * 1e3:.2f} ms"
        if kernel == "structured_ilu_apply[gs]":
            check(counts.get(kernel) == its, f"{element} N={n}: one GS-mode launch an iteration")
        if preset != "KSP_PREONLY_PARAMS":
            check(fn <= tol, f"{element} N={n} {preset}: fn <= max(rtol f0, atol)")
        if count is not None:
            check(its == count, f"{element} N={n} {preset} count")
        if n <= 16:
            Wc, pc, bcc, _, _ = problem(element, n, "cpu")
            ref = solve_dpp_nonlinear(Wc, pc, bcc, solver_parameters=PRESETS[preset])
            cpu_diff = max(rel(a.cpu(), r) for a, r in zip((z1, z2), ref.solution.data))
            line += f", vs CPU twin path {cpu_diff:.3e} ({ref.iteration_number} iterations)"
            check(ref.iteration_number == its and cpu_diff < 1e-8, f"{element} N={n} {preset} vs CPU")
        print(line)
    torch.cuda.synchronize()
    print(f"[{time.perf_counter() - t_start:.1f} s] Picard path done")

    # -- 8. the ordering-parity ILU path ------------------------------------
    launches.update(parity_path(dev, smi, randn, results, t_start))

    # -- 9. the parallel-prefix trisolves ----------------------------------
    partri_path(dev, smi, randn, t_start)

    # -- 10. the conditioning analysis --------------------------------------
    conditioning_path(dev, smi, t_start)

    # -- 11. end-to-end solve times, the kernel table ---------------------
    for (element, n, preset, route), (W, params, bcs, _, _) in zip(cases, setups):
        solver = _build_linear_solver(W, params, _freeze(PRESETS[preset]))
        g1, g2 = (bc.grid_values(W.mesh) for bc in bcs)
        if route == "mixed":
            ms = time_ms(lambda: solver(g1, g2), repeats=10)
            print(f"hex {n}^3 {preset}: lift + direct solve median {ms:.4f} ms (CUDA events, 10 runs) on {smi}")
        elif (element, n) in (("quad", 16), ("tet", 4)):  # the cached solve on K2 / K3
            walls = []
            for _ in range(11):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solver(g1, g2)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            print(f"solve_dpp {element} N={n} {preset}: cached solve (lift + K{2 if element == 'quad' else 3}) "
                  f"median {statistics.median(walls[1:]):.4f} ms (host clock, 10 runs) on {smi}")
    for name, r in results.items():
        if "@" in name or name not in KERNELS:
            print(f"{name.split('@')[0]} [{r['shape']}]: kernel {r['ms']:.4f} ms"
                  + (f" (call {r['call_ms']:.4f} ms)" if r.get("call_ms") else "") + ", "
                  f"plain twin {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms ({r['bound'][1]})"
                  + (f", library call {r['library_ms']:.4f} ms" if r.get("library_ms") else "")
                  + f" (CUDA events) on {smi}")
    print(f"[{time.perf_counter() - t_start:.1f} s] done")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound"][0], "bound_by": results[name]["bound"][1],
         "library_ms": results[name].get("library_ms")}
        for name in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
