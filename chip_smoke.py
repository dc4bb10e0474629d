#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``perphil_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

  1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA
     versions, and switches TF32 off for f32 products (TF32 would stall the
     mixed-precision refinement);
  2. builds the CUDA kernels K1-K8, ``structured_ilu_apply``, ``fused_ngs``,
     ``fused_gs``, ``band_trisolve`` and ``ngs_colour_halo`` from
     ``perphil_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel) and
     ``fused_gs``'s probe build beside them, while ``fused_gs``'s twins run
     on the host's cores and the fused GMRES roles' long twins on the card
     (all collected before anything is timed), and
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
     K7 (2D N=64/128/256), K6 (2D N=64, tet nx=8/32), K8 (2D N=16/64
     with its literal inner GMRES + ILU blocks and at N=128 on its first
     outer step, N=64 also with the TPU's PCG blocks, its 2D field sweeps on
     the line pipeline of ceil(ny / 32) warps; tet nx=8 on the ring), equal
     counts and bits, K8's inner counts too (K6 within 1e-10; the twin on the first 20 steps
     at 2D N=256 ILU; the long twins run on the card in worker processes
     while nvcc builds, ``role_twin_remote``, and are collected before
     anything is timed);
     K8's two inner modes timed in turns at 2D N=16/64/128 with the ring
     kernel it replaced (``k8_turns``: the probe build
     ``csrc/profile/fused_gmres_k8_ring.cu``, built beside the package, bit
     for bit with the package's K8), at N=128 in turns with the literal host
     route (fields within 1e-12);
     with the blocks, the leaves a thread, what lived in shared memory, the
     time and the time per iteration, and beside the sizes the TPU's gate
     sent to the host loop, that loop's time;
     ``structured_ilu_apply`` at 2D N=128
     (monolithic, beside the cuSPARSE pair on its factor) and on a 129^2
     field system, bit-equal;
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
     N=64 and N=128 in turns (host clock); ``fused_gs`` against its twin
     (x, the count and both norms bit for bit) in full solves at tri
     N=16/64, tet nx=4/16 and hex nx=8 and capped at ``GS_CAP`` iterations at
     tri N=128 and tet nx=34 (the plan's largest tet), each placement
     printed (the twins run on the host's cores, ``gs_twin``, during the
     build; at tri N=16 and tet nx=4 also on the card, with the same bits),
     and ``GS_REPEATS`` launches on every placement the plan allows, each
     held to the twin; its time at tri N=64 (µs an iteration and a level),
     its empty level and latency floor (its probe build,
     ``fused_gs.probe_library``, built beside the package), and the host
     route (GS-mode sweep, K1, a norm read back) against it in turns at tri
     N=16/64 and tet nx=16;
     then, counted, ``solve_dpp_nonlinear`` with ``PICARD_LU_SOLVER_PARAMS``
     at 2D N=4/8/16/32/64/128, held to the published
     16/63/194/635/1673/5135 with ``fn <= max(rtol f0, atol)`` and one
     ``fused_ngs`` launch a solve, the lexicographic ngs at tri N=16/64 and
     tet nx=4/16 (one ``fused_gs`` launch a solve) and at tri N=256, past
     ``fused_gs``'s plan, capped at 20 iterations (the host route: one
     GS-mode launch an iteration), and ``block_gs``,
     ``RICHARDSON_SOLVER_PARAMS`` and ``KSP_PREONLY_PARAMS`` at N=16, each
     against the CPU twin path where N <= 16;
  8. drives the ordering-parity ILU path (``parity_path``) — first
     ``band_trisolve`` at tet nx=4/16/24/40 on the plan's placement, bit for
     bit against its twin and the host engine's sequential apply, timed with
     CUDA events beside the twin, its bound and the cuSPARSE pair
     (``torch.triangular_solve`` on the factor's sparse triangles), each
     build's device memory against ``band_plan``; then, counted,
     ``solve_dpp`` with ``GMRES_ILU_PARAMS`` +
     ``pc_factor_mat_ordering_type: rcm`` on the device engine at tet
     nx=4/8/12/16/20/24/32/36/40, held to the published
     6/8/12/15/17/20/26/29/33 exactly with one ``band_trisolve`` launch an
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
     option left open (the wavefront on the card: one ``fused_gs`` launch a
     solve) and on the CPU, with equal counts; partri's grouped 2D pass
     (``partri_group``) against the tree at 2D N=64/128/256 (G = 8/16/32,
     1e-12), issued and from a CUDA graph in turns, and in the counted host
     GMRES loop with ``partri_group=16`` landing 74/117 too;
 10. drives the conditioning analysis (``conditioning_path``) —
     ``estimate_condition_numbers`` with Lanczos on the card at 2D
     N=16/32/64 and hex N=6/8/10/12/14/16, the dense host SVD at hex N=4,
     each against the published CSV (1e-8 at N=16/32 and hex N=6/10..16,
     1e-5 at N=64, 1e-10 at hex N=4/8), and tet
     nx=4's Lanczos κ (the monolithic inverse through K3, counted) against
     the dense SVD;
 11. times each kernel and its twin, and the 64^3/128^3 solves, with CUDA
     events, and the cached direct solves at 2D N=16 and tet nx=4 (K2, K3)
     with the host clock, and works out each kernel's bound from this run's
     shapes and iteration counts;
 12. drives the h-convergence study (``convergence_path``) through the
     study's entry points on the card: the published 2D table
     (``convergence_2d.run_one`` with ``params_for``, quad N=4..128 x the
     five approaches, 30 rows, counted: K2, K4, K6, K7 and K8 must launch)
     against ``convergence.csv`` (``it`` exact, +-2 for GMRES and GMRES+ILU
     at N=128; errors within 1.5e-10, plain GMRES within 1e-8) and its EOC
     against ``convergence_eoc.csv`` (1e-8); where the card's plain GMRES at
     N=16 first leaves the CPU's, stage by stage (``plain_gmres_stages``);
     the study scripts' ``main`` (2D at N=4/8,
     degree 1 and 2, and 3D at hex N=4/8, into a temporary directory);
     ``convergence_3d.run_one_3d`` at hex
     N=8/16/32 with both default solvers (N=8 against the CPU's rows, the
     EOC in the JAX package's test bounds); Q2/Q3 at N=4/8/16 against
     ``convergence_qp.csv`` and Q2 GMRES with jacobi and the fieldsplit
     against the direct solve; P2 at tri N=8/16/32, the host ``splu`` stage
     against GMRES+jacobi, L2 EOC near 3; the Darcy velocity and the
     midline slice at N=16 (against the CPU) and N=128. Each row's wall and
     cached solve time is printed beside the card's name and power limit;
     nothing is written;
 13. drives the profiling studies (``profiling_path``) through their entry
     points on the card, counted: the 2D table (``run_perf_once``, events
     backend) at quad N=4..128 x the six approaches (repeats 2) and N=256 x
     the five linear ones (repeats 1; plain GMRES without its warm-up solve),
     each row's ``iterations`` against ``petsc_perf_breakdown.csv`` (the
     Picard column from ``-with-picard.csv``; +-2 for GMRES and GMRES + ILU at
     N >= 128), its backend ``events`` and ``time_total > 0``, the CSV's
     header the committed one, K1, K2, K4-K8, ``fused_ngs`` and
     ``structured_ilu_apply`` launched; the 3D table (``run_perf_once_3d``)
     at tet nx=4/8/16/24/40 x the five linear approaches with the
     ordering-parity ILU on the band engine (``petsc_perf_breakdown_3d.csv``
     exactly, ``band_trisolve`` launched) and the envelope ILU
     (``_envelope_ilu.csv``); one ``trace`` row (2D N=64 GMRES + ILU, device
     time from ``torch.profiler``); the chunked drivers at N=64 against the
     one-call solves (3307 in two K4 launches, fields within 1e-12; 1673 in
     four ``fused_ngs`` launches, bit for bit); the ordering study at small
     sizes against ``ordering_sensitivity.csv`` / ``ngs_coloring.csv``; K1
     at 128^3 on the card's roofline (``utils/roofline.py``) and its chained
     marginal at 64^3 (``utils/marginal.py``). A row that raises or falls
     down the backend waterfall fails the phase. The kernel line's launches
     add the profiling tables' to the main paths'.
 14. drives the multi-device path (``multidevice_path``) — K1's halo form
     (``fused_dpp_apply_halo_planes``: the owned block and the planes its
     neighbours sent, read where they lie) over a world of one rank's block
     (edge ghosts), 2, 4 and 8 loopback slabs and (2, 2) / (4, 2) pencils of
     128^3 hex (phantom-padded to divisibility) and 2D N=1023, matvec and
     lift, f64, bit for bit with K1 on the whole grid, and with no ghost
     K1's bits in both entries; its times in turns with the first halo form
     (the probe ``csrc/profile/dpp_apply_halo_box.cu``, built beside the
     package): one 17-plane slab, the 8 slabs, the padded 136 x 129 x 129
     box and the whole 129^3 box beside K1, 2D N=1023 in 8 slabs, each
     beside its bound (the owned block in and out, the received planes in),
     its twin and ``conv3d``; the colour step of the sharded Picard solve
     (``ngs_colour_halo``) over 1, 2, 4 and 8 loopback slabs of 2D N=128
     (phantom-padded), a sweep of every colour and the residual mode bit for
     bit with its twin, with its time a colour step (launches queued) and
     the twin's, and the norm (``ngs_colour_norm``: its residuals and norm
     bit for bit with the twin and with the first norm kernel, the probe
     ``csrc/profile/ngs_colour_norm_first.cu`` built beside the package, on
     every layout, timed in turns with it beside its bound); the blocked
     fast-diag (f64) and mixed-precision direct solves over loopback slabs
     (2, 4, 8) and (2, 2) pencils of 128^3 hex (``TPU_DIRECT_PARAMS``'
     solver at full width) against the whole-grid
     solves (1e-12, f64 relative residual < 1e-10), with the all-to-all
     moves' time; the degree-p parts on blocks (``degree_p_blocks``): Q2 2D
     N=128 direct and fieldsplit GMRES, Q2 hex N=32 direct and fieldsplit,
     P2 tri N=64 Jacobi GMRES (rtol 1e-8) with every part on loopback (4,)
     slabs and (2, 2) pencils of the phantom-padded lattice, each held to
     the whole-grid solve (equal counts, fields 1e-12; the P2 matvec and
     lift bit for bit, the Qp ones 1e-13), with the collectives of one
     application of each part and both routes' walls in turns; then,
     counted, on a world of one NCCL rank (``init_process_group("nccl")``
     on a free port), the six paths of the JAX multichip dry run
     (``tools/dryrun.py``) held to the single-device solves on the card
     and to ``MULTICHIP_r05.json``'s counts (38/6/4/1/49/4): through
     ``sharded_solve_dpp``, which on a world of one runs the single-device
     solve (``linear_on_one_rank_whole``; no collective), and the linear
     ones on the blocked route too (``blocked_solve_dpp``: one all-gather),
     the halo matvec to K1 on the gathered vector (0), one
     ``stacked_halo_apply`` at 64^3 and 128^3 in turns with the first
     form's apply (the block extended whole, then the probe; device time
     and host wall), and ``sharded_solve_dpp`` /
     ``sharded_solve_dpp_nonlinear`` at full width: 128^3 hex
     ``TPU_DIRECT_PARAMS`` (f64 relative residual < 1e-10), 2D N=64
     ``PLAIN_GMRES_PARAMS`` (exactly 3307), SS-GMRES at 2D N=64 (4),
     ``PICARD_LU_SOLVER_PARAMS`` at 2D N=64 and N=128 (exactly 1673 and
     5135), each wall beside the single-device solve's, with no collective
     (the world of one's routes), and the three linear ones' two routes in
     turns (blocked, whole, blocked, whole), the single-device route the
     faster; ``fused_dpp_apply_halo``, ``structured_ilu_apply`` (the
     gathered ILU on the blocked route) and ``ngs_colour_halo`` must
     launch, K2 once for the world of one's direct path at hex N=7 and
     ``fused_ngs`` once a world-of-one Picard solve; then
     ``run_scaling`` (strong, one rank, 2D N=64, both default approaches)
     in a world of its own, its rows printed.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises, so
the exit code is non-zero and no result line is printed. Without a CUDA
device the script exits non-zero at once.
"""

from __future__ import annotations

import collections
import json
import math
import os
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
    # the JAX package's lexicographic ngs while-loop and its GS sweep (XLA, no Pallas)
    "fused_gs": (_CSRC + "fused_gs.cu", "perphil_tpu/solvers/solver.py:1871-1911, perphil_tpu/ops/ilu.py:840"),
}
PARITY_KERNELS = {
    # the JAX package's band trisolve is a lax.scan of dense matvecs (XLA, no Pallas)
    "band_trisolve": (_CSRC + "band_trisolve.cu", "perphil_tpu/ops/bandsolve.py:164"),
}
MULTIDEVICE_KERNELS = {
    # K1's halo form: the explicit-halo stencil of the JAX package's
    # shard_map matvec (XLA inside shard_map, no Pallas)
    "fused_dpp_apply_halo": (_CSRC + "dpp_apply.cu", "perphil_tpu/parallel/halo.py:52"),
    # the colour step of the sharded Picard solve: the JAX package's colour
    # sweep, which its partitioner runs on every device (XLA, no Pallas)
    "ngs_colour_halo": (_CSRC + "ngs_colour_halo.cu", "perphil_tpu/ops/ilu.py:924"),
    # its norm and stop test: the ngs while-loop's cond and norm (XLA, no
    # Pallas); counted once a call, which issues two launches (the rows
    # stage, then the tree and the tail)
    "ngs_colour_norm": (_CSRC + "ngs_colour_halo.cu", "perphil_tpu/solvers/solver.py:1872-1879"),
}
KERNELS = {**DIRECT_KERNELS, **KRYLOV_KERNELS, **PRECOND_KERNELS, **PICARD_KERNELS, **PARITY_KERNELS,
           **MULTIDEVICE_KERNELS}
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
    ("triangle", 16, "PICARD_LU_SOLVER_PARAMS", None, "fused_gs"),
    ("tet", 4, "PICARD_LU_SOLVER_PARAMS", None, "fused_gs"),
    ("triangle", 64, "PICARD_LU_SOLVER_PARAMS", None, "fused_gs"),
    ("tet", 16, "PICARD_LU_SOLVER_PARAMS", None, "fused_gs"),
    # past fused_gs's plan (132,098 rows: the slabs leave the shared memory):
    # the host route, capped
    ("triangle", 256, "PICARD_LU_CAP20", None, "structured_ilu_apply[gs]"),
    ("quad", 16, "BLOCK_GS", None, "fused_dpp_apply"),
    ("quad", 16, "RICHARDSON_SOLVER_PARAMS", None, "fused_dpp_apply"),
    ("quad", 16, "KSP_PREONLY_PARAMS", 1, "fused_gmres_df[fieldsplit_lu]"),
]

# the ordering-parity ILU's column (pc_factor_mat_ordering_type=rcm, "GMRES +
# ILU PC", ordering rcm-parity): petsc_perf_breakdown_3d.csv, tet nx=4..40
# fused_gs against its twin: (element, N, iteration cap; None: the full
# solve). The twins run on the host's cores in GS_WORKERS worker processes
# beside the build's nvcc, stopped before anything is timed (gs_twin): a twin is ~6,400 small torch ops an
# iteration at tri N=64, and its bits do not depend on the device (each
# product, difference and quotient rounded on its own, the halving tree, a
# correctly rounded square root: fused_ngs.picard_norm); the kernel gets the
# inputs the twin had. Longest first.
GS_CAP = 100
GS_TWIN_CASES = [("triangle", 64, None), ("tet", 16, None), ("tet", 34, GS_CAP), ("triangle", 128, GS_CAP),
                 ("hex", 8, None), ("triangle", 16, None), ("tet", 4, None)]
GS_CARD_TWINS = (("triangle", 16), ("tet", 4))  # the twin on the card too: the same bits
GS_TABLE_CASE = ("triangle", 64)  # the kernel line's shape
GS_TURNS = (("triangle", 16), ("triangle", 64), ("tet", 16))  # the host route against the kernel
GS_WORKERS = 3
GS_REPEATS = 5  # launches of each placement the plan allows, each held to the twin
_GS_POOL = None
TWIN_WORKERS = 3  # the fused GMRES roles' and fused_ngs's long twins, on the card beside the build
NGS_REMOTE_NS = (128, 64)  # fused_ngs's twins run there at these 2D N, longest first
# the twins' workers run at a lower priority (os.nice), so that they take
# the cores nvcc leaves: the build's long pole is one nvcc process
TWIN_NICENESS = 10
# the host loop beside a fused GMRES role that the TPU's gate left to it is
# timed over this many iterations at most (its time an iteration)
HOST_LOOP_CAP = 1500
_TWIN_POOL = None

PARITY_COUNTS = {4: 6, 8: 8, 12: 12, 16: 15, 20: 17, 24: 20, 32: 26, 36: 29, 40: 33}
PARITY_HOST_SIZES = (4, 40)  # the host engine, in turns with the device engine
PARITY_KERNEL_SIZES = (4, 16, 24, 40)  # band_trisolve against its twin and the host engine
PARITY_TABLE_SIZE = 40  # the kernel line's shape: the largest published mesh

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
        "PICARD_LU_CAP20": {**sp.PICARD_LU_SOLVER_PARAMS, "snes_max_it": 20},
        "BLOCK_GS": {**sp.PICARD_LU_SOLVER_PARAMS, "snes_type": "block_gs"},
        "RICHARDSON_SOLVER_PARAMS": sp.RICHARDSON_SOLVER_PARAMS,
        "KSP_PREONLY_PARAMS": sp.KSP_PREONLY_PARAMS,
        "GMRES_ILU_RCM": {**sp.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm"},
        "GMRES_ILU_RCM_HOST": {**sp.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm",
                               "pc_band_execution": "host"},
        # the host routes' ILU and GS on the parallel-prefix trisolves (left open: the wavefront on the card)
        "GMRES_ILU_PARTRI": {**sp.GMRES_ILU_PARAMS, "trisolve_backend": "partri"},
        "GMRES_ILU_PARTRI_GROUPED": {**sp.GMRES_ILU_PARAMS, "trisolve_backend": "partri", "partri_group": 16},
        "PICARD_LU_PARTRI": {**sp.PICARD_LU_SOLVER_PARAMS, "trisolve_backend": "partri"},
    }


def newton_rhs(op, bcs, plain: bool = False):
    """The solver's Krylov right-hand side: ``b - A x0`` with x0 the BC lift,
    by K1 or, with ``plain``, by its twin (no kernel: before the build)."""
    import torch

    from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain

    g1, g2 = (bc.grid_values(op.mesh) for bc in bcs)
    bdry = op._mask_arrays[0]
    x01, x02 = torch.where(bdry, g1, 0.0), torch.where(bdry, g2, 0.0)
    if not plain:
        b1, b2 = op.lifted_rhs(g1, g2)
        return torch.stack(op.residual(x01, x02, b1, b2)).contiguous()
    S = op._combined_stencils
    b1, b2 = fused_dpp_apply_plain(g1, g2, *S, mode="lift")
    y1, y2 = fused_dpp_apply_plain(x01, x02, *S, mode="matvec")
    return torch.stack((b1 - y1, b2 - y2)).contiguous()


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
    launch (``solver.launch_inner``: the twin applies P(b - A x0) once more).
    K8's literal inner GMRES: each solve counted as GMRES(restart) of the
    mean steps a solve, rounded down (the CGS work grows with the step, so
    by convexity that undercounts the solves' sum: a lower bound)."""
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
        field_matvec = 2 * n_int * _nnz(S1)
        restart = solver.inner_tols()[3]
        if restart:  # the literal GMRES blocks
            per_solve, _ = gmres_flops(n, inner_its // max(inner_solves, 1), restart, field_matvec + inner_pc)
            pc = applies * coupling + inner_solves * per_solve
        else:  # PCG
            pc = (
                applies * coupling
                + inner_solves * (inner_pc + 4 * n)
                + inner_its * (field_matvec + inner_pc + 12 * n)
            )
    return nbytes, core + pc


def picard_inputs(op, bcs, plain: bool = False):
    """The Picard solves' start: the lifted right-hand side b (by K1 or,
    with ``plain``, by its twin: no kernel) and the BC lift x0, stacked."""
    import torch

    from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain

    g1, g2 = (bc.grid_values(op.mesh) for bc in bcs)
    bdry = op._mask_arrays[0]
    lift = fused_dpp_apply_plain(g1, g2, *op._combined_stencils, mode="lift") if plain else op.lifted_rhs(g1, g2)
    b = torch.stack(lift).contiguous()
    return b, torch.stack([torch.where(bdry, g1, 0.0), torch.where(bdry, g2, 0.0)]).contiguous()


def ngs_twin_remote(n: int, snes_kw: dict):
    """``fused_ngs``'s twin at 2D N=n on the card in a worker process, while
    nvcc builds: the Picard inputs (the lift by K1's twin), on the host, and
    the twin's x, count, norms and time (CUDA events); the kernel is then
    launched on the same inputs. A worker launches no kernel (its process
    has no library built)."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(HERE))
    from perphil_tpu_torch.ops import _cuda
    from perphil_tpu_torch.ops.assembly import DPPOperator
    from perphil_tpu_torch.ops.fused_ngs import FusedNGSSolver

    W, params, bcs, _, _ = problem("quad", n, torch.device("cuda", torch.cuda.current_device()))
    op = DPPOperator(W, params)
    b, x0 = picard_inputs(op, bcs, plain=True)
    ref, plain_ms = timed_once(lambda: FusedNGSSolver(op, **snes_kw).plain(b, x0))
    check(_cuda._LIB is None, f"fused_ngs's twin at 2D N={n} launched no kernel")
    return (b.cpu().numpy(), x0.cpu().numpy(), ref.x.cpu().numpy(), ref.iterations, ref.residual_norm,
            ref.initial_norm, plain_ms)


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


def gs_twin(case):
    """``FusedGSSolver.plain`` on the host's CPU for one of
    ``GS_TWIN_CASES``, in a worker process: the manufactured Picard
    problem's inputs (the lift on the CPU), the twin's x, count and norms,
    and its wall time in seconds."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(HERE))
    from perphil_tpu_torch.ops.assembly import DPPOperator
    from perphil_tpu_torch.ops.fused_gs import FusedGSSolver
    from perphil_tpu_torch.solvers.parameters import PICARD_LU_SOLVER_PARAMS as picard

    element, n, cap = case
    W, params, bcs, _, _ = problem(element, n, "cpu")
    op = DPPOperator(W, params)
    b, x0 = picard_inputs(op, bcs)
    solver = FusedGSSolver(op, rtol=picard["snes_rtol"], atol=picard["snes_atol"],
                           max_it=cap or picard["snes_max_it"])
    t0 = time.perf_counter()
    res = solver.plain(b, x0)
    return (b.numpy(), x0.numpy(), res.x.numpy(), res.iterations, res.residual_norm, res.initial_norm,
            time.perf_counter() - t0)


def fused_gs_work(solver, its: int):
    """(bytes, f64 flops) of one fused GS solve of ``its`` iterations: a
    sweep row is one product and one difference an off-centre entry and a
    divide, a residual row one of each an entry; the norm a square and a sum
    a row, its = 0 included. Bytes: b and x0 read, x written, the lists (2
    bytes an entry) and the level and push tables (4 bytes) read once."""
    import numpy as np

    from perphil_tpu_torch.ops.fused_gs import gs_taps

    _, _, nc = gs_taps(solver.mesh, solver.params, solver.plan)
    interior = np.tile(~solver.mesh.boundary_mask().ravel(), 2)
    nint, nrows = int(interior.sum()), interior.size
    live = int(nc[0])  # both fields hold as many entries
    flops = its * nint * (2 * (live - 1) + 1) + (its + 1) * (nint * 2 * live + 2 * nrows)
    nbytes = 3 * 8 * nrows + 2 * solver.lists.numel() + 4 * (solver.cptr.numel() + solver.sends.numel())
    return nbytes, flops


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


def sparse_pair(lower, upper, device):
    """The library yardstick of an ILU apply: ``torch.triangular_solve`` on
    the factor's unit lower triangle (strictly lower entries, scipy) and its
    upper one as sparse CSR tensors (cuSPARSE on the card; the port never
    calls it). Returns ``b (n,) -> U^-1 L^-1 b``."""
    import warnings

    import numpy as np
    import torch

    def csr(M):
        M = M.tocsr()
        M.sort_indices()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # sparse CSR is "beta" in torch
            return torch.sparse_csr_tensor(torch.from_numpy(M.indptr.astype(np.int64)),
                                           torch.from_numpy(M.indices.astype(np.int64)),
                                           torch.from_numpy(M.data.astype(np.float64)), size=M.shape).to(device)

    Lt, Ut = csr(lower), csr(upper)

    def solve(b):
        y = torch.triangular_solve(b[:, None], Lt, upper=False, unitriangular=True).solution
        return torch.triangular_solve(y, Ut, upper=True).solution[:, 0]

    return solve


def structured_factor(pc):
    """A ``StructuredILU0``'s factor as scipy CSR ``(strictly lower,
    upper)``: entry ``factors[o, i]`` at column ``i + deltas[o]`` where that
    lies in range and the entry is stored (nonzero)."""
    import numpy as np
    import scipy.sparse as sparse

    fac = pc.factors.cpu().numpy()
    rows = np.arange(pc.nrows)
    parts = {True: [], False: []}
    for o, d in enumerate(pc.deltas):
        cols = rows + d
        ok = (cols >= 0) & (cols < pc.nrows) & (fac[o] != 0.0)
        parts[d < 0].append((fac[o][ok], rows[ok], cols[ok]))
    out = []
    for lower in (True, False):
        v, r, c = (np.concatenate(a) for a in zip(*parts[lower]))
        out.append(sparse.csr_matrix((v, (r, c)), shape=(pc.nrows, pc.nrows)))
    return tuple(out)


def parity_factor(nx: int):
    """(mesh, perm, combined ILU(0) factor, diagonal positions) of the tet
    nx parity system, factored on the host."""
    from perphil_tpu_torch.mesh import create_cube_mesh
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops import _native
    from perphil_tpu_torch.ops.ordering import parity_system

    mesh = create_cube_mesh(nx, nx, nx)
    _, perm, Ap = parity_system(mesh, DPPParameters())
    Fc, diag = _native.native_ilu0(Ap)
    return mesh, perm, Fc, diag


def parity_path(dev, smi, randn, results, t_start):
    """Phase 8, the ordering-parity ILU (``pc_factor_mat_ordering_type=rcm``):
    ``band_trisolve`` at tet nx=4/16/24/40 on the plan's placement, bit for
    bit against its twin and the host engine's sequential apply
    (``ordering.host_ilu_apply``), timed with CUDA events beside the twin,
    its bound and the cuSPARSE pair (``torch.triangular_solve`` on the
    factor's sparse triangles), each build's device memory against
    ``band_plan``; then, counted, ``solve_dpp`` on the device engine at tet
    nx=4..40 held to the published 6/8/12/15/17/20/26/29/33 with one
    ``band_trisolve`` launch an apply, K1 as the outer matvec (one an apply,
    plus the lift and the Newton-step residual) and no K7, and the host
    engine at nx=4 and 40 with the same counts, in turns with the device
    engine. Adds the kernel's entries to ``results`` and returns the phase's
    launches of its kernels."""
    import numpy as np
    import scipy.sparse as sparse
    import torch

    from perphil_tpu_torch.ops import _cuda
    from perphil_tpu_torch.ops import bandsolve as bs
    from perphil_tpu_torch.ops.assembly import DPPOperator, dpp_stencils
    from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain
    from perphil_tpu_torch.ops.ordering import host_ilu_apply
    from perphil_tpu_torch.solvers import solve_dpp
    from perphil_tpu_torch.solvers.solver import _build_linear_solver, _freeze

    PRESETS = presets()

    # band_trisolve against its twin and the host engine's apply (not
    # counted), its build within its plan, beside the cuSPARSE pair
    for nx in PARITY_KERNEL_SIZES:
        _, perm, Fc, diag = parity_factor(nx)
        t0 = time.perf_counter()
        sched = bs.level_schedule(Fc, perm)
        sched_s = time.perf_counter() - t0
        plan = bs.plan_of(sched)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        band = bs.build_band_parity_ilu(sched, dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        check(plan.factor_bytes <= peak <= plan.total_bytes, f"tet nx={nx}: the band engine's build stays within its plan")
        r = randn(Fc.shape[0])
        z = bs.level_apply(band, r)
        torch.cuda.synchronize()
        zp, plain_ms = timed_once(lambda: bs.level_apply_plain(band, r))
        rn = r.cpu().numpy()
        host = np.empty_like(rn)
        host[perm] = host_ilu_apply(Fc, diag, rn[perm])
        same_twin, same_host = bool(torch.equal(z, zp)), bool(np.array_equal(z.cpu().numpy(), host))
        abs_err = float((z - zp).abs().max())
        ms = time_ms(lambda: bs.level_apply(band, r), repeats=20)
        nbytes, flops = bs.traffic(sched)
        kbound = bound(nbytes, flops)
        lib = sparse_pair(sparse.tril(Fc, -1), sparse.triu(Fc), dev)
        rp = r[torch.from_numpy(perm).to(dev)]
        lib_err = rel(lib(rp), z[torch.from_numpy(perm).to(dev)])
        check(lib_err <= 1e-12, f"tet nx={nx}: the cuSPARSE pair computes band_trisolve's apply")
        library_ms = time_ms(lambda: lib(rp), repeats=10)
        print(f"band_trisolve tet nx={nx}: {sched.n} rows, {sched.nnz} entries, levels {sched.nlev}, "
              f"{sched.blocks} block(s), vector in {'shared' if sched.shared_vector else 'device'} memory, "
              f"{sched.stages} stages of {sched.stage_bytes} B; schedule {sched_s:.2f} s (host); build peak {peak} B, "
              f"plan {plan.total_bytes} B; equal to the twin {same_twin}, to the host engine's apply {same_host}; "
              f"{ms:.4f} ms ({ms * 1e3 / sum(sched.nlev):.3f} us a level), twin {plain_ms:.4f} ms, bound "
              f"{kbound[0]:.4f} ms ({nbytes} B), cuSPARSE pair {library_ms:.4f} ms (max rel diff {lib_err:.3e}) "
              f"(CUDA events) on {smi}")
        check(same_twin and same_host, f"band_trisolve tet nx={nx}: bit for bit with its twin and the host engine")
        results[f"band_trisolve@tet{nx}"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound=kbound,
                                                library_ms=library_ms, shape=f"tet nx={nx} apply, {sched.blocks} block(s)")
        del band, lib, z, zp
    torch.cuda.synchronize()
    print(f"[{time.perf_counter() - t_start:.1f} s] band_trisolve checked against its twin and the host engine")

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
        check(counts.get("band_trisolve", 0) == applies, f"tet nx={n}: one band_trisolve launch an apply")
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
    results["band_trisolve"] = results[f"band_trisolve@tet{PARITY_TABLE_SIZE}"]
    return {k: v for k, v in phase.items() if k in PARITY_KERNELS}


PARTRI_APPLY_CASES = [("quad", 128, "monolithic"), ("quad", 256, "monolithic"), ("quad", 256, "field"),
                      ("tet", 16, "monolithic")]  # PartriILU against structured_ilu_apply
PARTRI_GS_CASES = [("triangle", 16), ("tet", 4)]  # PartriGS against structured_ilu_apply[gs]
# the published GMRES + ILU counts (petsc_perf_breakdown.csv) the host loop
# with the partri ILU lands exactly
PARTRI_GMRES_COUNTS = {128: 74, 256: 117}
# partri's grouped 2D pass (partri_group) against the tree: 2D N, rows a group
PARTRI_GROUP_CASES = [(64, 8), (128, 16), (256, 32)]
PARTRI_GROUP = 16  # the host GMRES + ILU loop's rows a group (PARTRI_GMRES_COUNTS)
PARTRI_PICARD_CASES = [("triangle", 16), ("tet", 4)]  # the lexicographic Picard on partri, then left open


def graph_replayed(fn, shape, dev):
    """``fn`` (a tensor of ``shape`` -> one of the same shape) captured in a
    CUDA graph after a warm-up on a side stream: a function that copies its
    argument in, replays the graph and returns a copy of the output."""
    import torch

    static_in = torch.zeros(shape, dtype=torch.float64, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn(static_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(static_in)

    def replay(r):
        static_in.copy_(r)
        graph.replay()
        return static_out.clone()

    return replay


def partri_group_applies(dev, smi, randn):
    """Partri's grouped 2D pass against the tree on the same factor (2D
    N=64/128/256 monolithic, G = 8/16/32 rows a group): the results within
    1e-12 relative; each apply issued op by op and replayed from a CUDA
    graph, in turns (tree, grouped, grouped, tree), with its kernels an apply
    (``torch.profiler``), the bytes of its maps and their bound."""
    import torch

    from perphil_tpu_torch.ops import ilu
    from perphil_tpu_torch.ops.partri import nbytes

    def kernels(pc, r) -> int:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            pc.apply_flat(r)
            torch.cuda.synchronize()
        return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())

    for n, G in PARTRI_GROUP_CASES:
        W, params, _, _, _ = problem("quad", n, dev)
        sys = ilu.build_monolithic_system(W.mesh, params)
        fac = ilu.ilu0_factorize(sys)
        r = randn(sys.nrows)
        pcs = {"tree": ilu.PartriILU(sys, fac, dev), "grouped": ilu.PartriILU(sys, fac, dev, group=G)}
        z = {k: pc.apply_flat(r) for k, pc in pcs.items()}
        torch.cuda.synchronize()
        err = rel(z["grouped"], z["tree"])
        check(err <= 1e-12, f"partri grouped 2D N={n} G={G} vs the tree")
        graphs = {k: graph_replayed(pc.apply_flat, r.shape, dev) for k, pc in pcs.items()}
        same = all(torch.equal(graphs[k](r), z[k]) for k in pcs)
        order = ("tree", "grouped", "grouped", "tree")
        issued = in_turns({k: (lambda pc=pc: pc.apply_flat(r)) for k, pc in pcs.items()}, order, 3, per_call=True)
        replayed = in_turns({k: (lambda g=graphs[k]: g(r)) for k in pcs}, order, 10, per_call=True)
        maps = {k: nbytes(pc) for k, pc in pcs.items()}
        bounds = {k: bound(maps[k] + 16 * sys.nrows, maps[k] / 4)[0] for k in pcs}
        count = {k: kernels(pc, r) for k, pc in pcs.items()}
        print(f"partri ILU 2D N={n} monolithic, grouped G={G} against the tree: max rel diff {err:.3e} (bound "
              f"1e-12); issued {turns_text(order, issued)} ms; CUDA graph {turns_text(order, replayed)} ms (graph "
              f"results equal to the issued: {same}); kernels an apply tree {count['tree']}, grouped "
              f"{count['grouped']} (torch.profiler); maps tree {maps['tree']} B, grouped {maps['grouped']} B; bound "
              f"tree {bounds['tree']:.4f} ms, grouped {bounds['grouped']:.4f} ms (CUDA events, medians) on {smi}")
        del graphs, pcs, z


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
    partri_group_applies(dev, smi, randn)
    print(f"[{time.perf_counter() - t_start:.1f} s] partri checked against the wavefront kernels")

    # the path, counted: the host GMRES loop and the lexicographic Picard
    # with trisolve_backend=partri
    gsetups = {n: problem("quad", n, dev) for n in PARTRI_GMRES_COUNTS}
    psetups = [problem(e, n, dev) for e, n in PARTRI_PICARD_CASES]
    kw = {k: PRESETS["GMRES_ILU_PARTRI"][f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    torch.cuda.synchronize()
    _cuda.KERNEL_LAUNCHES.clear()
    for n, count in PARTRI_GMRES_COUNTS.items():
        W, params, bcs, _, _ = gsetups[n]
        op = DPPOperator(W, params)
        r = newton_rhs(op, bcs)
        for preset in ("GMRES_ILU_PARTRI", "GMRES_ILU_PARTRI_GROUPED"):
            flat = dict(_freeze(PRESETS[preset]))
            group = int(flat.get("partri_group", 0))
            t0 = time.perf_counter()
            pc = _monolithic_pc(op, flat)
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
            ilu_pc = pc.__self__
            check(ilu_pc.trisolve_backend == "partri" and all(s.solver.G == group for s in ilu_pc.lower_solve),
                  f"2D N={n}: trisolve_backend=partri, partri_group={group} builds partri so grouped")
            if group:
                # the grouped apply's ~10^4 small ops, issued op by op, cost
                # 0.3 s an apply: the loop replays it from a CUDA graph
                # (bit for bit the issued apply: partri_group_applies)
                pc = graph_replayed(pc, r.shape, dev)
            before = dict(_cuda.KERNEL_LAUNCHES)
            t0 = time.perf_counter()
            res = gmres(op.stacked_matvec(), r, M_inv=pc, restart=int(flat.get("ksp_gmres_restart", 30)), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used = {k: v - before.get(k, 0) for k, v in _cuda.KERNEL_LAUNCHES.items() if v != before.get(k, 0)}
            print(f"host GMRES + partri ILU (partri_group={group}) 2D N={n}: iterations {res.iterations} "
                  f"(published {count}), launches {used}, ILU set-up {setup * 1e3:.1f} ms, solve {wall * 1e3:.2f} "
                  f"ms ({wall * 1e6 / res.iterations:.2f} us/iteration; host clock) on {smi}")
            check(res.iterations == count, f"2D N={n}: the host GMRES + partri ILU (group {group}) lands {count}")
            check(used.get("fused_dpp_apply", 0) > res.iterations and "structured_ilu_apply" not in used,
                  f"2D N={n}: K1 is the matvec, the ILU runs no wavefront kernel")
            check(bool(torch.isfinite(res.x).all()), "finite solution")
            del pc, ilu_pc
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
        check(wave_used.get("fused_gs") == 1 and "structured_ilu_apply[gs]" not in wave_used,
              f"{element} N={n}: left open, one fused_gs launch a solve")
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
    # the rest of conditioning_3d.csv, at the JAX package's 1e-8
    *[("hex", n, True, 1e-8) for n in (6, 10, 12, 14, 16)],
]


def conditioning_path(dev, smi, t_start):
    """Phase 10, the conditioning analysis: ``estimate_condition_numbers``
    with Lanczos on the card at 2D N=16/32/64 and hex N=6/8/10/12/14/16 and
    the dense host SVD at hex N=4, each against the published CSV; then tet nx=4's Lanczos
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


# phase 12, the h-convergence study. The published 2D table:
# notebooks/results-conforming-2d/convergence.csv (quad N=4..128, five
# approaches) and convergence_eoc.csv. Each approach's errors are held to the
# CSV within 1.5e-10 and its EOC within 1e-8, SS-GMRES+ILU too: its route is
# K8 with the preset's own inner GMRES + ILU blocks, as PETSc ran them (the
# JAX package's native-f64 route). One route is held at 1e-8: plain GMRES,
# whose iterate at rtol 1e-8 sits in a stagnation tail whose rounding it
# carries (at N=16 PETSc's iterate is 2.4e-7 from the exact discrete
# solution in e1_L2; K4's, with the same 292 iterations, 2.7e-9 from
# PETSc's, the CPU twin's 2.6e-10; where the card first departs from the
# CPU: plain_gmres_stages). Iteration slack: the +-2 of the Krylov phases at
# N=128.
CONV_NS = (4, 8, 16, 32, 64, 128)
CONV_ERROR_BOUND = {"GMRES": 1e-8}  # else 1.5e-10
CONV_EOC_BOUND = 1e-8
CONV_SLACK = {("GMRES", 128): 2, ("GMRES + ILU PC", 128): 2}
CONV_KERNELS = ("fused_gmres_df", "fused_gmres_df[fieldsplit_lu]", "fused_gmres_df[ilu]",
                "fused_gmres_df[fieldsplit_ilu]", "fused_direct_solve")
CONV_3D_NS = (8, 16, 32)
# the two 3D solvers' errors: fieldsplit-LU GMRES stops at rtol 1e-8, which
# leaves the small p1 field's error 4.5e-8 / 5.8e-7 relative from the direct
# solve's at hex N=8/16 (the CPU twins); the card's rows against the CPU's at
# N=8 within 1e-8
CONV_3D_SOLVER_BOUND = 1e-4
# convergence_qp.csv: the JAX package reproduces it exactly on the CPU, the
# port to <= 7.3e-13 (Q3 N=16), the card to 1.1e-11 there (cuBLAS sums in
# another order): Q3 N=16's e1_L2 is 0.26 against a p1 of ~2.2e4, so that is
# 1.3e-16 of the field, the solve's rounding
QP_BOUND = 1e-10
QP_NS = (4, 8, 16)
P2_NS = (8, 16, 32)
DEGREE_P_GMRES = {  # against the direct solve, fields within 1e-8
    "jacobi": {"ksp_type": "gmres", "pc_type": "jacobi", "ksp_rtol": 1e-13, "ksp_max_it": 20000},
    "fieldsplit": {"ksp_type": "gmres", "pc_type": "fieldsplit", "pc_fieldsplit_type": "multiplicative",
                   "ksp_rtol": 1e-12, "ksp_max_it": 20000},
}


def plain_gmres_stages(dev, smi) -> str:
    """Phase 12's plain GMRES row at 2D N=16 on the card against the CPU,
    stage by stage, bit for bit: the BC data (``bc_values_per_field``: the
    expressions evaluated on each device), the lifted right-hand side (K1's
    lift mode on the card, its twin on the CPU), the first residual ``b - A
    x0`` (K1's matvec, its twin), and the solve (K4, the twin). In the chain
    each device goes on from its own previous stage; alone, the card's stage
    takes the CPU's input. Prints each and returns the chain's first stage
    that differs ("none" where every stage is equal)."""
    import torch

    from perphil_tpu_torch.ops.assembly import DPPOperator, bc_values_per_field
    from perphil_tpu_torch.ops.fused_gmres import FusedGMRESSolver

    kw = {k: presets()["PLAIN_GMRES_PARAMS"][f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    (W, params, bcs, _, _), (Wc, _, bcsc, _, _) = problem("quad", 16, dev), problem("quad", 16, "cpu")
    op, opc = DPPOperator(W, params), DPPOperator(Wc, params)

    def residual(o, g):
        b = o.lifted_rhs(*g)
        bdry = o._mask_arrays[0]
        x0 = [torch.where(bdry, gi, 0.0) for gi in g]
        return b, torch.stack(o.residual(*x0, *b)).contiguous()

    def solve(o, r):
        solver = FusedGMRESSolver(o, "none", **kw)
        return solver(r).x  # K4 on the card, the twin on the CPU

    g_card, g_cpu = bc_values_per_field(W, bcs), bc_values_per_field(Wc, bcsc)
    (b_card, r_card), (b_cpu, r_cpu) = residual(op, g_card), residual(opc, g_cpu)
    stages = [  # name, the chain's card value, the card's value from the CPU's input, the CPU's
        ("BC data", g_card, g_card, g_cpu),
        ("lifted right-hand side", b_card, op.lifted_rhs(*(g.to(dev) for g in g_cpu)), b_cpu),
        ("first residual", r_card, residual(op, [g.to(dev) for g in g_cpu])[1], r_cpu),
        ("solution (K4, 292 iterations)", solve(op, r_card), solve(op, r_cpu.to(dev)), solve(opc, r_cpu)),
    ]

    def diff(a, b) -> str:
        a, b = torch.stack(list(a)).cpu(), torch.stack(list(b))
        if torch.equal(a, b):
            return "equal"
        return f"max abs diff {float((a - b).abs().max()):.3e} ({int((a != b).sum())} of {a.numel()} values)"

    first = "none"
    for name, chain, alone, cpu in stages:
        chained, isolated = diff(chain, cpu), diff(alone, cpu)
        print(f"plain GMRES quad N=16, card against CPU, {name}: chain {chained}; from the CPU's input "
              f"{isolated} on {smi}")
        if first == "none" and chained != "equal":
            first = name
    print(f"plain GMRES quad N=16: the first stage where the card leaves the CPU: {first}")
    return first


def convergence_path(dev, smi, t_start):
    """Phase 12, the h-convergence study through its entry points:
    the published 2D table (30 rows, counted) and its EOC, the 3D study at
    its defaults, the Qp rows against ``convergence_qp.csv``, the P2 rows,
    and the postprocessing (velocity projection, midline slice) at N=128.
    Prints each row's wall (the ``run_one`` call: set-up, solve, errors) and
    cached solve time; returns the table's launches."""
    import csv as _csv

    import numpy as np
    import torch

    from perphil_tpu_torch.experiments import convergence_2d as c2
    from perphil_tpu_torch.experiments import convergence_3d as c3
    from perphil_tpu_torch.experiments.iterative_bench import Approach, params_for
    from perphil_tpu_torch.forms import FunctionSpace, mixed_space
    from perphil_tpu_torch.mesh import create_mesh
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops import _cuda
    from perphil_tpu_torch.ops.assembly import DirichletBC, bc_values_per_field
    from perphil_tpu_torch.solvers import solve_dpp
    from perphil_tpu_torch.solvers.parameters import LINEAR_SOLVER_PARAMS
    from perphil_tpu_torch.solvers.solver import _degree_solver, _freeze
    from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions
    from perphil_tpu_torch.utils.postprocessing import (
        calculate_darcy_velocity_from_pressure,
        h1_seminorm_error,
        l2_error,
        slice_along_x,
    )

    errors = ("e1_L2", "e2_L2", "e1_H1s", "e2_H1s")
    params = DPPParameters()
    results = HERE / "notebooks" / "results-conforming-2d"

    def cached_solve_ms(W, bcs, opts):
        """One more solve on the solver the row built (the lift, the solve)."""
        solver = _degree_solver(W, params, _freeze(opts))
        g1, g2 = bc_values_per_field(W, bcs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver(g1, g2)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def degree_problem(n, degree, quad=True):
        mesh = create_mesh(n, n, quadrilateral=quad)
        W = mixed_space(FunctionSpace(mesh, degree=degree))
        check(W.device == dev, "a degree-p space built with no device lies on the card")
        _, p1e, _, p2e = exact_expressions(mesh, params)
        return W, [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)], p1e

    phase_t0 = time.perf_counter()
    # -- the published 2D table, counted
    with (results / "convergence.csv").open() as f:
        published = {(int(r["N"]), r["solver"]): r for r in _csv.DictReader(f)}
    table = [a for a in Approach if a is not Approach.PICARD_MUMPS]
    torch.cuda.synchronize()
    _cuda.KERNEL_LAUNCHES.clear()
    rows, walls = [], []
    for n in CONV_NS:
        for ap in table:
            t0 = time.perf_counter()
            rows.append(c2.run_one(n, c2.SolverSpec(ap.value, params_for(ap)), True, 1, params))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    table_wall = sum(walls)
    phase = dict(_cuda.KERNEL_LAUNCHES)
    print(f"convergence table kernel launches (30 rows): {phase}")
    for name in CONV_KERNELS:
        check(phase.get(name, 0) > 0, f"{name} launched on the convergence table")
    for row, wall in zip(rows, walls):
        n, name = row["N"], row["solver"]
        pub = published[(n, name)]
        errs = [abs(row[k] - float(pub[k])) / float(pub[k]) for k in errors]
        bound = CONV_ERROR_BOUND.get(name, 1.5e-10)
        slack = CONV_SLACK.get((name, n), 0)
        W, _, bcs, _, _ = problem("quad", n, dev)
        solve_ms = cached_solve_ms(W, bcs, params_for(Approach(name)))
        print(f"convergence N={n} {name}: it {row['it']} (csv {pub['it']}"
              + (f" +-{slack}" if slack else "") + f"), errors max rel diff {max(errs):.3e} (bound {bound:g}), "
              f"row {wall * 1e3:.1f} ms, cached solve {solve_ms:.2f} ms (host clock) on {smi}")
        check(abs(row["it"] - int(pub["it"])) <= slack, f"convergence N={n} {name} iterations")
        check(max(errs) <= bound, f"convergence N={n} {name} errors against convergence.csv")
    eoc = c2.compute_eoc(rows)
    with (results / "convergence_eoc.csv").open() as f:
        pub_eoc = {(r["solver"], r["err"]): float(r["slope"]) for r in _csv.DictReader(f)}
    check(len(eoc) == len(pub_eoc), "an EOC for every solver and error column")
    worst = {}
    for e in eoc:
        diff = abs(e["slope"] - pub_eoc[(e["solver"], e["err"])])
        worst[e["solver"]] = max(worst.get(e["solver"], 0.0), diff)
        check(diff <= CONV_EOC_BOUND, f"EOC {e['solver']} {e['err']}")
    print("convergence EOC, largest difference from convergence_eoc.csv per solver: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    print(f"convergence table: 30 rows in {table_wall:.2f} s (host clock) on {smi}")
    plain_gmres_stages(dev, smi)

    # -- the study scripts' command lines on the card (their default device), into a
    # temporary directory: 2D at N=4/8 (degree 1 and 2, with the EOC) and 3D at hex N=4/8
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        for degree in (1, 2):
            c2.main(["--Ns", "4", "8", "--degree", str(degree), "--rtols", "1e-8",
                     "--out", str(out / f"q{degree}.csv"), "--eoc-out", str(out / f"q{degree}_eoc.csv")])
            with (out / f"q{degree}.csv").open() as f:
                its = [int(r["it"]) for r in _csv.DictReader(f)]
            with (out / f"q{degree}_eoc.csv").open() as f:
                slopes = {(r["solver"], r["err"]): float(r["slope"]) for r in _csv.DictReader(f)}
            print(f"convergence_2d.main --degree {degree} on the card: iterations {its}, "
                  f"L2 EOC (N=4/8) {slopes[('mumps', 'e1_L2')]:.4f}")
            check(len(its) == 6 and len(slopes) == 12 and its[0] == its[3] == 1, f"convergence_2d.main --degree {degree}")
        c3.main(["--Ns", "4", "8", "--out", str(out / "c3.csv")])
        with (out / "c3.csv").open() as f:
            check([int(r["it"]) for r in _csv.DictReader(f)] == [1, 4, 1, 4], "convergence_3d.main")

    # -- the 3D study at its defaults: hex N=8/16/32, direct and fieldsplit-LU GMRES
    rows3 = []
    for n in CONV_3D_NS:
        pair = []
        for spec in c3.default_solvers_3d():
            t0 = time.perf_counter()
            row = c3.run_one_3d(n, spec, hexahedral=True, params=params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            line = (f"convergence 3D hex N={n} {spec.name}: it {row['it']}, e1_L2 {row['e1_L2']!r}, "
                    f"e2_L2 {row['e2_L2']!r}, row {wall * 1e3:.1f} ms")
            if n == CONV_3D_NS[0]:
                ref = c3.run_one_3d(n, spec, hexahedral=True, params=params, device="cpu")
                cpu = max(abs(row[k] - ref[k]) / ref[k] for k in errors)
                line += f", vs the CPU's row {cpu:.3e}"
                check(row["it"] == ref["it"] and cpu <= 1e-8, f"3D N={n} {spec.name} against the CPU")
            print(line + f" on {smi}")
            pair.append(row)
        gap = max(abs(pair[1][k] - pair[0][k]) / pair[0][k] for k in errors)
        print(f"convergence 3D hex N={n}: the two solvers' errors differ by {gap:.3e} (bound {CONV_3D_SOLVER_BOUND:g})")
        check(pair[0]["it"] == 1 and pair[1]["it"] == 4 and gap <= CONV_3D_SOLVER_BOUND, f"3D N={n} solvers")
        rows3 += pair
    eoc3 = {(e["solver"], e["err"]): e["slope"] for e in c2.compute_eoc(rows3)}
    print(f"convergence 3D EOC: {eoc3}")
    for spec in c3.default_solvers_3d():
        check(1.7 < eoc3[(spec.name, "e1_L2")] < 2.2 and 0.8 < eoc3[(spec.name, "e1_H1s")] < 1.2,
              f"3D EOC {spec.name}")

    # -- Qp: degree 2 and 3 at N=4/8/16 against convergence_qp.csv; degree-2
    # GMRES with jacobi and with the fieldsplit against the direct solve
    with (results / "convergence_qp.csv").open() as f:
        qp_pub = {(int(r["degree"]), int(r["N"])): (float(r["e1_L2"]), float(r["e1_H1s"]))
                  for r in _csv.DictReader(f)}
    for degree in (2, 3):
        for n in QP_NS:
            W, bcs, p1e = degree_problem(n, degree)
            sol = solve_dpp(W, params, bcs, solver_parameters=LINEAR_SOLVER_PARAMS)
            p1h = sol.solution.sub(0)
            got = (l2_error(p1h, p1e), h1_seminorm_error(p1h, p1e))
            err = max(abs(g - w) / w for g, w in zip(got, qp_pub[(degree, n)]))
            line = (f"Q{degree} N={n} direct (fast-diag on the card): e1_L2 {got[0]!r}, e1_H1s {got[1]!r}, "
                    f"max rel diff from convergence_qp.csv {err:.3e} (bound {QP_BOUND:g}), "
                    f"cached solve {cached_solve_ms(W, bcs, LINEAR_SOLVER_PARAMS):.2f} ms")
            check(err <= QP_BOUND and sol.solution.data[0].device == dev, f"Q{degree} N={n} against the CSV")
            if degree == 2:
                for name, opts in DEGREE_P_GMRES.items():
                    it = solve_dpp(W, params, bcs, solver_parameters=opts)
                    diff = max(rel(a, b) for a, b in zip(it.solution.data, sol.solution.data))
                    line += (f"; GMRES+{name} {it.iteration_number} its, vs direct {diff:.3e}, "
                             f"cached solve {cached_solve_ms(W, bcs, opts):.2f} ms")
                    check(diff <= 1e-8, f"Q2 N={n} GMRES+{name} against the direct solve")
            print(line + f" (host clock) on {smi}")

    # -- P2 on triangles: the host splu stage and GMRES + jacobi on the card
    p2_errs = []
    for n in P2_NS:
        W, bcs, p1e = degree_problem(n, 2, quad=False)
        line = f"P2 tri N={n}:"
        sols, errs = [], []
        for name, opts in (("direct (host splu)", LINEAR_SOLVER_PARAMS), ("GMRES+jacobi", DEGREE_P_GMRES["jacobi"])):
            sols.append(solve_dpp(W, params, bcs, solver_parameters=opts))
            check(sols[-1].solution.data[0].device == dev, "the P2 solution lies on the card")
            errs.append(l2_error(sols[-1].solution.sub(0), p1e))
            line += (f" {name} {sols[-1].iteration_number} its, e1_L2 {errs[-1]!r}, "
                     f"cached solve {cached_solve_ms(W, bcs, opts):.2f} ms;")
        diff = max(rel(a, b) for a, b in zip(sols[1].solution.data, sols[0].solution.data))
        print(line + f" fields direct vs GMRES {diff:.3e}, e1_L2 {abs(errs[1] - errs[0]) / errs[0]:.3e} "
              f"(host clock) on {smi}")
        check(diff <= 1e-8, f"P2 tri N={n}: direct against GMRES+jacobi")
        p2_errs.append(errs[0])
    p2_eoc = float(np.polyfit(np.log([1.0 / n for n in P2_NS]), np.log(p2_errs), 1)[0])
    print(f"P2 tri L2 EOC over N={P2_NS}: {p2_eoc:.4f}")
    check(2.7 < p2_eoc < 3.3, "P2 L2 EOC near 3")

    # -- postprocessing: the Darcy velocity and the midline slice at N=16
    # (against the port's CPU run) and N=128 (closer to the exact fields)
    post = {}
    for n in (16, 128):
        W, params_, bcs, p1e, _ = problem("quad", n, dev)
        p1h = solve_dpp(W, params_, bcs, solver_parameters=LINEAR_SOLVER_PARAMS).solution.sub(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = calculate_darcy_velocity_from_pressure(p1h, params_.k1)
        ys, vals = slice_along_x(p1h, 0.5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        u1e = exact_expressions(W.mesh, params_)[0]
        X, Y = (torch.as_tensor(c, device=dev) for c in W.mesh.coordinates())
        ue = torch.stack(u1e(X, Y), dim=-1)
        u_err = rel(u.data, ue)
        s_err = float(np.abs(vals - p1e(torch.full((len(ys),), 0.5), torch.as_tensor(ys)).numpy()).max()
                      / np.abs(vals).max())
        line = (f"postprocessing N={n} on the card: velocity {tuple(u.data.shape)} vs the exact u1 {u_err:.3e}, "
                f"slice {len(ys)} points vs the exact p1 {s_err:.3e}, {wall * 1e3:.1f} ms (host clock)")
        check(bool(torch.isfinite(u.data).all()) and u.data.device == dev, "finite velocity on the card")
        if n == 16:
            Wc, pc, bcc, _, _ = problem("quad", n, "cpu")
            p1c = solve_dpp(Wc, pc, bcc, solver_parameters=LINEAR_SOLVER_PARAMS).solution.sub(0)
            uc = calculate_darcy_velocity_from_pressure(p1c, pc.k1)
            _, vc = slice_along_x(p1c, 0.5)
            cpu = (rel(u.data.cpu(), uc.data), float(np.abs(vals - vc).max() / np.abs(vc).max()))
            line += f"; vs the CPU run: velocity {cpu[0]:.3e}, slice {cpu[1]:.3e}"
            check(cpu[0] <= 1e-9 and cpu[1] <= 1e-10, "postprocessing at N=16 against the CPU")
        print(line + f" on {smi}")
        post[n] = (u_err, s_err)
    check(post[128][0] < post[16][0] and post[128][1] < post[16][1], "postprocessing converges from N=16 to 128")
    print(f"[{time.perf_counter() - t_start:.1f} s] convergence study done in "
          f"{time.perf_counter() - phase_t0:.1f} s (host clock) on {smi}")
    return phase


# phase 13, the profiling studies. The published counts: 2D
# notebooks/results-conforming-2d/petsc_profiling/petsc_perf_breakdown.csv, the
# Picard column from petsc_perf_breakdown-with-picard.csv (that file's other
# rows are not read: its GMRES N=8 41 is stale); 3D
# notebooks/results-conforming-3d/petsc_profiling/petsc_perf_breakdown_3d.csv
# (GMRES + ILU: the ordering-parity rows) and, for the structured envelope
# ILU, petsc_perf_breakdown_3d_envelope_ilu.csv
PROF_NS = (4, 8, 16, 32, 64, 128)
PROF_N256 = 256  # the five linear approaches, repeats=1; plain GMRES without the warm-up solve
PROF_SLACK = 2  # GMRES and GMRES + ILU at N >= 128, as phases 5-6 allow
PROF_3D_NS = (4, 8, 16, 24, 40)
PROF_KERNELS = ("fused_dpp_apply", "fused_direct_solve", "fused_gmres_df", "fused_gmres_ef64",
                "fused_gmres_df[fieldsplit_lu]", "fused_gmres_df[ilu]", "fused_gmres_df[fieldsplit_ilu]",
                "fused_ngs", "structured_ilu_apply")


def profiling_path(dev, smi, t_start, results):
    """Phase 13, the profiling studies through their entry points: the 2D
    table (``run_perf_once``, events backend) at quad N=4..128 x the six
    approaches and N=256 x the five linear ones, the 3D table
    (``run_perf_once_3d``) at tet nx=4/8/16/24/40 with the ordering-parity
    ILU and the envelope ILU, one trace-backend row, the chunked drivers
    against the one-call solves, the ordering study at small sizes, K1 on
    the roofline and its chained marginal. Every row must be measured by
    the backend it asked for; returns the tables' launches."""
    import csv as _csv
    import tempfile

    import torch

    from perphil_tpu_torch.experiments import ordering_study as ostudy
    from perphil_tpu_torch.experiments.iterative_bench import Approach, params_for
    from perphil_tpu_torch.experiments.profiling import (
        build_chunked_ngs_solver,
        build_chunked_plain_solver,
        ensure_logging,
        run_perf_once,
        save_perf_csv,
    )
    from perphil_tpu_torch.experiments.profiling_3d import run_perf_once_3d
    from perphil_tpu_torch.ops import _cuda
    from perphil_tpu_torch.ops.assembly import DPPOperator, bc_values_per_field
    from perphil_tpu_torch.solvers.solver import _build_linear_solver, _build_nonlinear_solver, _freeze
    from perphil_tpu_torch.utils import roofline
    from perphil_tpu_torch.utils.marginal import chained_marginal, fn_chain_maker

    nb = HERE / "notebooks"
    prof2 = nb / "results-conforming-2d" / "petsc_profiling"
    prof3 = nb / "results-conforming-3d" / "petsc_profiling"

    def published(path, approaches=None):
        with path.open() as f:
            rows = list(_csv.DictReader(f))
        return {(r["approach"], int(r["nx"])): int(r["iterations"]) for r in rows
                if approaches is None or r["approach"] in approaches}, list(rows[0])

    pub2, header = published(prof2 / "petsc_perf_breakdown.csv")
    picard = Approach.PICARD_MUMPS.value
    pub2.update(published(prof2 / "petsc_perf_breakdown-with-picard.csv", {picard})[0])
    pub3, header3 = published(prof3 / "petsc_perf_breakdown_3d.csv")
    envelope = {nx: its for (_, nx), its in published(prof3 / "petsc_perf_breakdown_3d_envelope_ilu.csv")[0].items()}
    check(header3 == header, "the 2D and 3D tables share one header")
    check(ensure_logging(), "CUDA events work")

    def show(tag, res, pub, slack=0):
        t = res.times
        print(f"profile {tag} {res.approach}: its {res.iterations} (csv {pub}" + (f" +-{slack}" if slack else "")
              + f"), time_total {res.time_total * 1e3:.3f} ms, KSPSolve {t['KSPSolve'] * 1e3:.3f} ms, "
              f"MatMult {t['MatMult'] * 1e3:.3f} ms, PCApply {t['PCApply'] * 1e3:.3f} ms, "
              f"PCSetUp {t['PCSetUp'] * 1e3:.1f} ms, backend {res.metadata['backend']}"
              + (f", engine {res.metadata['engine']}" if "engine" in res.metadata else "")
              + f", {res.measurement_class} on {smi}")
        check(res.metadata["backend"] == "events", f"profile {tag} {res.approach}: measured by the events backend")
        check(res.time_total > 0.0, f"profile {tag} {res.approach}: time_total > 0")
        check(abs(res.iterations - pub) <= slack, f"profile {tag} {res.approach}: iterations against the csv")

    phase_t0 = time.perf_counter()
    # -- the 2D table, counted
    torch.cuda.synchronize()
    _cuda.KERNEL_LAUNCHES.clear()
    rows, t0 = [], time.perf_counter()
    for n in PROF_NS:
        for ap in Approach:
            res = run_perf_once(n, n, ap, repeats=2, backend="events")
            slack = PROF_SLACK if n >= 128 and ap in (Approach.PLAIN_GMRES, Approach.GMRES_ILU) else 0
            show(f"2D N={n}", res, pub2[(ap.value, n)], slack)
            rows.append(res.to_dict())
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for ap in Approach:
        if ap is Approach.PICARD_MUMPS:
            continue
        t1 = time.perf_counter()
        res = run_perf_once(PROF_N256, PROF_N256, ap, repeats=1, backend="events",
                            eager=ap is not Approach.PLAIN_GMRES)
        slack = PROF_SLACK if ap in (Approach.PLAIN_GMRES, Approach.GMRES_ILU) else 0
        show(f"2D N={PROF_N256}", res, pub2[(ap.value, PROF_N256)], slack)
        print(f"  row wall {time.perf_counter() - t1:.2f} s (host clock)")
        rows.append(res.to_dict())
    n256_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    phase = dict(_cuda.KERNEL_LAUNCHES)
    print(f"2D profiling table kernel launches ({len(rows)} rows): {phase}")
    for name in PROF_KERNELS:
        check(phase.get(name, 0) > 0, f"{name} launched on the 2D profiling table")
    with tempfile.TemporaryDirectory() as tmp:
        save_perf_csv(rows, Path(tmp) / "perf.csv")
        with (Path(tmp) / "perf.csv").open() as f:
            check(next(_csv.reader(f)) == header, "the 2D table's CSV has the committed header")
    print(f"2D profiling table: {len(PROF_NS) * len(Approach)} rows in {table_s:.2f} s, N={PROF_N256} x 5 in "
          f"{n256_s:.2f} s (host clock) on {smi}")

    # -- the 3D table, counted: the ordering-parity ILU, then the envelope ILU
    _cuda.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    for nx in PROF_3D_NS:
        for ap in Approach:
            if ap is Approach.PICARD_MUMPS:
                continue
            res = run_perf_once_3d(nx, ap, repeats=1, backend="events", ordering_parity=True)
            show(f"3D tet nx={nx}", res, pub3[(ap.value, nx)])
            if ap is Approach.GMRES_ILU:
                check(res.metadata["engine"] == "device" and res.metadata["ordering"] == "rcm-parity",
                      f"3D nx={nx}: the ordering-parity ILU on the band engine")
    for nx in PROF_3D_NS:
        res = run_perf_once_3d(nx, Approach.GMRES_ILU, repeats=1, backend="events")
        show(f"3D tet nx={nx} envelope", res, envelope[nx])
    torch.cuda.synchronize()
    phase3 = dict(_cuda.KERNEL_LAUNCHES)
    print(f"3D profiling table kernel launches: {phase3}; {time.perf_counter() - t0:.2f} s (host clock)")
    check(phase3.get("band_trisolve", 0) > 0, "band_trisolve launched on the 3D profiling table")
    for name, count in phase3.items():
        phase[name] = phase.get(name, 0) + count

    # -- the trace backend: device time from torch.profiler's CUDA activity
    res = run_perf_once(64, 64, Approach.GMRES_ILU, repeats=2, backend="trace")
    t = res.times
    print(f"profile 2D N=64 {res.approach} (trace): its {res.iterations}, KSPSolve {t['KSPSolve'] * 1e3:.3f} ms "
          f"device, MatMult {t['MatMult'] * 1e3:.3f} ms, PCApply {t['PCApply'] * 1e3:.3f} ms, time_total "
          f"{res.time_total * 1e3:.3f} ms (host clock), backend {res.metadata['backend']} on {smi}")
    check(res.metadata["backend"] == "trace", "the trace row is measured by the trace backend")
    check(t["KSPSolve"] > 0 and t["MatMult"] > 0 and t["PCApply"] > 0, "the trace row's device times")

    # -- the chunked drivers against the one-call solves (2D N=64)
    W, params, bcs, _, _ = problem("quad", 64, dev)
    g1, g2 = bc_values_per_field(W, bcs)
    plain = params_for(Approach.PLAIN_GMRES)
    z1, z2, its, _ = _build_linear_solver(W, params, _freeze(plain))(g1, g2)
    chunked = build_chunked_plain_solver(W, params, plain)
    _cuda.KERNEL_LAUNCHES.clear()
    c1, c2, total, _ = chunked(g1, g2)
    k4 = _cuda.KERNEL_LAUNCHES.get("fused_gmres_df", 0)
    diff = max(rel(a, b) for a, b in ((c1, z1), (c2, z2)))
    print(f"chunked plain GMRES N=64: {total} iterations in {k4} K4 launches (one call: {its}), fields max rel "
          f"diff {diff:.3e}")
    check(total == its == 3307 and k4 == 2 and diff <= 1e-12, "the chunked plain GMRES is the one-call solve")
    picard_opts = params_for(Approach.PICARD_MUMPS)
    z1, z2, its, fn = _build_nonlinear_solver(W, params, _freeze(picard_opts))(g1, g2)
    chunked = build_chunked_ngs_solver(W, params, picard_opts)
    _cuda.KERNEL_LAUNCHES.clear()
    c1, c2, total, cfn = chunked(g1, g2)
    launched = _cuda.KERNEL_LAUNCHES.get("fused_ngs", 0)
    same = torch.equal(c1, z1) and torch.equal(c2, z2)
    print(f"chunked ngs N=64: {total} iterations in {launched} fused_ngs launches (one call: {its}), x bit for "
          f"bit: {same}, fn {float(cfn):.6e} / {float(fn):.6e}")
    check(total == its == 1673 and launched == 4 and same, "the chunked ngs is the one-call solve, bit for bit")

    # -- the ordering study at small sizes (the host C++ GS kernel builds here)
    t0 = time.perf_counter()
    with (nb / "results-conforming-3d" / "ordering" / "ordering_sensitivity.csv").open() as f:
        sens = {(int(r["dim"]), int(r["N"]), r["algorithm"], r["ordering"], r["pattern"]): int(r["its"])
                for r in _csv.DictReader(f)}
    cases = 0
    for dim, n, pattern in ((3, 4, "envelope"), (3, 4, "fe"), (3, 8, "envelope"), (3, 8, "fe"),
                            (2, 4, "envelope"), (2, 8, "envelope"), (2, 16, "envelope")):
        for o in ostudy.ORDERINGS:
            key = (dim, n, "gmres+ilu0", o, "envelope==fe" if dim == 2 else pattern)
            its = ostudy.ilu_case(n, dim, o, pattern, quad_or_hex=dim == 2)
            if key in sens:
                check(its == sens[key], f"ordering study {key}")
                cases += 1
            elif dim == 3 and pattern == "fe":  # cell-rcm-parity: the published column
                check(its == ostudy.REF_ILU_3D[n], f"ordering study {key}: the published count")
                cases += 1
    for n in (4, 8):
        for o in ostudy.ORDERINGS:
            for stol, crit in ((1e-8, "rtol+stol"), (0.0, "rtol-only")):
                key = (2, n, "pointwise-gs", o, f"criterion={crit}")
                if key in sens:
                    check(ostudy.ngs_case(n, 2, o, stol=stol) == sens[key], f"ordering study {key}")
                    cases += 1
    with (nb / "results-conforming-2d" / "ordering" / "ngs_coloring.csv").open() as f:
        coloring = {(int(r["N"]), r["variant"]): r for r in _csv.DictReader(f)}
    for row in ostudy.run_ngs_coloring_study([4, 8, 16]):
        ref = coloring[(row["N"], row["variant"])]
        check(str(row["its"]) == ref["its"] and str(row["ncolors"]) == ref["ncolors"],
              f"ngs coloring study N={row['N']} {row['variant']}")
        cases += 1
    print(f"ordering study: {cases} cases equal to ordering_sensitivity.csv / ngs_coloring.csv (or the "
          f"published column), {time.perf_counter() - t0:.2f} s (host clock)")

    # -- K1 on the roofline (phase 11's time at 128^3) and its chained marginal at 64^3
    k1 = results["fused_dpp_apply"]
    W128, _, _, _, _ = problem("hex", 128, dev)
    nbytes = 4 * 8 * W128.mesh.num_vertices
    point = roofline.analyze("fused_dpp_apply", k1["ms"] * 1e-3, matvec_flops(W128.mesh, params), nbytes)
    print(f"roofline K1 hex128 f64 matvec: {point.seconds * 1e3:.4f} ms, {point.gbs:.1f} GB/s, hbm_frac "
          f"{point.hbm_frac:.3f}, {point.gflops:.1f} GFLOP/s ({point.peak_frac:.4f} of f64), {point.bound} bound "
          f"at {point.intensity:.3f} flop/B, on {torch.cuda.get_device_name(0)} ({smi})")
    check(0.0 < point.hbm_frac <= 1.0, "K1 moves no more than the card's bandwidth")
    W64 = problem("hex", 64, dev)[0]
    mv = DPPOperator(W64, params).stacked_matvec()
    x = torch.randn((2,) + W64.mesh.node_shape, dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    per = chained_marginal(fn_chain_maker(mv), (x,), 64, window=0.1)
    print(f"chained marginal K1 hex64 (stacked_matvec + keep-alive sums, issued back to back): "
          f"{per * 1e3:.4f} ms a trip, beside phase 11's queued {results['fused_dpp_apply@hex64']['ms']:.4f} ms "
          f"on {smi}")
    check(per > 0.0, "a positive marginal")
    print(f"[{time.perf_counter() - t_start:.1f} s] profiling path done: phase 13 "
          f"{time.perf_counter() - phase_t0:.1f} s (host clock) on {smi}")
    return phase


# phase 14, the multi-device path. The JAX dry run's six counts on 8 devices
# as (4, 2): MULTICHIP_r05.json; the published plain GMRES count at 2D N=64:
# petsc_perf_breakdown.csv (KRYLOV_CASES)
MULTICHIP_RECORD = "MULTICHIP_r05.json"
# loopback blocks: a world of one rank's block (edge ghosts only, the main
# path's form), slabs, then pencils
HALO_MESHES = ((1, 1), (2,), (4,), (8,), (2, 2), (4, 2))
# the blocked Picard iteration's kernels: loopback layouts of 2D N=128, and
# whether the neighbours go through the exchange buffers
COLOUR_LAYOUTS = (((1,), False), ((2,), False), ((4,), False), ((8,), False), ((8,), True), ((2, 2), False),
                  ((2, 2), True))
# the sharded solves at full width on a world of one rank: element, N,
# preset, nonlinear; and their published counts (petsc_perf_breakdown.csv,
# its -with-picard column; SS-GMRES: the fieldsplit-LU GMRES's 4)
FULL_WIDTH = (("hex", 128, "TPU_DIRECT_PARAMS", False), ("quad", 64, "PLAIN_GMRES_PARAMS", False),
              ("quad", 64, "SS-GMRES", False), ("quad", 64, "PICARD_LU_SOLVER_PARAMS", True),
              ("quad", 128, "PICARD_LU_SOLVER_PARAMS", True))
FULL_WIDTH_COUNTS = {("quad", 64, "PLAIN_GMRES_PARAMS"): 3307, ("quad", 64, "SS-GMRES"): 4,
                     ("quad", 64, "PICARD_LU_SOLVER_PARAMS"): PICARD_COUNTS[64],
                     ("quad", 128, "PICARD_LU_SOLVER_PARAMS"): PICARD_COUNTS[128]}
# the degree-p parts on blocks at full width (phase 14 (c2)): element, N,
# degree, solve; on loopback slabs and pencils of the phantom-padded lattice,
# held to the whole-grid solve (the CPU tests' tolerances,
# tests/test_torch_blocked_degree_p.py)
DEGREE_P_CASES = (("quad", 128, 2, "direct"), ("quad", 128, 2, "fieldsplit"), ("hex", 32, 2, "direct"),
                  ("hex", 32, 2, "fieldsplit"), ("triangle", 64, 2, "jacobi"))
DEGREE_P_OPTIONS = {"direct": {"ksp_type": "preonly", "pc_type": "lu"},
                    "fieldsplit": {"ksp_type": "gmres", "pc_type": "fieldsplit", "ksp_rtol": 1e-8},
                    "jacobi": {"ksp_type": "gmres", "pc_type": "jacobi", "ksp_rtol": 1e-8}}
DEGREE_P_MESHES = ((4,), (2, 2))
DEGREE_P_OP_TOL, DEGREE_P_SOLVE_TOL = 1e-13, 1e-12


def multichip_counts():
    """The JAX dry run's iteration count a path, from its committed record."""
    import re

    tail = json.loads((HERE / MULTICHIP_RECORD).read_text())["tail"]
    return {label: int(its) for label, its in re.findall(r"dryrun_multichip\[(.*?)\]: its=(\d+)", tail)}


def in_turns(runs: dict, order, calls: int = 20, per_call: bool = False) -> dict:
    """Each run's device time (``queued_ms`` of ``calls`` calls) in the given
    order of turns: name -> its times, in order. ``per_call``: each call's
    time instead (``time_ms``, median of ``calls``), for calls that read a
    result back (the fused solvers), which the queue cannot hide."""
    times = {}
    for name in order:
        fn = runs[name]
        times.setdefault(name, []).append(
            time_ms(fn, repeats=calls, warmup=0) if per_call else queued_ms(fn, calls=calls))
    return times


def turns_text(order, times) -> str:
    """``in_turns``'s times in their order: "name t / name t / ..."."""
    seen = collections.Counter()
    parts = []
    for name in order:
        parts.append(f"{name} {times[name][seen[name]]:.4f}")
        seen[name] += 1
    return " / ".join(parts)


def halo_bytes(owned: int, planes, itemsize: int = 8) -> int:
    """The halo form's bytes: the owned block of both fields in and out,
    each received plane in once."""
    return itemsize * (2 * 2 * owned + sum(g.numel() for pair in planes for g in pair if g is not None))


def colour_step_work(part, colour: int):
    """(bytes, f64 operations) of one colour step of ``part`` (an
    ``NgsBlock``), from its rows: each distinct x value the rows read, once
    (a boundary row its own; an interior row both fields' 3 x 3 neighbours
    that are not on the boundary, in the block or a received plane), b and
    the int32 row list at the rows, the rows written, and the 38 weights;
    39 operations an interior row (18 products, 18 sums, a difference, a
    quotient, a sum), 3 a boundary row."""
    import numpy as np

    rows = part.rows[colour].cpu().numpy()
    f, j, i = np.unravel_index(rows, part.shape)
    ext = part.bdry.cpu().numpy()  # the block and a ring of ghosts: True on the boundary
    ey, ex = ext.shape
    inner = ~ext[j + 1, i + 1]
    reads = [(f * ey + j + 1) * ex + i + 1]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            jj, ii = j[inner] + dy + 1, i[inner] + dx + 1
            keep = ~ext[jj, ii]
            reads += [(g * ey + jj[keep]) * ex + ii[keep] for g in (0, 1)]
    nbytes = 8 * np.unique(np.concatenate(reads)).size + (8 + 4 + 8) * rows.size + 8 * 38
    return nbytes, 39 * int(inner.sum()) + 3 * int((~inner).sum())


def norm_work(sweep):
    """(bytes, f64 operations) of the norm kernel on ``sweep``'s blocks (an
    ``NgsSweep``): x and b of every row read once, the state written; 39
    operations an interior row (18 products, 18 sums, a difference, the
    square, its sum), 3 a boundary or phantom row."""
    nbytes, ops = 8 * 16, 0
    for part in sweep.parts.values():
        inner = int((~part.bdry[1:-1, 1:-1]).sum()) * 2
        rows = 2 * part.shape[1] * part.shape[2]
        nbytes += 8 * 2 * rows
        ops += 39 * inner + 3 * (rows - inner)
    return nbytes, ops


def first_form_apply(op, dmesh, probe, mode: str = "matvec"):
    """The sharded apply as it stood before the halo form's redesign, for
    timing beside today's: the block extended whole along each mesh axis
    (its edge planes copied out, zero planes where no neighbour sends,
    ``torch.cat``), then the first halo form (the probe) on the box. On a
    world of one rank no plane is sent."""
    import torch

    from perphil_tpu_torch.ops.fused_apply import halo_probe_apply
    from perphil_tpu_torch.parallel.halo import block_geometry

    S = op._combined_stencils
    ghosts, offsets, n_phys = block_geometry(dmesh.shape, dmesh.coords, dmesh.local_shape(op.grid_shape),
                                             op.mesh.node_shape)
    check(dmesh.size == 1, "the first form's apply is rebuilt for a world of one rank")

    def apply(x):
        for k in range(len(dmesh.shape)):
            n = x.shape[1 + k]
            lo, hi = x.narrow(1 + k, 0, 1).contiguous(), x.narrow(1 + k, n - 1, 1).contiguous()
            x = torch.cat([torch.zeros_like(hi), x, torch.zeros_like(lo)], dim=1 + k)
        return halo_probe_apply(probe, x, S, mode, ghosts, offsets, n_phys)

    return apply


def degree_p_blocks(dev, smi, randn, cases=DEGREE_P_CASES, meshes=DEGREE_P_MESHES):
    """Phase 14 (c2), the degree-p parts on blocks at full width: the Qp and
    P2 solves of ``cases`` with every part on loopback slabs and pencils
    (``meshes``) of the phantom-padded lattice (``tools/dryrun.py::
    loopback_solve``: ``solvers/solver.py::_run_parts`` with the operator
    on boxes of p or 2 ghost planes, the fast-diag through the transposes,
    GMRES on the joined vector) against the whole-grid solve (the
    single-device route): equal counts, the fields within 1e-12, the P2
    matvec and lift bit for bit, the Qp ones within 1e-13; the collectives
    of one application of each part; both routes' walls in turns (whole,
    blocked, blocked, whole; host clock, synchronised), both warm: each
    route's solver and block data are built by the checked solve before
    them (``loopback_solve`` keeps one ``JoinedBlocks`` a mesh)."""
    import torch

    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.ops.simplexfem import P2SimplexDPPOperator
    from perphil_tpu_torch.ops.tensorfem import TensorDPPOperator
    from perphil_tpu_torch.parallel.halo import COLLECTIVES
    from perphil_tpu_torch.solvers import solve_dpp
    from perphil_tpu_torch.tools.dryrun import _manufactured_bcs, _space, collectives_text, loopback_solve

    def solve_wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for element, n, degree, solve in cases:
        options = DEGREE_P_OPTIONS[solve]
        Wd = _space(element, n, degree, dev)
        bd, pd = _manufactured_bcs(Wd), DPPParameters()
        dof = Wd.spaces[0].dof_mesh.node_shape
        single = solve_dpp(Wd, pd, bd, solver_parameters=options)
        zs = torch.stack(single.solution.data)
        check(bool(torch.isfinite(zs).all()) and zs.device == dev, f"degree-{degree} {element} N={n} {solve}: "
              "a finite whole-grid solution on the card")
        for ms in meshes:
            where = f"degree-{degree} {element} N={n} {solve} over loopback {ms}"
            COLLECTIVES.clear()
            z, its, _, apply = loopback_solve(Wd, pd, bd, ms, options)
            coll = dict(COLLECTIVES)
            e = rel(z, zs)
            check(its == single.iteration_number and e <= DEGREE_P_SOLVE_TOL,
                  f"{where}: {its} iterations against the whole grid's {single.iteration_number}, "
                  f"fields {e:.2e} of it")
            pad = tuple([(-m) % s for m, s in zip(dof, ms)] + [0] * (len(dof) - len(ms)))
            v = torch.stack([randn(tuple(m + q for m, q in zip(dof, pad))) for _ in range(2)])
            whole_op = (TensorDPPOperator(Wd.mesh, pd, degree, pad, device=dev) if Wd.mesh.is_tensor_product
                        else P2SimplexDPPOperator(Wd.mesh, pd, pad, device=dev))
            per = {}
            for part in ("matvec", "lift", "pc"):
                COLLECTIVES.clear()
                got = apply[part](v)
                torch.cuda.synchronize()
                per[part] = dict(COLLECTIVES)
                if part == "pc":
                    continue
                want = torch.stack(whole_op.matvec(v[0], v[1]) if part == "matvec" else
                                   whole_op.lifted_rhs(v[0], v[1]))
                if element in ("hex", "quad"):
                    check(rel(got, want) <= DEGREE_P_OP_TOL, f"{where}: the {part} within 1e-13 of the whole grid's")
                else:
                    check(torch.equal(got, want), f"{where}: the P2 {part} bit for bit with the whole lattice's")
            runs = {"whole": lambda: solve_dpp(Wd, pd, bd, solver_parameters=options),
                    "blocked": lambda: loopback_solve(Wd, pd, bd, ms, options)}
            order = ("whole", "blocked", "blocked", "whole")
            walls_c2 = {name: [] for name in runs}
            for name in order:
                walls_c2[name].append(solve_wall(runs[name]))
            print(f"{where} (padded {tuple(m + q for m, q in zip(dof, pad))}, {2 * math.prod(dof)} DoF): its={its} "
                  f"(whole grid {single.iteration_number}), fields {e:.2e} of the whole grid's; collectives a solve "
                  f"{collectives_text(coll, its)}; an application: matvec {per['matvec']}, lift {per['lift']}, "
                  f"{'direct solve' if solve == 'direct' else 'preconditioner'} {per['pc']}; walls in turns "
                  + " / ".join(f"{name} {walls_c2[name][order[:i].count(name)]:.4f}" for i, name in enumerate(order))
                  + f" s (host clock, a solve) on {smi}")


def multidevice_path(dev, smi, randn, results, t_start, probe, norm_probe):
    """Phase 14: K1's halo form over loopback blocks against K1 on the whole
    grid, and its times in turns with the first form (``probe``:
    ``fused_apply.halo_probe_library()``); the colour-step kernel and the
    norm against their twins over loopback slabs and pencils, the norm also
    against the first norm kernel (``norm_probe``:
    ``fused_ngs.norm_probe_library()``) and in turns with it; the blocked
    fast-diag and mixed direct solves over loopback slabs and pencils of
    128^3; then, counted, the sharded solves on a world of one NCCL rank:
    the six dry-run paths, 128^3 hex TPU_DIRECT_PARAMS, 2D N=64 plain GMRES
    and SS-GMRES, and the Picard solves at 2D N=64/128 at full width; one
    sharded apply at 64^3 and 128^3 beside the first form's; the scaling
    harness in a world of its own. Returns the launches of the counted
    run."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from perphil_tpu_torch.experiments.scaling import run_scaling
    from perphil_tpu_torch.ops import _cuda
    from perphil_tpu_torch.ops.direct import FastDiagDPPSolver, _fd_blocks
    from perphil_tpu_torch.ops.fused_ngs import (
        FN as NGS_FN,
        ITERATIONS_PER_READ,
        FirstNormSweep,
        FusedNGSSolver,
        NgsBlock,
        NgsSweep,
        blocked_ngs,
        blocked_ngs_probe,
        probe_library,
    )
    from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper
    from perphil_tpu_torch.ops.mixed import MixedPrecisionDPPDirect
    from perphil_tpu_torch.parallel.halo import COLLECTIVES
    from perphil_tpu_torch.parallel.transpose import LoopbackBlocks, Move
    from perphil_tpu_torch.ops.assembly import DPPOperator, dpp_stencils
    from perphil_tpu_torch.ops.fused_apply import (
        box_boundary,
        fused_dpp_apply_halo,
        fused_dpp_apply_halo_planes,
        fused_dpp_apply_halo_planes_plain,
        fused_dpp_apply_plain,
        fused_dpp_apply_stacked,
        halo_plan,
        halo_probe_apply,
        halo_wave,
    )
    from perphil_tpu_torch.models.dpp import DPPParameters
    from perphil_tpu_torch.parallel.halo import (
        benchmark_vs_gathered,
        block_geometry,
        halo_box,
        join_blocks,
        loopback_apply,
        loopback_planes,
        split_blocks,
        stacked_halo_apply,
    )
    from perphil_tpu_torch.parallel.sharding import (
        blocked_solve_dpp,
        device_mesh,
        sharded_solve_dpp,
        sharded_solve_dpp_nonlinear,
    )
    from perphil_tpu_torch.solvers import solve_dpp, solve_dpp_nonlinear
    from perphil_tpu_torch.solvers.solver import _freeze, linear_on_one_rank_whole, ngs_on_one_rank_whole
    from perphil_tpu_torch.ops.fused_direct import fused_direct_supported
    from perphil_tpu_torch.tools.dryrun import (
        check_paths,
        collectives_text,
        dryrun_cases,
        rendezvous_store,
        sharded_record,
        solve_case,
    )

    t_phase = time.perf_counter()
    wave = halo_wave(dev, torch.float64, 3)
    print(f"K1 halo form: the card holds {wave} of its blocks at once (occupancy x SMs), the plans' wave")
    # -- (a) K1's halo form over k loopback blocks, bit for bit with K1 on
    # the whole grid; 129^3 nodes are phantom-padded to divisibility
    for element, n in (("hex", 128), ("quad", 1023)):
        W, params = problem(element, n, dev)[:2]
        shape = W.mesh.node_shape
        S = dpp_stencils(W.mesh, params)
        z = torch.stack([randn(shape), randn(shape)])
        for mesh_shape in HALO_MESHES:
            pad = [(-m) % s for m, s in zip(shape, mesh_shape)] + [0] * (len(shape) - len(mesh_shape))
            zp = F.pad(z, [v for p in reversed(pad) for v in (0, p)])
            crop = (slice(None),) + tuple(slice(0, m) for m in shape)
            for mode in ("matvec", "lift"):
                want = zp.clone()  # phantom rows: identity
                want[crop] = fused_dpp_apply_stacked(z, *S, mode=mode)
                got = loopback_apply(zp, S, mesh_shape, mode, n_phys=shape)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"K1 halo form {element} N={n} blocks {mesh_shape} {mode}: "
                                              "equal to K1 on the whole grid bit for bit")
            print(f"K1 halo form {element} N={n} on {len(shape)}D blocks {mesh_shape} (padded {tuple(zp.shape[1:])}): "
                  "matvec and lift bit for bit with K1 on the whole grid")
        # with no ghost, offset or padding the halo form is K1, in both
        # entries, and so is the first form (the probe)
        for mode in ("matvec", "lift"):
            k1 = fused_dpp_apply_stacked(z, *S, mode=mode)
            check(torch.equal(fused_dpp_apply_halo(z, *S, mode=mode), k1)
                  and torch.equal(fused_dpp_apply_halo_planes(z[0], z[1], (), *S, mode=mode), k1)
                  and torch.equal(halo_probe_apply(probe, z, S, mode), k1),
                  f"K1 halo form {element} N={n} {mode} with no ghost: K1's bits (both entries, the probe)")
        # the times in turns with the first form (probe, this, this, probe;
        # f64 matvecs, launches queued): 8 slabs of the padded grid, one
        # launch a slab (the kernel line's shape); in 3D also one slab
        # alone, the padded box and the whole box with no ghost, beside K1
        k = 8
        pad = [(-shape[0]) % k] + [0] * (len(shape) - 1)
        zp = F.pad(z, [v for p in reversed(pad) for v in (0, p)])
        split = split_blocks(zp, (k,))
        planes = loopback_planes(split, (k,))
        boxes = {c: halo_box(b, planes[c]) for c, b in split.items()}
        local = [zp.shape[1] // k] + list(shape[1:])
        geoms = {c: block_geometry((k,), c, local, shape) for c in split}

        def slabs(cs, first=False, plain=False):
            if first:
                return {c: halo_probe_apply(probe, boxes[c], S, "matvec", *geoms[c]) for c in cs}
            fn = fused_dpp_apply_halo_planes_plain if plain else fused_dpp_apply_halo_planes
            return {c: fn(split[c][0], split[c][1], planes[c], *S, "matvec", *geoms[c][1:]) for c in cs}

        every = list(split)
        y = join_blocks(slabs(every), (k,))
        yp = join_blocks(slabs(every, plain=True), (k,))
        err = float((y - yp).abs().max())
        check(err <= 1e-13 * float(yp.abs().max()), f"K1 halo form {element} N={n}: against its twin")
        check(torch.equal(y, join_blocks(slabs(every, first=True), (k,))), f"K1 halo form {element} N={n}: "
              "the first form's bits")
        owned = int(np.prod(local))
        per_row = matvec_flops(W.mesh, params) // W.mesh.num_interior_vertices

        def plan(box, geom):
            return halo_plan(tuple(box.shape[1:]), *geom, wave=wave)

        shapes = {f"{k} slabs": (lambda: slabs(every), lambda: slabs(every, first=True),
                                 halo_bytes(owned * k, [p for c in every for p in planes[c]]),
                                 matvec_flops(W.mesh, params), [plan(boxes[c], geoms[c]) for c in every])}
        if element == "hex":
            mid = (3,)
            mid_plan = plan(boxes[mid], geoms[mid])
            shapes["one slab"] = (lambda: slabs([mid]), lambda: slabs([mid], first=True),
                                  halo_bytes(owned, planes[mid]),
                                  per_row * int(np.prod([hi - lo for lo, hi in zip(mid_plan.c0, mid_plan.c1)])),
                                  [mid_plan])
            shapes["padded box"] = (
                lambda: fused_dpp_apply_halo_planes(zp[0], zp[1], (), *S, n_phys=shape),
                lambda: halo_probe_apply(probe, zp, S, "matvec", None, None, shape),
                halo_bytes(zp[0].numel(), []), matvec_flops(W.mesh, params), [plan(zp, (None, None, shape))])
            shapes["whole box"] = (lambda: fused_dpp_apply_halo(z, *S), lambda: halo_probe_apply(probe, z, S),
                                   halo_bytes(z[0].numel(), []), matvec_flops(W.mesh, params),
                                   [plan(z, (None, None, None))])
        tag = f"{element}{n}"
        for label, (this, first, nbytes, flops, plans) in shapes.items():
            runs = {"first": first, "this": this, "K1": lambda: fused_dpp_apply_stacked(z, *S)}
            order = ("first", "this", "K1", "K1", "this", "first") if label == "whole box" else \
                ("first", "this", "this", "first")
            t = in_turns(runs, order)
            b = bound(nbytes, flops)
            blocks = sorted({(p.blocks, p.chunk) for p in plans})
            results[f"fused_dpp_apply_halo@{tag} {label}"] = dict(ms=statistics.mean(t["this"]), turns=t, bound=b,
                                                                 blocks=blocks)
            print(f"K1 halo form {element} N={n} {label} ({len(plans)} launch(es); blocks (z, y, x) and chunk "
                  f"{blocks}): in turns {turns_text(order, t)} ms; bound {b[0]:.6f} ms ({b[1]}, {nbytes} B) "
                  f"(CUDA events, launches queued) on {smi}")
        slab8 = results[f"fused_dpp_apply_halo@{tag} {k} slabs"]
        results[f"fused_dpp_apply_halo@{tag}"] = dict(
            max_abs_err=err, ms=slab8["ms"], bound=slab8["bound"],
            plain_ms=time_ms(lambda: slabs(every, plain=True), repeats=5),
            k1_ms=queued_ms(lambda: fused_dpp_apply_stacked(z, *S), calls=20),
            shape=f"{element} {'x'.join(map(str, zp.shape[1:]))} in {k} slabs, {k} launches, f64 matvec",
        )
        if element == "hex":
            # the library yardstick: one conv3d of the interior-masked
            # stacked fields with the stencil weight, as for K1
            inner = ~box_boundary(shape, dev)
            zin = torch.stack([torch.where(inner, z[0], 0.0), torch.where(inner, z[1], 0.0)])[None].contiguous()
            S1, S2, C = S
            wt = torch.tensor(np.stack([np.stack([S1, C]), np.stack([C, S2])]), device=dev)
            results["fused_dpp_apply_halo"] = dict(
                results[f"fused_dpp_apply_halo@{tag}"],
                library_ms=queued_ms(lambda: F.conv3d(zin, wt, padding=1), calls=10),
            )
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 14 (a) done")

    # -- (b) the blocked Picard iteration's kernels over 1, 2, 4 and 8
    # loopback slabs and (2, 2) pencils of 2D N=128, phantom-padded, the
    # neighbours read in place (and, on 8 slabs and the pencils, through the
    # exchange buffers, copied in memory): a sweep of every colour
    # (ngs_colour_halo, a launch a colour over every block) and the norm
    # with its residuals and the stop test (ngs_colour_norm), bit for bit
    # with the twins on the card and, the norm, with the first norm kernel
    # (the probe); a colour step's time over all the blocks and the norm's
    # in turns with the probe's (launches queued), the twins' beside, the
    # bounds
    Wq, pq = problem("quad", 128, dev)[:2]
    sweeper = ColoredNGSSweeper(Wq.mesh, pq, dev)
    qshape = Wq.mesh.node_shape
    xq, bq = (torch.stack([randn(qshape), randn(qshape)]) for _ in range(2))
    colour_err = norm_err = 0.0
    for ms, remote in COLOUR_LAYOUTS:
        pad = [(-n) % s for n, s in zip(qshape, ms)] + [0] * (2 - len(ms))
        grid = (qshape[0] + pad[0], qshape[1] + pad[1])
        L = LoopbackBlocks(ms)
        xs, bs = (L.cut(F.pad(t, [0, pad[1], 0, pad[0]]), lead=1) for t in (xq, bq))
        runs = {}
        for plain in (False, True):
            sweep = NgsSweep(sweeper, grid, L, remote=remote, plain=plain)
            sweep.reset(0.0, 0.0, 2 ** 30)  # tol 0: never done, so that every launch runs
            sweep.load(bs, xs)
            for colour in range(sweeper.ncolors):
                sweep.step(colour)
            r = {c: torch.empty_like(v) for c, v in xs.items()}
            sweep.norm(init=True, residuals=r)
            torch.cuda.synchronize()
            runs[plain] = (sweep, L.join(sweep.x), L.join(r), float(sweep.state[NGS_FN]))
        (kern, xk, rk, fk), (twin, xt, rt, ft) = runs[False], runs[True]
        # the first norm kernel on the same sweep's iterate, its own state
        first = FirstNormSweep(norm_probe, sweeper, grid, L, remote=remote)
        first.reset(0.0, 0.0, 2 ** 30)
        first.load(bs, xs)
        for colour in range(sweeper.ncolors):
            first.step(colour)
        rp = {c: torch.empty_like(v) for c, v in xs.items()}
        first.norm(init=True, residuals=rp)
        torch.cuda.synchronize()
        rp, fp = L.join(rp), float(first.state[NGS_FN])
        colour_err = max(colour_err, float((xk - xt).abs().max()))
        norm_err = max(norm_err, float((rk - rt).abs().max()), abs(fk - ft))
        where = f"2D N=128 over loopback {ms}{' through the exchange buffers' if remote else ''}"
        check(torch.equal(xk, xt), f"ngs_colour_halo {where}: a sweep bit for bit with the twin")
        check(torch.equal(rk, rt) and fk == ft, f"ngs_colour_norm {where}: residuals and norm bit for bit")
        check(torch.equal(L.join(first.x), xk) and torch.equal(rp, rt) and fp == ft,
              f"ngs_colour_norm {where}: the first norm kernel's bits")

        def steps(s):
            for colour in range(sweeper.ncolors):
                s.step(colour)

        # the buffers' exchange is torch copies issued from the host: fewer calls fit behind the sleep
        step_ms = queued_ms(lambda: steps(kern), calls=3 if remote else 20) / sweeper.ncolors
        norm_order = ("first", "this", "this", "first")
        norm_turns = in_turns({"first": first.norm, "this": kern.norm}, norm_order, calls=50)
        norm_ms = statistics.mean(norm_turns["this"])
        if ms == (1,):  # the twins timed on the kernel line's shape
            twin_step_ms = time_ms(lambda: steps(twin), repeats=3) / sweeper.ncolors
            twin_norm_ms = time_ms(twin.norm, repeats=3)
        # the bounds of the mean step (step_ms is the mean over the colours)
        # and of the norm, from the rows and the blocks
        work = [tuple(map(sum, zip(*(colour_step_work(kern.parts[c], colour) for c in L.coords))))
                for colour in range(sweeper.ncolors)]
        step_bound = bound(sum(w[0] for w in work) / sweeper.ncolors, sum(w[1] for w in work) / sweeper.ncolors)
        norm_bound = bound(*norm_work(kern))
        rows = [end - start for start, _, end in kern.spans]
        print(f"ngs_colour_halo {where} (padded {grid}): bit for bit with the twin; {step_ms:.4f} ms a colour step "
              f"of all {len(L.coords)} block(s) (one launch; {min(rows)}-{max(rows)} rows a colour; launches queued), "
              f"bound {step_bound[0]:.6f} ms ({step_bound[1]}); ngs_colour_norm bit for bit with the twin and the "
              f"first norm kernel, in turns {turns_text(norm_order, norm_turns)} ms ({kern.ctas} tree CTAs), "
              f"bound {norm_bound[0]:.6f} ms ({norm_bound[1]}) (CUDA events, launches queued) on {smi}")
        if ms == (1,):  # the kernel line's shape: the main path's one block
            shape = f"2D N=128 (a 2 x 129 x 129 block, {sweeper.ncolors} colours), f64"
            results["ngs_colour_halo"] = dict(ms=step_ms, plain_ms=twin_step_ms, bound=step_bound, library_ms=None,
                                              shape="one colour step of " + shape)
            results["ngs_colour_norm"] = dict(ms=norm_ms, plain_ms=twin_norm_ms, bound=norm_bound, library_ms=None,
                                              shape="the norm and stop test of " + shape)
            print(f"  the twins on that block: a colour step {twin_step_ms:.4f} ms, the norm {twin_norm_ms:.4f} ms "
                  f"(CUDA events) on {smi}")
    results["ngs_colour_halo"]["max_abs_err"] = colour_err
    results["ngs_colour_norm"]["max_abs_err"] = norm_err
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 14 (b) done")

    # -- (c) the blocked fast-diag (f64) and mixed-precision direct solves
    # over loopback slabs and pencils of 128^3 hex (TPU_DIRECT_PARAMS' solver
    # at full width), phantom-padded, against the whole-grid solves; the
    # all-to-all moves' time (the f32 transform's, forward and back)
    Wh, ph = problem("hex", 128, dev)[:2]
    hshape = Wh.mesh.node_shape
    bh = torch.stack([randn(hshape), randn(hshape)])
    Sh = dpp_stencils(Wh.mesh, ph)
    fd64 = FastDiagDPPSolver(Wh.mesh, ph, device=dev)
    whole_fd = torch.stack(fd64.solve(bh[0], bh[1]))
    mixed = MixedPrecisionDPPDirect(Wh.mesh, ph, device=dev)
    whole = torch.stack(mixed.solve(bh[0], bh[1]))
    whole_ms = time_ms(lambda: mixed.solve(bh[0], bh[1]), repeats=3)
    hcrop = (slice(None),) + tuple(slice(0, m) for m in hshape)
    for mesh_shape in ((2,), (4,), (8,), (2, 2)):
        pad = tuple([(-m) % s for m, s in zip(hshape, mesh_shape)] + [0] * (3 - len(mesh_shape)))
        L = LoopbackBlocks(mesh_shape)
        bs = L.cut(F.pad(bh, [v for p in reversed(pad) for v in (0, p)]), lead=1)
        e_fd = rel(L.join(fd64.solve_blocks(bs, L, pad))[hcrop], whole_fd)
        m = MixedPrecisionDPPDirect(Wh.mesh, ph, device=dev, padding=pad)
        COLLECTIVES.clear()
        z = L.join(m.solve_blocks(bs, L))[hcrop].contiguous()
        moved = COLLECTIVES["all_to_all"]
        e = rel(z, whole)
        y = fused_dpp_apply_stacked(z, *Sh, mode="matvec")
        rres = float(torch.linalg.vector_norm(bh - y) / torch.linalg.vector_norm(bh))
        check(e_fd <= 1e-12 and e <= 1e-12 and rres < 1e-10,
              f"blocked direct 128^3 over {mesh_shape}: fast-diag {e_fd:.2e}, mixed {e:.2e} of the whole grid, "
              f"f64 relative residual {rres:.2e}")
        moves = [st for st in _fd_blocks(m.fast32, L, pad).steps if isinstance(st, Move)]
        x32 = {c: v.float() for c, v in bs.items()}

        def shuffle():
            y = x32
            for mv in moves:
                y = L.regrid(y, mv, 1)
            for mv in reversed(moves):
                y = L.regrid(y, mv.inverse(), 1)
            return y

        moves_ms = time_ms(shuffle, repeats=5)
        blocked_ms = time_ms(lambda: m.solve_blocks(bs, L), repeats=3)
        print(f"blocked direct hex 128^3 over loopback {mesh_shape} (padded {tuple(n + p for n, p in zip(hshape, pad))}): "
              f"f64 fast-diag {e_fd:.2e}, mixed {e:.2e} of the whole-grid solves, f64 relative residual {rres:.3e}; "
              f"{moved} all-to-all moves a solve; the f32 transform's {len(moves)} move(s) forward and back "
              f"{moves_ms:.3f} ms; the blocked mixed solve {blocked_ms:.3f} ms beside the whole grid's "
              f"{whole_ms:.3f} ms (CUDA events, one process) on {smi}")
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 14 (c) done")

    # -- (c2) the degree-p parts on blocks at full width
    t_c2 = time.perf_counter()
    degree_p_blocks(dev, smi, randn)
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 14 (c2) done: {time.perf_counter() - t_c2:.1f} s")

    # -- (d) a world of one NCCL rank: the six dry-run paths
    store = rendezvous_store(1)  # bound to a port the system picks, held until the group ends
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    check(dist.get_backend() == "nccl", "the world of one runs NCCL")
    published = multichip_counts()
    cases = dryrun_cases([1, 1], dev)
    singles = [solve_case(c, False) for c in cases]  # the single-device solves on the card, not counted
    full = []
    for element, n, preset, nonlinear in FULL_WIDTH:
        Wf, pf, bf, _, _ = problem(element, n, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = (solve_dpp_nonlinear if nonlinear else solve_dpp)(Wf, pf, bf, solver_parameters=presets()[preset])
        torch.cuda.synchronize()
        full.append((element, n, preset, nonlinear, Wf, pf, bf, ref, time.perf_counter() - t0))
    # the blocked Picard iteration on the rank's block at 2D N=64, driven
    # through blocked_ngs itself: the world of one takes fused_ngs by the
    # route's rule (solver.py::ngs_on_one_rank_whole)
    picard = presets()["PICARD_LU_SOLVER_PARAMS"]
    tols = (float(picard["snes_rtol"]), float(picard["snes_atol"]), int(picard["snes_max_it"]))
    Wb, pb, bcb, _, _ = problem("quad", 64, dev)
    opb = DPPOperator(Wb, pb)
    b64, x064 = picard_inputs(opb, bcb)
    rank_blocks = device_mesh([1, 1], axis_names=("y", "x"), device=dev).blocks()
    rank_sweep = NgsSweep(ColoredNGSSweeper(Wb.mesh, pb, dev), Wb.mesh.node_shape, rank_blocks)
    rank_c = rank_blocks.coords[0]
    _cuda.KERNEL_LAUNCHES.clear()
    records, walls = [], []
    for case, single in zip(cases, singles):
        records.append(sharded_record(case, single))
    # the blocked route of the linear paths on the rank's block
    # (blocked_solve_dpp: _run_parts on the rank's RankBlocks), which the
    # world of one does not take (linear_on_one_rank_whole)
    blocked_records = [sharded_record(case, single, blocked=True) for case, single in zip(cases, singles)
                       if not case[4]]
    for element, n, preset, nonlinear, Wf, pf, bf, ref, ref_wall in full:
        dm = device_mesh([1, 1], axis_names=("z", "y") if element == "hex" else ("y", "x"))
        torch.cuda.synchronize()
        COLLECTIVES.clear()
        t0 = time.perf_counter()
        fn = sharded_solve_dpp_nonlinear if nonlinear else sharded_solve_dpp
        sol = fn(Wf, pf, bf, dm, solver_parameters=presets()[preset])
        torch.cuda.synchronize()
        walls.append((element, n, preset, nonlinear, Wf, pf, bf, ref, ref_wall, sol, time.perf_counter() - t0,
                      dict(COLLECTIVES)))
    blocked64 = blocked_ngs(rank_sweep, {rank_c: b64}, {rank_c: x064}, *tols)
    counts = dict(_cuda.KERNEL_LAUNCHES)
    print(f"multi-device path kernel launches (the six paths, the full-width solves and the blocked Picard "
          f"iteration at 2D N=64 on the rank's block): {counts}")
    for name in ("fused_dpp_apply_halo", "structured_ilu_apply", "ngs_colour_halo", "ngs_colour_norm"):
        check(counts.get(name, 0) > 0, f"{name} launched on the multi-device path")
    # K2: once a world-of-one direct solve whose mesh its gate takes (the
    # single-device route); the blocked route never takes it
    k2_solves = sum(c[0] == "direct-fastdiag-3d" and fused_direct_supported(DPPOperator(c[1], DPPParameters()))
                    for c in cases)
    check(counts.get("fused_direct_solve", 0) == k2_solves,
          f"fused_direct_solve launched once a world-of-one direct solve its gate takes ({k2_solves}), "
          f"none on blocks: got {counts.get('fused_direct_solve', 0)}")
    # fused_ngs: once a Picard ngs solve on the world of one (the dry run's
    # and the two full-width ones), by the route's rule, and nowhere else
    picard_solves = sum(c[0] == "picard-ngs-2d" for c in cases) + sum(w[3] for w in walls)
    check(counts.get("fused_ngs", 0) == picard_solves,
          f"fused_ngs launched once a world-of-one Picard solve ({picard_solves}), got {counts.get('fused_ngs', 0)}")
    check(blocked64.iterations == PICARD_COUNTS[64], f"the blocked Picard iteration at 2D N=64 on the rank's block: "
          f"{blocked64.iterations} iterations, published {PICARD_COUNTS[64]}")
    _, W3, _, _, _, dm3 = cases[0]
    records.append(dict(label="halo", **benchmark_vs_gathered(DPPOperator(W3, DPPParameters()), dm3, reps=3)))
    check_paths(records)
    check_paths(blocked_records + records[-1:])
    for r in records[:-1]:
        print(f"world of one NCCL rank [{r['label']}]: its={r['its']} (single-device on the card "
              f"{r['single_its']}, {MULTICHIP_RECORD} {published[r['label']]}), max rel diff {r['rel_diff']:.2e}; "
              f"collectives {collectives_text(r['collectives'], r['its'])}")
        check(r["its"] == published[r["label"]], f"{r['label']}: the JAX dry run's count")
        # the world of one runs the single-device solves: no collective
        check(not any(r["collectives"].values()), f"{r['label']}: no collective on the world of one")
    for r in blocked_records:
        print(f"world of one NCCL rank, the blocked route [{r['label']}]: its={r['its']} (single-device "
              f"{r['single_its']}), max rel diff {r['rel_diff']:.2e}; collectives "
              f"{collectives_text(r['collectives'], r['its'])}")
        check(r["its"] == published[r["label"]], f"{r['label']} on the blocked route: the JAX dry run's count")
        # one all-gather, the solution's, where every part keeps its blocks;
        # the gathered ILU one more an application
        gathers = r["collectives"].get("all_gather", 0)
        check(gathers > 1 if "ilu" in r["label"] else gathers == 1,
              f"{r['label']} on the blocked route: {gathers} all-gathers")
    print(f"halo matvec against K1 on the gathered vector: diff {records[-1]['max_abs_diff']:.2e}, "
          f"halo {records[-1]['halo_s'] * 1e3:.4f} ms, gathered {records[-1]['gathered_s'] * 1e3:.4f} ms a call")
    # one sharded apply (stacked_halo_apply) at 64^3 and 128^3 beside the
    # first form's (the block extended whole, then the probe): host wall of
    # a call and a synchronise (median of 50), device time (launches queued)
    for n in (64, 128):
        Wn, pn = problem("hex", n, dev)[:2]
        op = DPPOperator(Wn, pn)
        dm = device_mesh([1, 1], axis_names=("z", "y"))
        x = torch.stack([randn(Wn.mesh.node_shape), randn(Wn.mesh.node_shape)])
        runs = {"first": lambda: first_form_apply(op, dm, probe)(x), "this": lambda: stacked_halo_apply(op, dm)(x)}
        check(torch.equal(runs["this"](), runs["first"]()) and torch.equal(runs["this"](), op.stacked_matvec()(x)),
              f"sharded apply hex {n}^3: the first form's bits and K1's")
        apply_first, apply_this = first_form_apply(op, dm, probe), stacked_halo_apply(op, dm)
        runs = {"first": lambda: apply_first(x), "this": lambda: apply_this(x)}

        def wall(fn, reps=50):
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)

        order = ("first", "this", "this", "first")
        t = in_turns(runs, order)
        host = {name: [] for name in runs}
        for name in order:
            host[name].append(wall(runs[name]))
        results[f"stacked_halo_apply@hex{n}"] = dict(device=t, wall=host)
        print(f"sharded apply hex {n}^3 on a world of one NCCL rank (mesh (1, 1)): device in turns "
              f"{turns_text(order, t)} ms (CUDA events, launches queued); host wall a call "
              f"{turns_text(order, host)} ms (median of 50, synchronised) on {smi}")

    # -- (d2) the whole Picard solve at 2D N=64 / 128 in turns (host wall, a
    # solve from its start to its result on the host): the blocked iteration
    # on the rank's block ("this") and over 8 loopback slabs of the
    # phantom-padded grid ("slabs"), the first blocked loop on the rank's block
    # ("first": the probe kernel, a launch a colour and a norm read back every
    # iteration), the blocked iteration on the rank's block with the first
    # norm kernel ("first norm": norm_probe), and fused_ngs ("fused", the
    # world of one's route); all land the published count with the same
    # iterate, bit for bit (the fused kernel held to its twin in phase 9)
    ngs_probe = probe_library()
    picard_walls = {}
    for n in (64, 128):
        Wp, pp, bcp, _, _ = problem("quad", n, dev)
        opp = DPPOperator(Wp, pp)
        b, x0 = picard_inputs(opp, bcp)
        swp = ColoredNGSSweeper(Wp.mesh, pp, dev)
        shape = Wp.mesh.node_shape
        fused = FusedNGSSolver(opp, swp, *tols)
        sweep1 = NgsSweep(swp, shape, rank_blocks)
        sweep_first = FirstNormSweep(norm_probe, swp, shape, rank_blocks)
        parts1 = {rank_c: NgsBlock(swp, shape, rank_blocks.mesh_shape, rank_c)}
        pad = (-shape[0]) % 8
        grid8 = (shape[0] + pad, shape[1])
        L8 = LoopbackBlocks((8,))
        sweep8 = NgsSweep(swp, grid8, L8)
        b8, x08 = (L8.cut(F.pad(t, [0, 0, 0, pad]), lead=1) for t in (b, x0))
        runs = {
            "first": lambda: blocked_ngs_probe(ngs_probe, rank_blocks, parts1, {rank_c: b}, {rank_c: x0.clone()},
                                              *tols),
            "this": lambda: blocked_ngs(sweep1, {rank_c: b}, {rank_c: x0}, *tols),
            "first norm": lambda: blocked_ngs(sweep_first, {rank_c: b}, {rank_c: x0}, *tols),
            "slabs": lambda: blocked_ngs(sweep8, b8, x08, *tols),
            "fused": lambda: fused(b, x0),
        }
        # the first loop (seconds at N=128) takes the middle turn once there
        order = (("first", "this", "first norm", "slabs", "fused", "fused", "slabs", "first norm", "this", "first")
                 if n == 64 else ("this", "first norm", "slabs", "fused", "first", "fused", "slabs", "first norm",
                                  "this"))
        fused(b, x0)  # its tables are built at its first launch
        times, out = {}, {}
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runs[name]()
            torch.cuda.synchronize()
            times.setdefault(name, []).append(time.perf_counter() - t0)
            x = res.x if name == "fused" else (L8.join(res.x)[:, :shape[0]] if name == "slabs" else res.x[rank_c])
            out.setdefault(name, (res.iterations, x))
        for name, (its, x) in out.items():
            check(its == PICARD_COUNTS[n] and torch.equal(x, out["fused"][1]),
                  f"Picard 2D N={n} [{name}]: {its} iterations, the published {PICARD_COUNTS[n]}, fused_ngs's iterate")
        picard_walls[n] = times
        print(f"Picard 2D N={n} PICARD_LU_SOLVER_PARAMS, {PICARD_COUNTS[n]} iterations each, bit for bit: in turns "
              + " / ".join(f"{name} {times[name][k]:.4f}" for name, k in
                           zip(order, [order[:i].count(nm) for i, nm in enumerate(order)]))
              + f" s (host clock, a solve; every {ITERATIONS_PER_READ} iterations read back) on {smi}")
        # the world of one's rule (solver.py::ngs_on_one_rank_whole) takes
        # fused_ngs here: it must be the faster
        check(max(times["fused"]) < min(times["this"]), f"Picard 2D N={n}: fused_ngs faster than the blocked "
                                                        "iteration on the world of one, as the route's rule says")

    # -- (e) full width: the residual guard and the published counts
    for element, n, preset, nonlinear, Wf, pf, bf, ref, ref_wall, sol, wall, coll in walls:
        z1, z2 = sol.solution.data
        check(bool(torch.isfinite(z1).all() and torch.isfinite(z2).all()), "finite solution")
        check(z1.device == dev and tuple(z1.shape) == Wf.mesh.node_shape, "solution on the card")
        S = dpp_stencils(Wf.mesh, pf)
        g1, g2 = (bc.grid_values(Wf.mesh) for bc in bf)
        b1, b2 = fused_dpp_apply_plain(g1, g2, *S, mode="lift")
        y1, y2 = fused_dpp_apply_plain(z1, z2, *S, mode="matvec")
        rres = math.sqrt(float(((b1 - y1) ** 2).sum() + ((b2 - y2) ** 2).sum())) / math.sqrt(
            float((b1 ** 2).sum() + (b2 ** 2).sum()))
        diff = max(rel(a, b) for a, b in zip(sol.solution.data, ref.solution.data))
        its = sol.iteration_number
        print(f"sharded {element} N={n} {preset} on a world of one NCCL rank: its={its} "
              f"(single-device {ref.iteration_number}), f64 rel residual {rres:.3e}, max rel diff vs single-device "
              f"{diff:.2e}, wall {wall:.3f} s beside the single-device solve's {ref_wall:.3f} s; collectives "
              f"{collectives_text(coll, its)} on {smi}")
        # the world of one runs whole: the linear solves (linear_on_one_rank_whole)
        # and the quad Picard ngs (ngs_on_one_rank_whole); no collective
        whole = (ngs_on_one_rank_whole(Wf, _freeze(presets()[preset]), 1) if nonlinear else
                 linear_on_one_rank_whole(1))
        check(whole and not any(coll.values()), f"sharded {element} N={n} {preset}: the single-device route, "
                                                f"no collective, got {coll}")
        if not nonlinear:
            # the route's rule: the single-device solve against the blocked
            # route on the rank's block, in turns (blocked, whole, blocked,
            # whole; host clock, a solve: the first blocked one builds its
            # parts); the blocked route lands the same count
            dm = device_mesh([1, 1], axis_names=("z", "y") if element == "hex" else ("y", "x"))
            sp_ = presets()[preset]
            runs = {"whole": lambda: sharded_solve_dpp(Wf, pf, bf, dm, solver_parameters=sp_),
                    "blocked": lambda: blocked_solve_dpp(Wf, pf, bf, dm, solver_parameters=sp_)}
            order = ("blocked", "whole", "blocked", "whole")
            route_walls, outs = {name: [] for name in runs}, {}
            for name in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = runs[name]()
                torch.cuda.synchronize()
                route_walls[name].append(time.perf_counter() - t0)
            bdiff = max(rel(a, b) for a, b in zip(outs["blocked"].solution.data, ref.solution.data))
            check(outs["blocked"].iteration_number == ref.iteration_number,
                  f"sharded {element} N={n} {preset}: the blocked route's count")
            check(all(torch.equal(a, b) for a, b in zip(outs["whole"].solution.data, ref.solution.data)),
                  f"sharded {element} N={n} {preset}: the world of one is solve_dpp bit for bit")
            results[f"world-of-one@{element}{n} {preset}"] = route_walls
            print(f"sharded {element} N={n} {preset} on a world of one NCCL rank, the two routes in turns: "
                  + " / ".join(f"{name} {route_walls[name][order[:i].count(name)]:.4f}" for i, name in enumerate(order))
                  + f" s (host clock, a solve); the blocked route {outs['blocked'].iteration_number} iterations, "
                  f"fields {bdiff:.2e} of the single-device solve's, on {smi}")
            # the Krylov presets differ by 10-100x (K4/K6 against the host
            # loop); the direct solve is the same fast-diag on both routes,
            # apart by less than the runs' spread (0.041-0.079 s against
            # 0.049-0.095 s warm in two runs): no slower than the blocked
            # route by more than that
            slack = 1.5 if preset == "TPU_DIRECT_PARAMS" else 1.0
            check(min(route_walls["whole"]) < slack * min(route_walls["blocked"]),
                  f"sharded {element} N={n} {preset}: the single-device route faster (direct: within {slack}x), "
                  "as the route's rule says")
        want = FULL_WIDTH_COUNTS.get((element, n, preset))
        if preset == "TPU_DIRECT_PARAMS":
            check(rres < 1e-10, f"sharded {element} N={n} residual")
        else:
            check(its == want == ref.iteration_number, f"sharded {element} N={n} {preset} lands the published {want}")
    dist.destroy_process_group()

    # -- (f) the scaling harness: a world of one NCCL rank of its own
    rows = run_scaling(modes=("strong",), device_counts=(1,), base_n=64, dim=2, repeats=1, device=dev)
    for r in rows:
        print(f"scaling row: {json.dumps(r.to_dict())}")
        check(r.iteration_parity and r.measurement_class == "gpu-nccl", f"scaling {r.approach}: parity on the card")
    print(f"[{time.perf_counter() - t_start:.1f} s] multi-device path done: phase 14 "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


# K8's two inner modes and the ring kernel the line pipeline replaced (the
# probe, literal blocks) in turns, and at 2D N=128 the literal host route of
# the same semantics (krylov.gmres, K1, the fieldsplit with the blocks' own
# GMRES + structured_ilu_apply) in turns with the literal kernel
K8_TURN_NS = (16, 64, 128)
K8_ORDER = ("literal", "ring", "pcg", "pcg", "ring", "literal")


class RoleCase(collections.namedtuple(
        "RoleCase", "element n pc role tol reps host_preset twin_its inner early",
        defaults=("literal", False))):
    """One fused GMRES role case: element, N, pc, role (None: the pc's),
    bound on the rel diff to the twin, kernel repeats, the host loop's preset
    where the TPU's gate sent the case there (None: no host-loop run), max_it
    of the twin's comparison where the whole twin would take long (None: the
    whole solve), K8's inner block solve, and whether the twin runs on the
    card while nvcc builds (the long ones: ``role_twin_remote``)."""


ROLE_CASES = [
    RoleCase("quad", 8, "none", "fused_gmres_ef64", 0.0, 5, None, None),
    RoleCase("quad", 16, "none", None, 0.0, 5, None, None),
    RoleCase("quad", 64, "none", None, 0.0, 3, None, None),
    RoleCase("quad", 64, "jacobi", None, 0.0, 3, None, None),
    RoleCase("tet", 16, "none", None, 0.0, 3, None, None),
    RoleCase("quad", 64, "ilu", None, 0.0, 3, None, None),
    RoleCase("quad", 64, "fieldsplit_lu", None, 1e-10, 3, None, None),
    RoleCase("tet", 8, "fieldsplit_lu", None, 1e-10, 3, None, None),
    RoleCase("quad", 16, "fieldsplit_ilu", None, 1e-12, 3, None, None),
    RoleCase("quad", 64, "fieldsplit_ilu", None, 0.0, 3, None, None),
    RoleCase("quad", 64, "fieldsplit_ilu", None, 0.0, 3, None, None, "pcg", True),  # the TPU's PCG blocks
    # the first outer step at N=128 (the kernel's inner basis in device
    # memory, ~90 inner steps a block solve); k8_turns times the whole solve
    RoleCase("quad", 128, "fieldsplit_ilu", None, 0.0, 1, None, 1, "literal", True),
    RoleCase("tet", 8, "fieldsplit_ilu", None, 0.0, 3, None, None),  # 3D fields: the ring
    # the published sizes the TPU's gate leaves to the host loop (8, 8,
    # 32 and 8 leaves a thread in 2D); the host loop timed beside each
    RoleCase("quad", 128, "none", None, 0.0, 3, "PLAIN_GMRES_PARAMS", None, early=True),
    RoleCase("quad", 128, "ilu", None, 0.0, 3, "GMRES_ILU_PARAMS", None, early=True),
    RoleCase("quad", 256, "ilu", None, 0.0, 3, "GMRES_ILU_PARAMS", 20, early=True),
    RoleCase("tet", 32, "none", None, 0.0, 3, "PLAIN_GMRES_PARAMS", None, early=True),  # 16 leaves
    RoleCase("tet", 40, "none", None, 0.0, 3, "PLAIN_GMRES_PARAMS", None, early=True),  # 32 leaves
    # 3D preconditioned at 16 leaves: K6's eigenbases outside shared memory
    RoleCase("tet", 32, "fieldsplit_lu", None, 1e-10, 3, "SS-GMRES", None),
]


def role_twin(case, dev, gmres_kw):
    """One role case's problem and its twin's run on the card: the operator,
    the solver's right-hand side (by K1's twin: no kernel, so that it can run
    before the build), the compared solver (max_it ``twin_its`` where the
    case gives one), the twin's result and time (CUDA events), and its inner
    block solves (iterations, solves), all of them and without its repeated
    first application: ``krylov.gmres`` applies P(b - A x0) twice (the first
    norm, then the first cycle), the kernel once."""
    from perphil_tpu_torch.ops.assembly import DPPOperator
    from perphil_tpu_torch.ops.fused_gmres import FusedGMRESSolver

    W, params, bcs, _, _ = problem(case.element, case.n, dev)
    op = DPPOperator(W, params)
    r = newton_rhs(op, bcs, plain=True)  # the kernel takes the same r
    max_it = gmres_kw["max_it"] if case.twin_its is None else case.twin_its
    cmp = FusedGMRESSolver(op, case.pc, case.role, **{**gmres_kw, "max_it": max_it}, inner_ksp=case.inner)
    seen = []  # the inner counts after each application of the twin's preconditioner
    plain_pc = cmp.plain_pc

    def counted():
        pc = plain_pc()
        if pc is None:
            return None

        def apply(v):
            y = pc(v)
            seen.append((cmp.inner_iterations, cmp.inner_solves))
            return y

        return apply

    cmp.plain_pc = counted
    try:
        ref, plain_ms = timed_once(lambda: cmp.plain(r))
    finally:
        del cmp.plain_pc
    twin = (cmp.inner_iterations, cmp.inner_solves)
    once = (twin[0] - seen[0][0], twin[1] - seen[0][1]) if seen else twin
    return op, r, cmp, ref, plain_ms, twin, once


def role_twin_remote(case, gmres_kw):
    """``role_twin`` on the card in a worker process, while nvcc builds: the
    right-hand side and the twin's x (on the host), count, residual,
    convergence, time and inner counts. A worker launches no kernel (its
    process has no library built)."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(HERE))
    from perphil_tpu_torch.ops import _cuda

    _, r, _, ref, plain_ms, twin, once = role_twin(case, torch.device("cuda", torch.cuda.current_device()), gmres_kw)
    check(_cuda._LIB is None, f"the twin of {case} launched no kernel")
    return (r.cpu().numpy(), ref.x.cpu().numpy(), ref.iterations, ref.residual_norm, ref.converged, plain_ms,
            twin, once)


def k8_turns(dev, smi, gmres_kw, probe):
    """Times K8 in its two inner modes in turns with the ring kernel
    (``probe``: ``fused_gmres.k8_probe_library``, literal blocks, bit for bit
    with the package's) at 2D N=16/64/128 on the solver's own right-hand
    side, with each mode's outer and inner counts and the literal kernel's
    bound from its own inner work; at N=128 the host route of the literal
    semantics in turns with the kernel. Returns the literal kernel's and the
    ring's median ms a size."""
    import statistics

    import torch

    from perphil_tpu_torch.ops.assembly import DPPOperator
    from perphil_tpu_torch.ops.fused_gmres import FusedGMRESSolver, launch_k8_probe
    from perphil_tpu_torch.ops.krylov import gmres
    from perphil_tpu_torch.solvers.solver import _freeze, _monolithic_pc

    medians = {}
    for n in K8_TURN_NS:
        W, params, bcs, _, _ = problem("quad", n, dev)
        op = DPPOperator(W, params)
        r = newton_rhs(op, bcs)
        modes = {m: FusedGMRESSolver(op, "fieldsplit_ilu", **gmres_kw, inner_ksp=m) for m in ("literal", "pcg")}
        runs = {m: s.launch(r) for m, s in modes.items()}
        torch.cuda.synchronize()
        counts = {m: (runs[m].iterations, *modes[m].launch_inner) for m in modes}
        solver = modes["literal"]
        warps = solver.last_geometry.line_warps
        ring = launch_k8_probe(solver, probe, r)
        torch.cuda.synchronize()
        check(ring.iterations == runs["literal"].iterations and solver.launch_inner == counts["literal"][1:]
              and torch.equal(ring.x, runs["literal"].x) and solver.last_geometry.line_warps == 0,
              f"K8 quad N={n}: the ring kernel bit for bit with the line pipeline")
        check(warps == -(-(n + 1) // 32), f"K8 quad N={n}: its field sweeps on the line pipeline ({warps} warps)")
        reps = 2 if n >= 128 else 3
        times = in_turns({**{m: (lambda s=s: s.launch(r)) for m, s in modes.items()},
                          "ring": lambda: launch_k8_probe(solver, probe, r)}, K8_ORDER, reps, per_call=True)
        medians[n] = (statistics.median(times["literal"]), statistics.median(times["ring"]))
        print(f"K8 quad N={n} in turns: {turns_text(K8_ORDER, times)} ms; "
              f"literal {counts['literal'][0]} iterations, inner GMRES {counts['literal'][1]} in "
              f"{counts['literal'][2]} solves, field sweeps on {warps} warps (ring: the kernel before the line "
              f"pipeline); pcg {counts['pcg'][0]} iterations, inner PCG {counts['pcg'][1]} in "
              f"{counts['pcg'][2]} solves (CUDA events, median of {reps}) on {smi}")
        check(runs["literal"].iterations == runs["pcg"].iterations == 4, f"K8 quad N={n}: 4 outer iterations")
        literal_bound = bound(*fused_gmres_work(solver, op, runs["literal"].iterations))
        print(f"  K8 literal quad N={n}: bound {literal_bound[0]:.4f} ms ({literal_bound[1]}; the kernel's own "
              f"inner work, {counts['literal'][1]} inner steps)")
        if n == 128:
            flat = dict(_freeze(presets()["SS-GMRES+ILU"]))
            mv, pc_host = op.stacked_matvec(), _monolithic_pc(op, flat)

            def host():
                return gmres(mv, r, M_inv=pc_host, restart=int(flat.get("ksp_gmres_restart", 30)), **gmres_kw)

            host_res = host()
            order = ("kernel", "host", "host", "kernel")
            hosted = in_turns({"kernel": lambda: solver.launch(r), "host": host}, order, 1, per_call=True)
            diff = rel(host_res.x, runs["literal"].x)
            print(f"  K8 literal vs its host route at quad N=128 in turns: {turns_text(order, hosted)} ms "
                  f"(CUDA events around each call); host route {host_res.iterations} iterations, fields "
                  f"{diff:.3e} from the kernel's")
            check(host_res.iterations == 4 and diff <= 1e-12, "K8 literal vs the literal host route at quad N=128")


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
    from perphil_tpu_torch.ops.krylov import KrylovResult, _norm, gmres
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
    # fused_gs's twins run on the host's cores while nvcc builds (they need
    # no kernel), and its probe build beside the package's; both are
    # collected, and the twins' workers stopped, before phase 3 times
    # anything
    global _GS_POOL, _TWIN_POOL
    import multiprocessing
    from concurrent.futures import ThreadPoolExecutor

    from perphil_tpu_torch.ops.fused_apply import halo_probe_library
    from perphil_tpu_torch.ops.fused_gmres import k8_probe_library
    from perphil_tpu_torch.ops.fused_gs import probe_library
    from perphil_tpu_torch.ops.fused_ngs import norm_probe_library

    _GS_POOL = multiprocessing.get_context("spawn").Pool(GS_WORKERS, initializer=os.nice, initargs=(TWIN_NICENESS,))
    gs_pending = {case: _GS_POOL.apply_async(gs_twin, (case,)) for case in GS_TWIN_CASES}
    # the fused GMRES roles' long twins run on the card (plain PyTorch, no
    # kernel) in worker processes of their own
    gmres_kw = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    _TWIN_POOL = multiprocessing.get_context("spawn").Pool(TWIN_WORKERS, initializer=os.nice,
                                                           initargs=(TWIN_NICENESS,))
    twins_pending = {case: _TWIN_POOL.apply_async(role_twin_remote, (case, gmres_kw))
                     for case in ROLE_CASES if case.early}
    # and fused_ngs's long twins (the published column's two largest meshes)
    picard = sp.PICARD_LU_SOLVER_PARAMS
    snes_kw = dict(rtol=picard["snes_rtol"], atol=picard["snes_atol"], max_it=picard["snes_max_it"])
    ngs_twins_pending = {n: _TWIN_POOL.apply_async(ngs_twin_remote, (n, snes_kw)) for n in NGS_REMOTE_NS}
    probe_pool = ThreadPoolExecutor(4)
    gs_probe_pending = probe_pool.submit(probe_library)
    norm_probe_pending = probe_pool.submit(norm_probe_library)  # the norm kernel the two-stage norm replaced
    halo_probe_pending = probe_pool.submit(halo_probe_library)
    k8_probe_pending = probe_pool.submit(k8_probe_library)  # the ring kernel K8's line pipeline replaced
    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.BUILD_INFO
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s, cached={info['cached']})")
    print(f"library: {info['path']}")
    units = sorted(info.get("units", {}).items(), key=lambda kv: -kv[1])
    if units:
        print("  nvcc units, each done at (s): " + ", ".join(f"{name} {t:.1f}" for name, t in units))
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
    t0 = time.perf_counter()
    gs_twins = {case: pending.get(timeout=900) for case, pending in gs_pending.items()}
    _GS_POOL.close()
    _GS_POOL.join()
    gs_probe = gs_probe_pending.result(timeout=900)
    halo_probe = halo_probe_pending.result(timeout=900)
    k8_probe = k8_probe_pending.result(timeout=900)
    norm_probe = norm_probe_pending.result(timeout=900)
    probe_pool.shutdown()
    print(f"fused_gs's twins ({', '.join(f'{c[0]} N={c[1]} {gs_twins[c][-1]:.1f} s' for c in GS_TWIN_CASES)}, on "
          f"{GS_WORKERS} workers beside nvcc) and its probe build ready {time.perf_counter() - t0:.1f} s after the "
          f"package's build; the workers stopped")
    t0 = time.perf_counter()
    early_twins = {case: pending.get(timeout=900) for case, pending in twins_pending.items()}
    ngs_twins = {n: pending.get(timeout=900) for n, pending in ngs_twins_pending.items()}
    _TWIN_POOL.close()
    _TWIN_POOL.join()
    done = ", ".join([f"{c.pc} {c.element} N={c.n} {early_twins[c][5] / 1e3:.1f} s" for c in early_twins]
                     + [f"fused_ngs quad N={n} {ngs_twins[n][-1] / 1e3:.1f} s" for n in ngs_twins])
    print(f"the fused GMRES roles' and fused_ngs's long twins ({done}; CUDA events, on the card in {TWIN_WORKERS} "
          f"workers beside nvcc) ready {time.perf_counter() - t0:.1f} s after fused_gs's; the workers stopped")

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
    # the fused GMRES roles against their twin (on the card), on the
    # solver's own right-hand sides; the long twins ran during the build
    for case in ROLE_CASES:
        element, n, pc, role, tol, reps, host_preset, twin_its, inner, _ = case
        if case.early:  # the twin ran in a worker: its right-hand side and result back on the card
            r, x, its, rnorm, conv, plain_ms, twin, once = early_twins[case]
            W, params, _, _, _ = problem(element, n, dev)
            op = DPPOperator(W, params)
            r = torch.from_numpy(r).to(dev)
            cmp = FusedGMRESSolver(op, pc, role, **{**gmres_kw, "max_it": twin_its or gmres_kw["max_it"]},
                                   inner_ksp=inner)
            ref = KrylovResult(torch.from_numpy(x).to(dev), its, rnorm, conv)
        else:
            op, r, cmp, ref, plain_ms, twin, once = role_twin(case, dev, gmres_kw)
        # the twin on the whole solve, or where that takes long on the first
        # twin_its steps (the whole solve's count is held on the paths below)
        solver = cmp if twin_its is None else FusedGMRESSolver(op, pc, role, **gmres_kw, inner_ksp=inner)
        got = solver.launch(r)
        mine = got if twin_its is None else cmp.launch(r)
        torch.cuda.synchronize()
        abs_err = float((mine.x - ref.x).abs().max())
        err = abs_err / float(ref.x.abs().max())
        tag = f"{element} N={n} pc {pc}" + (" inner pcg" if inner == "pcg" else "")
        kind = "GMRES" if solver.inner_tols()[3] else "PCG"
        print(f"{solver.role} {tag}: iterations {mine.iterations} vs twin {ref.iterations}"
              + (f" (max_it {twin_its}; the whole solve {got.iterations})" if twin_its else "")
              + f", max rel diff vs twin {err:.3e} (bound {tol:g}), max abs diff {abs_err:.3e}"
              + (f", twin inner {kind} {twin[0]} iterations in {twin[1]} solves" if twin[1] else "")
              + (" (twin run in a worker during the build)" if case.early else ""))
        check(mine.iterations == ref.iterations and mine.converged == ref.converged, f"{solver.role} {tag} count")
        check(err <= tol, f"{solver.role} {tag} vs twin")
        geo = solver.last_geometry
        blocks = geo.blocks
        check(blocks > 1 or r.numel() <= 512, f"{solver.role} {tag} spreads over more than one block")
        if pc == "fieldsplit_ilu":  # 2D fields sweep on the line pipeline, ceil(ny / 32) warps; 3D on the ring
            check(geo.line_warps == (-(-(n + 1) // 32) if element == "quad" else 0),
                  f"{solver.role} {tag}: field sweeps on {geo.line_warps} line-pipeline warps")
        ms = time_ms(lambda: solver.launch(r), repeats=reps, warmup=1)
        print(f"  {solver.role} {tag}: {blocks} blocks, {launch_geometry(r.numel()).leaves} leaves a thread, "
              f"{got.iterations} iterations, basis slice in shared memory: {geo.basis_smem}, "
              f"ILU z in shared memory: {geo.ilu_z_smem}, matvec input in shared memory: {geo.input_smem}, "
              f"inner p in shared memory: {geo.p_smem}, "
              f"eigenbases in shared memory: {geo.s_smem}, field sweep line-pipeline warps: {geo.line_warps}, "
              f"{ms:.4f} ms, "
              f"{ms * 1e3 / max(got.iterations, 1):.3f} us/iteration")
        if twin[1]:
            inner_its, inner_solves = solver.launch_inner
            line = (f"  {solver.role} {tag}: kernel inner {kind} {inner_its} iterations in {inner_solves} solves "
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
            # (timed over its first HOST_LOOP_CAP iterations at most: its
            # time an iteration against the kernel's)
            flat = dict(_freeze(PRESETS[host_preset]))
            mv, pc_host = op.stacked_matvec(), _monolithic_pc(op, flat)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = gmres(mv, r, M_inv=pc_host, restart=int(flat.get("ksp_gmres_restart", 30)),
                         **{**gmres_kw, "max_it": min(gmres_kw["max_it"], HOST_LOOP_CAP)})
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            host_us, kernel_us = host_ms * 1e3 / max(host.iterations, 1), ms * 1e3 / max(got.iterations, 1)
            print(f"  host loop {host_preset} {tag}: {host.iterations} iterations"
                  + (f" (capped at {HOST_LOOP_CAP} of {got.iterations})" if host.iterations < got.iterations else "")
                  + f", {host_ms:.2f} ms ({host_us:.2f} us/iteration; host clock), fused {kernel_us:.2f} "
                  f"us/iteration: {host_us / kernel_us:.1f}x")
        results[f"{solver.role}@{tag}"] = dict(
            max_abs_err=abs_err, ms=ms,
            plain_ms=plain_ms, bound=bound(*fused_gmres_work(solver, op, got.iterations)),
            shape=f"{tag}, {got.iterations} iterations, {blocks} blocks"
            + (f"; twin on the first {twin_its}" if twin_its else "")
            + ("; twin timed in a worker during the build" if case.early else ""),
        )
    results["fused_gmres_ef64"] = results["fused_gmres_ef64@quad N=8 pc none"]
    results["fused_gmres_df"] = results["fused_gmres_df@quad N=64 pc none"]
    results["fused_gmres_df[ilu]"] = results["fused_gmres_df[ilu]@quad N=64 pc ilu"]
    results["fused_gmres_df[fieldsplit_lu]"] = results["fused_gmres_df[fieldsplit_lu]@quad N=64 pc fieldsplit_lu"]
    results["fused_gmres_df[fieldsplit_ilu]"] = results["fused_gmres_df[fieldsplit_ilu]@quad N=64 pc fieldsplit_ilu"]
    k8_turns(dev, smi, gmres_kw, k8_probe)

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
        if tag.startswith("monolithic"):  # the library yardstick: the cuSPARSE pair on the same factor
            lib = sparse_pair(*structured_factor(pc), dev)
            lib_err = rel(lib(r), z)
            check(lib_err <= 1e-12, f"the cuSPARSE pair computes structured_ilu_apply {tag}")
            results[f"structured_ilu_apply@{tag}"]["library_ms"] = time_ms(lambda: lib(r), repeats=10)
            print(f"  cuSPARSE pair (torch.triangular_solve on the sparse triangles) {tag}: "
                  f"{results[f'structured_ilu_apply@{tag}']['library_ms']:.4f} ms, max rel diff {lib_err:.3e}")
            del lib
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
    # mixed-precision solver with K1's lift and the halo form's residuals
    # (64^3/128^3 hex). tet nx=16
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
        else:  # no fused direct kernel; K1 for the lift, and each matvec (cg) or residual (mixed: the halo form)
            residual = "fused_dpp_apply_halo" if route == "mixed" else "fused_dpp_apply"
            check(counts.get(K2, 0) == counts.get(K3, 0) == 0 and counts.get("fused_dpp_apply", 0) >= 1
                  and counts.get(residual, 0) >= 1, f"{element} N={n} {preset} took the {route} route")
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
                f"(K1: {counts.get('fused_dpp_apply', 0)} a solve, its halo form "
                f"{counts.get('fused_dpp_apply_halo', 0)}), f64 rel residual {rres:.3e}")
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
    from perphil_tpu_torch.ops.fused_ngs import FusedNGSSolver, NgsResult, ngs_host_loop
    from perphil_tpu_torch.ops.ilu import GaussSeidelSweeper
    from perphil_tpu_torch.solvers import solve_dpp_nonlinear

    # fused_ngs against its twin (not counted), bit for bit, at N=16/64 and
    # the published column's largest mesh, and at the plan's last published
    # size N=255 with both capped at NGS_CAP_255 iterations; the twin timed
    # in its check run (at N=64/128 in a worker during the build, the
    # kernel launched on the twin's inputs)
    ngs_solvers = {}
    for n in (16, 64, 128, 255):
        W, params, bcs, _, _ = problem("quad", n, dev)
        op = DPPOperator(W, params)
        solver = FusedNGSSolver(op, **{**snes_kw, **({"max_it": NGS_CAP_255} if n == 255 else {})})
        if n in ngs_twins:
            b, x0, tx, tits, tfn, tf0, plain_ms = ngs_twins[n]
            b, x0 = (torch.as_tensor(t, device=dev) for t in (b, x0))
            ref = NgsResult(torch.as_tensor(tx, device=dev), tits, tfn, tf0)
            got = solver.launch(b, x0)
        else:
            b, x0 = picard_inputs(op, bcs)
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
    # fused_gs against its twin (not counted): x, the count and both norms
    # bit for bit. The twins ran on the host's cores (gs_twin) from the
    # inputs the kernel gets here; at tri N=16 / tet nx=4 the card's twin too
    from perphil_tpu_torch.ops.fused_gs import RESULT_SLOTS as GS_SLOTS
    from perphil_tpu_torch.ops.fused_gs import FusedGSSolver, fused_gs_plan, gs_host_loop

    gs_solvers = {}
    for case in GS_TWIN_CASES:
        element, n, cap = case
        b_np, x0_np, x_np, its, fn, f0, twin_s = gs_twins[case]
        W, params, _, _, _ = problem(element, n, dev)
        op = DPPOperator(W, params)
        b, x0 = torch.tensor(b_np, device=dev), torch.tensor(x0_np, device=dev)
        solver = FusedGSSolver(op, **{**snes_kw, **({"max_it": cap} if cap else {})})
        got = solver.launch(b, x0)
        torch.cuda.synchronize()
        twin_x = torch.tensor(x_np, device=dev)
        abs_err = float((got.x - twin_x).abs().max())
        p = solver.plan
        where = ("one block, x and b in its shared memory" if p.blocks == 1 else
                 f"a cluster of {p.blocks} blocks, x and b in slabs of {p.rows} planes over their shared memory")
        line = (f"fused_gs {element} N={n}: {p}, {where} (the launch's: {solver.last_placement}); iterations "
                f"{got.iterations} vs twin {its}" + (f" (capped at {cap})" if cap else "")
                + f", fn {got.residual_norm!r} vs twin {fn!r}, f0 {got.initial_norm!r} vs twin {f0!r}, x bit-equal "
                f"{torch.equal(got.x, twin_x)}, max abs diff {abs_err:.3e}; twin {twin_s:.1f} s on the host's CPU")
        if (element, n) in GS_CARD_TWINS:
            card = solver.plain(b, x0)
            same = (torch.equal(card.x, twin_x)
                    and (card.iterations, card.residual_norm, card.initial_norm) == (its, fn, f0))
            line += f"; the twin on the card bit-equal to it: {same}"
            check(same, f"fused_gs {element} N={n}: the twin's bits on the card and on the host")
        print(line)
        check(got.iterations == its and (cap is None or its == cap), f"fused_gs {element} N={n} count")
        check(torch.equal(got.x, twin_x) and got.residual_norm == fn and got.initial_norm == f0,
              f"fused_gs {element} N={n} bit for bit with its twin")
        check(solver.last_placement[0] == p.blocks, f"fused_gs {element} N={n}: the launch placed the plan")
        if cap is None:
            check(fn <= max(snes_kw["rtol"] * f0, snes_kw["atol"]), f"fused_gs {element} N={n} converged")
        gs_solvers[(element, n)] = (op, b, x0, solver, got, twin_s, abs_err)
        # every placement the plan allows, GS_REPEATS launches each: each
        # launch's x, count and norms the twin's (a halo wait that hung now
        # and then would trap, and the launch fail)
        placed = [nb for nb in (1, 2, 4, 8, 16) if fused_gs_plan(W.mesh.node_shape, element, nb) is not None]
        for nb in placed:
            other = FusedGSSolver(op, **{**snes_kw, **({"max_it": cap} if cap else {})}, blocks=nb)
            for _ in range(GS_REPEATS):
                rep = other.launch(b, x0)
                check(torch.equal(rep.x, twin_x) and (rep.iterations, rep.residual_norm, rep.initial_norm)
                      == (its, fn, f0), f"fused_gs {element} N={n} on {nb} block(s) bit for bit with its twin")
        print(f"  fused_gs {element} N={n}: {GS_REPEATS} launches on each of {placed} block(s), each bit for bit "
              f"with the twin")
    # the kernel line's shape: its time, µs an iteration and a level, and the
    # empty level: the probe build's launch with as many empty levels again
    # a sweep less its launch without them
    op, b, x0, solver, got, twin_s, abs_err = gs_solvers[GS_TABLE_CASE]
    its, levels = got.iterations, solver.plan.levels
    ms = time_ms(lambda: solver.launch(b, x0), repeats=5, warmup=1)
    x_e, res_e = torch.empty_like(b), torch.empty(GS_SLOTS, dtype=torch.float64, device=dev)
    probe_args = solver.launch_args(b, x0, x_e, res_e)

    def probe(extra):
        _cuda.check(gs_probe.perphil_fused_gs_probe(*probe_args, extra, 0, stream), "perphil_fused_gs_probe")

    ms_probe, ms_empty = (time_ms(lambda: probe(extra), repeats=5, warmup=1) for extra in (0, levels))
    check(torch.equal(x_e, got.x) and res_e[0].item() == its, "fused_gs's probe build: the same solve")
    empty_us = (ms_empty - ms_probe) * 1e3 / (its * levels)
    results["fused_gs"] = dict(
        max_abs_err=abs_err, ms=ms, plain_ms=twin_s * 1e3, bound=bound(*fused_gs_work(solver, its)),
        shape=f"tri 64^2, {its} iterations, {levels} levels, {solver.plan.blocks} block; the twin on the host's CPU",
    )
    print(f"  fused_gs tri N=64: {ms:.3f} ms (CUDA events, median of 5), {ms * 1e3 / its:.3f} us/iteration, "
          f"{ms * 1e3 / (its * levels):.4f} us/level ({levels} levels); the probe build {ms_probe:.3f} ms, with "
          f"{levels} empty levels more a sweep {ms_empty:.3f} ms: an empty level {empty_us:.4f} us, latency floor "
          f"{its * levels * empty_us * 1e-3:.3f} ms "
          f"({its} x {levels} levels); bound {results['fused_gs']['bound'][0]:.6f} ms "
          f"({results['fused_gs']['bound'][1]}) on {smi}")
    # the host route (the route beyond the plan: a GS-mode sweep, a K1
    # residual and a norm read back an iteration) against the kernel, in turns
    # host, kernel, kernel, host (host clock around a call and a synchronise)
    for element, n in GS_TURNS:
        op, b, x0, solver, _, _, _ = gs_solvers[(element, n)]
        walls, counts = {"host route": [], "kernel": []}, {}
        for side in ("host route", "kernel", "kernel", "host route"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = gs_host_loop(op, solver.sweeper, b, x0, **snes_kw) if side == "host route" else solver.launch(b, x0)
            torch.cuda.synchronize()
            walls[side].append((time.perf_counter() - t0) * 1e3)
            counts[side] = res.iterations
        print(f"lexicographic ngs {element} N={n}: host route {counts['host route']} iterations, "
              f"{' / '.join(f'{w:.2f}' for w in walls['host route'])} ms; fused_gs {counts['kernel']} iterations, "
              f"{' / '.join(f'{w:.2f}' for w in walls['kernel'])} ms (host clock, in turns) on {smi}")
        # K1 sums the residual in another order than the kernel: a knife edge may move the count
        check(abs(counts["host route"] - counts["kernel"]) <= 2, f"lexicographic ngs {element} N={n} host route count")
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
        if kernel in ("fused_ngs", "fused_gs"):
            check(counts.get(kernel) == 1, f"{element} N={n} ran {kernel} once")
            # the cached solve: the lift (one K1) and the kernel
            solver = _build_nonlinear_solver(W, params, _freeze(PRESETS[preset]))
            g1, g2 = (bc.grid_values(W.mesh) for bc in bcs)
            t0 = time.perf_counter()
            solver(g1, g2)
            torch.cuda.synchronize()
            line += f", cached solve {(time.perf_counter() - t0) * 1e3:.2f} ms"
        if kernel == "fused_gs":
            check(counts.get(kernel) == 1 and "structured_ilu_apply[gs]" not in counts,
                  f"{element} N={n} ran fused_gs once")
        if kernel == "structured_ilu_apply[gs]":
            check(counts.get(kernel) == its and "fused_gs" not in counts,
                  f"{element} N={n}: past fused_gs's plan, one GS-mode launch an iteration")
        if preset == "PICARD_LU_CAP20":
            check(its == 20, f"{element} N={n}: capped at 20 iterations")
        elif preset != "KSP_PREONLY_PARAMS":
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
    # -- 12. the h-convergence study ----------------------------------------
    convergence_path(dev, smi, t_start)

    # -- 13. the profiling studies ------------------------------------------
    for name, count in profiling_path(dev, smi, t_start, results).items():
        if name in KERNELS:
            launches[name] = launches.get(name, 0) + count

    # -- 14. the multi-device path ------------------------------------------
    for name, count in multidevice_path(dev, smi, randn, results, t_start, halo_probe,
                                              norm_probe).items():
        if name in KERNELS:
            launches[name] = launches.get(name, 0) + count
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
    try:
        code = main()
    finally:
        if _GS_POOL is not None:  # the twins' workers stop with the script, whatever its end
            _GS_POOL.terminate()
            _GS_POOL.join()
        if _TWIN_POOL is not None:
            _TWIN_POOL.terminate()
            _TWIN_POOL.join()
    sys.exit(code)
