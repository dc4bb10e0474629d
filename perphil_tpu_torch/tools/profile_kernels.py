"""Where the fused GMRES kernel and the ILU apply spend their time, on the
card: ``python -m perphil_tpu_torch.tools.profile_kernels`` from the root of
a checkout (needs an NVIDIA GPU and ``nvcc``).

It builds the translation units of ``csrc/profile/`` on their own, one
``nvcc`` each, in parallel (the fused GMRES kernel per preconditioner and
``structured_ilu_apply``, each with its cycle counters compiled in). The
package's library holds no counter.
For plain GMRES at 2D N=8/16/64 and tet nx=16 it prints the blocks taken,
the time (CUDA events, median) and the share of block 0's cycles in each
phase of a step; for the fieldsplit roles (K6 at 2D N=64 and tet nx=8, K8
with its literal inner GMRES at 2D N=16/64/128 and its PCG mode at N=64)
the same, with the inner block solve's phases (ILU sweep or fast-diag,
field matvec, dots and norms, vector updates, and the literal GMRES's
Givens chain and back-substitution on thread 0) per inner iteration and the
preconditioner's cycles per sweep level (K8) or per transform pass (K6);
for ``structured_ilu_apply`` at 2D N=64/128 monolithic and on a 65^2 and
129^2 field, the time, the time per level, whether the result equals the
plain sweep bit for bit, and the cycles one consumer and one producer thread
spend in each part of a level. ``--only gmres|fieldsplit|ilu`` profiles one
of the three alone; ``--only fieldsplit`` first times K8 literal at 2D
N=16/64/128 in turns with its probe builds (``time_k8_lines``: the ring
kernel its line pipeline replaced, 2 or 3 lines a lane, the PCG mode) and
measures an empty step of the pipeline and the latency floor it gives.

``--only k1`` times K1 (``csrc/dpp_apply.cu``) with the package's library
on f64 matvecs at 64^3, 128^3 (hex) and 2D N=128: the device time (CUDA
events, launches queued behind a sleep), f32 beside it, and K1's share of
the device time in the 64^3/128^3 ``TPU_DIRECT_PARAMS`` solves
(``torch.profiler``) beside their wall time. Beside them: copies of the
kernel built alone (one ``nvcc`` each, in parallel, ``ptxas -v`` printed)
with one of its tuning constants set otherwise (``kMinBlocks``, ``kStages``,
``kTileX``, ``kChunk``), each first held to the package's bits.
``--against DIR`` builds ``DIR``'s ``dpp_apply.cu`` alone (an older checkout
unpacked under ``_checkout/``) and holds both kernels to each other, bit for
bit in both modes and precisions, and times them in turns (older, this,
this, older).

``--only halo`` times K1's halo form (``dpp_apply_halo_kernel`` in
``csrc/dpp_apply.cu``) on f64 matvecs of 128^3 hex phantom-padded to
136 x 129 x 129 and cut into 8 z-slabs (loopback planes, the exchange's
form): one slab alone (rank 3, ghosts on both sides; and rank 0 and 7, at
the grid's edges), the 8 slabs (8 launches), the padded box and the whole
129^3 box with no ghost (beside K1), and 2D N=1023 the same way. Each in
turns (CUDA events, launches queued) with the first halo form
(``csrc/profile/dpp_apply_halo_box.cu``, built alone, on the extended
boxes), with the package's kernel at the plan's chunk and at z chunks 2-8,
all held to each other bit for bit, and with copies of ``dpp_apply.cu``
built alone that put every tile or no tile on the general staging (timed
only: their results are wrong where it matters); the plans' blocks, the
card's wave and ``ptxas -v`` of the halo kernels.

``--only direct`` times K2 (``csrc/fused_direct.cu``) and K3
(``csrc/fused_pcg.cu``) two ways: the device time (launches queued behind a
sleep) and the call time (CUDA events around the Python call, the host's
work included), beside the floor of both (an empty kernel through the same
ctypes interface), at quad N=4/16/64, hex nx=8/14, tri N=8, tet nx=4/8/14
and the shapes beyond the former envelope, where it also times the route
those shapes take without the kernels (``MixedPrecisionDPPDirect`` for
quad/hex, ``cg`` with K1 for tri/tet) in turns with the kernel (kernel,
route, kernel, route; host clock, median of 10 each).
``--against DIR`` then times the solvers' ``launch`` of an older checkout
(unpacked under ``_checkout/``) and of this one at the published meshes,
each tree in a process of its own started from its root (``--only
direct-wrapper``, older, this, this, older), so that each tree's wrapper
calls its own launchers, and prints the largest difference between the two
trees' solutions.

``--only ngs-phases`` builds ``csrc/fused_ngs.cu`` alone with its phase
clocks (``PERPHIL_NGS_PROFILE``) and prints, for the Picard solve
(``PICARD_LU_SOLVER_PARAMS``) at 2D N=16/64/128, the kernel's time with the
clocks (CUDA events, median of 3; its result first held to the package's
kernel bit for bit) and thread 0 of block 0's cycles an iteration in each
phase: a colour's own rows, the halo (block barrier, arrivals, the wait for
the neighbours), the norm's residual rows, the cluster barrier that
publishes them to the tree and the tree.
``--only ngs`` times ``fused_ngs`` in turns with the first port's kernel
(``csrc/profile/fused_ngs_cluster.cu``, built alone, with its own host
tables: older, this, this, older; CUDA events, median of 3) at 2D
N=64/128/255 (255 capped at 2000 iterations), both held to each other bit
for bit; the empty phase (the same launch with extra colours that hold no
rows: a halo exchange alone) and the latency floor it gives; and every
block count the launcher places at 2D N=32/64/128/255, in turns.
``--only ngs-variants`` times it in turns with copies built with one
choice made otherwise (cluster-scope ordering on the halo's mbarriers; a
reciprocal's product for the divide, which does not keep the bits) and
with its colour runs sorted by offset instead of dealt by bank.

``--only ngs-blocked`` first holds the blocked iteration's norm
(``ngs_colour_norm``: the rows stage, then the tree and tail) over
``chip_smoke.COLOUR_LAYOUTS`` to its twin, to the first norm kernel
(``csrc/profile/ngs_colour_norm_first.cu``, built alone), to its
one-launch build and to itself at 2 leaves a thread, bit for bit, and
times them in turns; splits it by the builds that skip a part (launches,
rows, taps, tree, tail); and times an iteration from a graph with each
norm (``time_ngs_norm``). Then it times the sharded Picard's blocked
iteration (``ops/fused_ngs.py::blocked_ngs`` on a ``NgsSweep``:
``csrc/ngs_colour_halo.cu``'s colour steps and norm) at 2D N=64/128 on
one block with 8, 16, 32 and 64 iterations between read-backs (beside an
empty kernel's launch, queued and from a graph, and a colour step beside
builds of ``ngs_colour_halo.cu`` that skip parts of it: the row's work,
the taps, the divide), in turns
with ``fused_ngs``, the first blocked loop (``blocked_ngs_probe``: the
first colour-step kernel, ``csrc/profile/ngs_colour_halo_first.cu``, built
alone, a norm read back every iteration) and the blocked iteration with the
first norm kernel (``FirstNormSweep``), every run held to ``fused_ngs``'s
count and iterate bit for bit (host clock, a solve); an iteration's device
time from the graph of k iterations, issued launch by launch and queued;
and at N=64 the loopback slabs and pencils of the phantom-padded grid, in
turns with ``fused_ngs`` and the first norm kernel (and the first loop on
some).

``--only band`` times ``band_trisolve`` (``csrc/band_trisolve.cu``, the
level-scheduled sweep) with the package's library at tet nx=16/24/40: each
engine's host set-up from the factor (host clock, in turns), the apply in
turns with the first port's dense kernel
(``csrc/profile/band_trisolve_dense.cu``, built alone, its packing
``tools/band_dense.py``; dense, level, level, dense), each sweep alone beside
the dense kernel's four factors, the cuSPARSE pair (``torch.triangular_solve``
on the factor's sparse triangles) in turns, every placement the plan can take
(1-16 blocks, the vector in shared or device memory) in turns, each held to
the twin's bits, an empty level (the same launch with as many levels again
that hold no rows) and the latency floor it gives, thread 0's cycles a level
(stage wait, own rows, level barrier; a copy built with
``PERPHIL_LEVEL_PROFILE``) and the sync-free variant
(``csrc/profile/band_trisolve_syncfree.cu``: per-row ready flags in place of
level barriers), a copy with the hardware cluster barrier in place of the
mbarrier exchange (``PERPHIL_LEVEL_CLUSTER_SYNC``) and a copy whose lanes
skip the vector's gathers (what they cost; its results are wrong) in turns;
then
``structured_ilu_apply`` at 2D N=128 in turns
with the cuSPARSE pair on its factor. First it prints the plan's schedule
(rows, entries, padding, levels, placement, ``band_plan``) at tet
nx=4..64, computed on the host.

``--only partri`` builds nothing of its own: it times the partri ILU apply
(``ops/ilu.py::PartriILU``, torch ops) at 2D N=128/256 and tet nx=16
(monolithic) in turns (CUDA events, median of 20): issued op by op, as the
solvers run it, and replayed from a CUDA graph captured once (the same
kernels without the host between them; its result first held to the
issued apply's bit for bit), beside ``structured_ilu_apply`` on the same
factor, the maps' bytes and bound; and counts, with ``torch.profiler``, the
device kernels of one apply and their summed time.

``--only gs`` times ``fused_gs`` (``csrc/fused_gs.cu``, the lexicographic
Picard solve in one launch): in turns with the host route it replaced
(a ``structured_ilu_apply[gs]`` sweep, a K1 residual and a norm read back
an iteration; host clock) at tri N=16/64 and tet nx=16; every placement the
plan allows at tri N=64/128 and tet nx=16/24/34 in turns, 200 iterations
each (``rtol = atol = 0``), bit for bit with one another, the package's
launch beside the probe build's (``fused_gs.probe_library``:
``csrc/fused_gs.cu`` built alone with ``PERPHIL_GS_PROFILE``) with and
without as many empty levels again a sweep, their difference the empty
level; with the probe build's clocks, the cycles of thread 0 of block 0 a
level in its rows and in the level's barrier and halo wait, and an
iteration's in the norm's rows and tree; and the GS mode's empty level (its
launch on an all-empty schedule of 2L and L levels), its latency floor.
``--only gs-repeat`` launches every placement of those meshes 40 times on
each build (the package's, the probe's with no and with as many empty
levels again a sweep), queued back to back, each launch with buffers of its
own, and holds every launch's x, count and norms to the first's bit for
bit: a halo wait that hangs now and then traps and fails the run.

``--only sweeps`` builds nothing of its own: it times, with the package's
kernels (CUDA events, median of 5), the frame's roles where ``chip_smoke.py``
times them (K5 at 2D N=8, K4 at N=16/64, K6 at N=64 and tet nx=8) and the
wall of ``solve_dpp`` at 2D N=8 (host clock), and
where the ILU(0) sweep runs: K7 at 2D N=16/32/64 and K8 at 2D N=16/64 (the
kernel's time over every level it swept) and ``structured_ilu_apply`` on a
33^2, 65^2 and 129^2 field. It
uses only what every version of the package has, so that a copy of it also
runs against an older checkout, for a comparison on the same card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator, FieldOperator
from perphil_tpu_torch.ops.fused_gmres import RESULT_SLOTS, FusedGMRESSolver
from perphil_tpu_torch.ops.ilu import StructuredILU0
from perphil_tpu_torch.solvers import parameters as sp
from perphil_tpu_torch.solvers import solve_dpp

#: the line pipeline's parts of a step on its head warp (``csrc/field_sweep.cuh``, ``kLineProfSlots``)
LINE_PARTS = ["shuffle + wait for the rows", "the row", "the next rows' copies"]
PHASES = ["apply", "dots", "gram-schmidt+norm", "givens", "scale", "end barrier", "restart",
          "inner: preconditioner", "inner: field matvec", "inner: dots", "inner: vector updates",
          "inner: givens"]
_P = ctypes.c_void_p


def build() -> ctypes.CDLL:
    out = _cuda.BUILD_DIR / "profile"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libperphil_profile.so"
    alone = ("fused_ngs_cluster.cu", "band_trisolve_dense.cu", "band_trisolve_syncfree.cu",
             "dpp_apply_halo_box.cu", "fused_gmres_k8_ring.cu")  # built by their tools
    sources = sorted(s for s in (_cuda.CSRC / "profile").glob("*.cu") if s.name not in alone)
    procs = [
        subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-c", "-I", str(_cuda.CSRC), "-o", str(out / f"{s.stem}.o"), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s in sources
    ]
    for proc, src in zip(procs, sources):
        log = proc.communicate()[0]
        entry = ""
        for line in log.splitlines():
            text = line.split("ptxas info    :")[-1].strip()
            if "Compiling entry function" in line:
                entry = text.split("'")[1][:60]
            elif "spill" in line or "Used" in line:
                print(f"  ptxas {src.stem} {entry}: {text}")
        if proc.returncode:
            raise RuntimeError(log)
    subprocess.run(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib), *[str(out / f"{s.stem}.o") for s in sources]],
        check=True,
    )
    dll = ctypes.CDLL(str(lib))
    dll.perphil_fused_gmres_profile.argtypes = _cuda._SIGNATURES["perphil_fused_gmres"]
    dll.perphil_structured_ilu_apply.argtypes = _cuda._SIGNATURES["perphil_structured_ilu_apply"]
    dll.perphil_ilu_profile_take.argtypes = [_P]
    # what each profile unit's static shared memory leaves of the launches'
    # budget (imported here: --only sweeps runs against older checkouts too)
    from perphil_tpu_torch.ops.fused_gmres import MAX_SMEM_PER_BLOCK, PC_KINDS, SMEM_BUDGET

    smem = dll.perphil_fused_gmres_profile_static_smem
    smem.argtypes = _cuda._SIGNATURES["perphil_fused_gmres_static_smem"]
    print("  static shared memory, margin over the budget: " + ", ".join(
        f"{pc} {d}D {smem(kind, d)} B ({MAX_SMEM_PER_BLOCK - smem(kind, d) - SMEM_BUDGET} B)"
        for pc, kind in PC_KINDS.items() for d in (2, 3)))
    return dll


def median_ms(fn, repeats: int) -> float:
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


def profile_gmres(dll, element: str, n: int, pc: str = "none", inner_ksp: str = "literal") -> None:
    import chip_smoke

    W, params, bcs, _, _ = chip_smoke.problem(element, n, torch.device("cuda", torch.cuda.current_device()))
    op = DPPOperator(W, params)
    b = chip_smoke.newton_rhs(op, bcs)
    kw = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    solver = FusedGMRESSolver(op, pc, **kw, inner_ksp=inner_ksp)
    result = torch.zeros(RESULT_SLOTS + len(PHASES) + len(LINE_PARTS), dtype=torch.float64, device=b.device)
    (args, _keep), x = solver.launch_args(b, None, result)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = dll.perphil_fused_gmres_profile(*args, stream)
        if err:
            raise RuntimeError(f"perphil_fused_gmres_profile: CUDA error {err}")

    ms = median_ms(run, 3)
    got = solver.read_result(x, result)
    cycles = result.tolist()[RESULT_SLOTS:]
    line_cycles, cycles = cycles[len(PHASES):], cycles[:len(PHASES)]
    its, total = got.iterations, sum(cycles)
    mode = f" (inner {inner_ksp})" if pc == "fieldsplit_ilu" else ""
    print(f"fused GMRES pc {pc}{mode} {element} N={n}: {its} iterations, geometry {solver.last_geometry}, "
          f"{ms:.4f} ms, {ms * 1e3 / its:.3f} us/iteration, {total / its:.0f} cycles/iteration on block 0")
    for name, c in zip(PHASES, cycles):
        if c:
            print(f"    {name:>22}: {100 * c / total:5.1f}%  {c / its:11.0f} cycles/iteration  "
                  f"{ms * 1e3 / its * c / total:9.3f} us/iteration")
    if pc.startswith("fieldsplit"):
        inner, solves = solver.launch_inner  # the kernel's own inner counts
        # PCG: one application a solve and one an iteration; GMRES: the same
        # and one more a restart (not counted)
        applications = inner + solves
        pc_cycles = cycles[PHASES.index("inner: preconditioner")]
        kind = "GMRES" if solver.inner_tols()[3] else "PCG"
        print(f"    inner {kind} {inner} iterations in {solves} solves; {total / max(inner, 1):.0f} cycles/inner "
              f"iteration, {pc_cycles / applications:.0f} preconditioner cycles/application (at most)")
        if pc == "fieldsplit_ilu":
            nlev = solver.field_ilu[0].num_levels
            print(f"    {pc_cycles / (2 * nlev * applications):.0f} cycles/sweep level ({nlev} levels a sweep)")
            if solver.last_geometry.line_warps:
                # the line pipeline's head warp, thread 0: its steps' parts (the
                # warp runs its own lines' steps, ny / warps + nx of them a sweep)
                steps = 2 * applications * (nx_steps := solver.node_shape[1] + 2 * min(
                    solver.node_shape[0], 32) - 2)
                print("    line pipeline, thread 0 a step: " + ", ".join(
                    f"{name} {c / steps:.0f}" for name, c in zip(LINE_PARTS, line_cycles))
                    + f" cycles ({nx_steps} steps a sweep on warp 0, {solver.last_geometry.line_warps} warps)")
        else:
            passes = 2 * len(solver.node_shape)
            print(f"    {pc_cycles / (passes * applications):.0f} cycles/transform pass "
                  f"({passes} passes an application)")


#: K8's probe builds (``csrc/profile/fused_gmres_k8_ring.cu``): the ring
#: kernel the line pipeline replaced, the pipeline with 2 and 3 lines a lane
#: (fewer warps), and the package's pipeline with K8_EXTRA empty steps a
#: warp's sweep
K8_EXTRA = 200
K8_PROBES = {"ring": "PERPHIL_K8_PROBE", "slots2": "PERPHIL_K8_LINE_SLOTS=2", "slots3": "PERPHIL_K8_LINE_SLOTS=3",
             "empty": f"PERPHIL_K8_EXTRA_STEPS={K8_EXTRA}"}


def time_k8_lines() -> None:
    """K8 literal at 2D N=16/64/128 in turns with its probe builds (each
    first held bit for bit, with its counts, to the package's K8): the ring
    kernel it replaced, the pipeline with 2 or 3 lines a lane, and the PCG
    mode; then an empty step of the pipeline, (the empty-step build's time
    less the package's) over the empty steps it ran (K8_EXTRA a sweep, two
    sweeps an application), and the latency floor it gives: applications x
    2 x levels x the empty step."""
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke
    from perphil_tpu_torch.ops.fused_gmres import k8_probe_library, launch_k8_probe

    with ThreadPoolExecutor(len(K8_PROBES)) as pool:
        probes = dict(zip(K8_PROBES, pool.map(k8_probe_library, K8_PROBES.values())))
    dev = torch.device("cuda", torch.cuda.current_device())
    kw = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    order = ("package", "ring", "slots2", "slots3", "pcg", "pcg", "slots3", "slots2", "ring", "package")
    for n in (16, 64, 128):
        W, params, bcs, _, _ = chip_smoke.problem("quad", n, dev)
        op = DPPOperator(W, params)
        r = chip_smoke.newton_rhs(op, bcs)
        s = FusedGMRESSolver(op, "fieldsplit_ilu", **kw)
        pcg = FusedGMRESSolver(op, "fieldsplit_ilu", **kw, inner_ksp="pcg")
        ref = s.launch(r)
        torch.cuda.synchronize()
        counts, warps = s.launch_inner, s.last_geometry.line_warps
        for name, dll in probes.items():
            got = launch_k8_probe(s, dll, r)
            torch.cuda.synchronize()
            if not (torch.equal(got.x, ref.x) and got.iterations == ref.iterations and s.launch_inner == counts):
                raise RuntimeError(f"K8 probe {name} at N={n} is not the package's K8 bit for bit")
            print(f"  K8 probe {name} quad N={n}: bit for bit, {s.last_geometry}")
        runs = {"package": lambda: s.launch(r), "pcg": lambda: pcg.launch(r),
                **{name: (lambda dll=dll: launch_k8_probe(s, dll, r)) for name, dll in probes.items()}}
        reps = 2 if n >= 128 else 3
        times = {}
        for name in order + ("empty", "package", "package", "empty"):
            times.setdefault(name, []).append(median_ms(runs[name], reps))
        med = {k: statistics.median(v) for k, v in times.items()}
        apps, nlev = counts[0] + counts[1], s.field_ilu[0].num_levels
        empty_us = (med["empty"] - med["package"]) * 1e3 / (2 * K8_EXTRA * apps)
        print(f"K8 literal quad N={n} ({warps} warps, {counts[0]} inner steps in {counts[1]} solves) in turns, ms: "
              + " / ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}" for k, v in times.items())
              + f"; an empty step {empty_us:.4f} us ({K8_EXTRA} more a sweep), latency floor "
              f"{apps * 2 * nlev * empty_us / 1e3:.4f} ms ({apps} applications x 2 x {nlev} levels); "
              f"{(med['package'] * 1e3) / (2 * nlev * apps):.4f} us a step of the whole kernel's time")


def profile_ilu(dll, tag: str, pc: StructuredILU0) -> None:
    r = torch.randn(pc.nrows, dtype=torch.float64, generator=torch.Generator().manual_seed(0)).to(pc.device)
    z, y = torch.empty_like(r), torch.empty_like(r)
    geometry = np.zeros(4, np.int32)
    cycles = np.zeros(5, np.int64)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = dll.perphil_structured_ilu_apply(
            r.data_ptr(), z.data_ptr(), y.data_ptr(), pc.packed_lower.data_ptr(), pc.packed_upper.data_ptr(),
            pc.level_ptr.data_ptr(),
            pc.level_rows.data_ptr(), pc.meta.ctypes.data, len(pc.deltas), pc.nrows, pc.num_levels,
            pc.max_level_rows, geometry.ctypes.data, stream,
        )
        if err:
            raise RuntimeError(f"perphil_structured_ilu_apply: CUDA error {err}")

    ms = median_ms(run, 20)
    for _ in range(2):  # the first take clears what the timed runs added
        run()
        torch.cuda.synchronize()
        err = dll.perphil_ilu_profile_take(cycles.ctypes.data)
        if err:
            raise RuntimeError(f"perphil_ilu_profile_take: CUDA error {err}")
    levels = 2 * pc.num_levels
    names = ("consumer: wait for a full stage", "consumer: rows", "consumer: barrier",
             "producer: wait for an empty stage", "producer: issue copies")
    diff = float((z - pc.plain(r)).abs().max())
    print(f"structured_ilu_apply {tag}: {pc.nrows} rows, {pc.num_levels} levels (widest {pc.max_level_rows}), "
          f"stages {geometry[0]}, z in shared memory {bool(geometry[1])}, "
          f"{geometry[2]} B dynamic, "
          f"{ms:.4f} ms, {ms * 1e3 / (2 * pc.num_levels):.3f} us/level, max abs diff vs plain sweep {diff:.1e}")
    for name, c in zip(names, cycles.tolist()):
        print(f"    {name:>34}: {c / levels:8.0f} cycles/level")


def time_sweeps() -> None:
    import chip_smoke

    dev = torch.device("cuda", torch.cuda.current_device())
    kw = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    # the frame's roles where chip_smoke.py times them
    for element, n, pc, role in (("quad", 8, "none", "fused_gmres_ef64"), ("quad", 16, "none", None),
                                 ("quad", 64, "none", None), ("quad", 64, "fieldsplit_lu", None),
                                 ("tet", 8, "fieldsplit_lu", None)):
        W, params, bcs, _, _ = chip_smoke.problem(element, n, dev)
        op = DPPOperator(W, params)
        b = chip_smoke.newton_rhs(op, bcs)
        solver = FusedGMRESSolver(op, pc, role, **kw)
        ms = median_ms(lambda: solver.launch(b), 5)
        its = solver.launch(b).iterations
        print(f"{solver.role} {element} N={n} pc {pc}: {its} iterations, {ms:.4f} ms, "
              f"{ms * 1e3 / its:.3f} us/iteration; {solver.last_geometry}")
    # solve_dpp's wall at 2D N=8 plain GMRES (K5, as chip_smoke.py drives it):
    # the first call (the solver's set-up included), then the median of ten
    W, params, bcs, _, _ = chip_smoke.problem("quad", 8, dev)
    walls = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        its = solve_dpp(W, params, bcs, solver_parameters=sp.PLAIN_GMRES_PARAMS).iteration_number
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"solve_dpp quad N=8 PLAIN_GMRES_PARAMS: {its} iterations, wall {walls[0]:.4f} ms first, "
          f"{statistics.median(walls[1:]):.4f} ms after (host clock, median of 10)")
    for n, pc in ((16, "ilu"), (32, "ilu"), (64, "ilu"), (16, "fieldsplit_ilu"), (64, "fieldsplit_ilu")):
        W, params, bcs, _, _ = chip_smoke.problem("quad", n, dev)
        op = DPPOperator(W, params)
        b = chip_smoke.newton_rhs(op, bcs)
        solver = FusedGMRESSolver(op, pc, **kw)
        ms = median_ms(lambda: solver.launch(b), 5)
        its = solver.launch(b).iterations
        if pc == "ilu":  # one application a step and one a restart
            nlev, applications = solver.ilu.num_levels, its + -(-its // solver.restart)
        else:
            nlev, applications = solver.field_ilu[0].num_levels, sum(solver.launch_inner)
        print(f"{solver.role} quad N={n}: {its} iterations, {applications} ILU applications of 2 x {nlev} levels, "
              f"{ms:.4f} ms, {ms * 1e3 / (2 * nlev * applications):.4f} us per level swept; {solver.last_geometry}")
    for n in (32, 64, 128):
        W, params, _, _, _ = chip_smoke.problem("quad", n, dev)
        pc = StructuredILU0.for_field(FieldOperator(W.sub(0), params.k1, params.beta, params.mu))
        r = torch.randn(pc.nrows, dtype=torch.float64, generator=torch.Generator().manual_seed(0)).to(dev)
        ms = median_ms(lambda: pc.launch(r), 5)
        print(f"structured_ilu_apply field {n + 1}^2: {pc.num_levels} levels (widest {pc.max_level_rows}), "
              f"{ms:.4f} ms, {ms * 1e3 / (2 * pc.num_levels):.4f} us/level; {pc.last_geometry}")


def k1_libraries(root: Path, variants):
    """``root``'s ``dpp_apply.cu`` built alone, once for each variant (a dict
    of its ``constexpr int`` constants set otherwise), one ``nvcc`` each, in
    parallel."""
    src = root / "perphil_tpu_torch" / "csrc" / "dpp_apply.cu"
    out = _cuda.BUILD_DIR / "k1_alone"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for constants in variants:
        text = src.read_text()
        for name, value in constants.items():
            text, found = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
            if found != 1:
                raise RuntimeError(f"no constexpr int {name} in {src}")
        key = hashlib.sha256(text.encode()).hexdigest()[:16]
        copy, lib = out / f"dpp_apply_{key}.cu", out / f"libdpp_apply_{key}.so"
        copy.write_text(text)
        proc = subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(src.parent), "-o",
                                 str(lib), str(copy)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((constants, lib, proc))
    dlls = []
    for constants, lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(log)
        tag = " ".join(f"{k}={v}" for k, v in constants.items()) or "as built"
        # ptxas -v of the 3D f64 matvec kernel: registers, spills
        lines = log.splitlines()
        for k, line in enumerate(lines):
            if "Compiling entry function" in line and "IdLi3ELi0" in line:
                print(f"    {root.name} {tag}: " + "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[k + 1:k + 4] if "spill" in x or "Used" in x))
        dll = ctypes.CDLL(str(lib))
        for name in ("perphil_dpp_apply_f64", "perphil_dpp_apply_f32"):
            getattr(dll, name).argtypes = _cuda._SIGNATURES[name]
        dlls.append((tag, dll))
    return dlls


def time_k1(against: Optional[Path]) -> None:
    import chip_smoke
    from perphil_tpu_torch.ops.assembly import dpp_stencils
    from perphil_tpu_torch.ops.fused_apply import MODES, fused_dpp_apply_stacked, packed_weights
    from perphil_tpu_torch.solvers.solver import _build_linear_solver, _freeze

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream().cuda_stream
    lib = _cuda.library()
    old = None if against is None else k1_libraries(against, [{}])[0][1]
    # the kernel with one tuning constant set otherwise
    here = Path(__file__).resolve().parents[2]
    knobs = k1_libraries(here, [{}, {"kMinBlocks": 1}, {"kMinBlocks": 5}, {"kStages": 3}, {"kTileX": 32},
                                *({"kChunk": c} for c in (1, 2, 8, 16, 32))])
    gen = torch.Generator().manual_seed(0)

    def call(dll, dtype, z, y, w, shape, mode):
        nz, ny, nx = (1,) * (3 - len(shape)) + tuple(shape)
        half = z[0].numel() * z.element_size()
        sym = "perphil_dpp_apply_f64" if dtype == torch.float64 else "perphil_dpp_apply_f32"
        err = getattr(dll, sym)(z.data_ptr(), z.data_ptr() + half, y.data_ptr(), y.data_ptr() + half,
                                w.ctypes.data, nz, ny, nx, len(shape), MODES[mode], stream)
        if err:
            raise RuntimeError(f"{sym}: CUDA error {err}")

    for element, n in (("hex", 64), ("hex", 128), ("quad", 128)):
        W, params, _, _, _ = chip_smoke.problem(element, n, dev)
        shape, S = W.mesh.node_shape, dpp_stencils(W.mesh, params)
        w = packed_weights(*S)
        z = torch.randn((2,) + tuple(shape), generator=gen, dtype=torch.float64).to(dev)
        y = torch.empty_like(z)
        nbytes = 4 * 8 * W.mesh.num_vertices
        ms = chip_smoke.queued_ms(lambda: fused_dpp_apply_stacked(z, *S))
        line = (f"K1 {element} N={n} f64 matvec: {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                f"bytes bound {nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3:.4f} ms)")
        # each build of the knobs computes the package's bits
        for tag, d in knobs:
            for mode in MODES:
                call(d, torch.float64, z, y, w, shape, mode)
                if not torch.equal(y, fused_dpp_apply_stacked(z, *S, mode=mode)):
                    raise RuntimeError(f"K1 built with {tag} {mode}: not the package's bits")
        line += "; " + ", ".join(
            f"{tag} {chip_smoke.queued_ms(lambda: call(d, torch.float64, z, y, w, shape, 'matvec')):.4f}"
            for tag, d in knobs)
        z32, y32 = z.float(), y.float()
        line += f"; f32 {chip_smoke.queued_ms(lambda: call(lib, torch.float32, z32, y32, w, shape, 'matvec')):.4f}"
        print(line)
        if old is None:
            continue
        for dtype in (torch.float64, torch.float32):
            zt, yt, ref = z.to(dtype), torch.empty_like(z, dtype=dtype), torch.empty_like(z, dtype=dtype)
            for mode in MODES:
                call(lib, dtype, zt, yt, w, shape, mode)
                call(old, dtype, zt, ref, w, shape, mode)
                torch.cuda.synchronize()
                print(f"    {dtype} {mode}: max abs diff against {against.name}'s kernel "
                      f"{float((yt - ref).abs().max()):.1e}, bit-equal {torch.equal(yt, ref)}")
        turns = [("older", old), ("this", lib), ("this", lib), ("older", old)]
        print("    in turns (f64 matvec): " + ", ".join(
            f"{name} {chip_smoke.queued_ms(lambda: call(d, torch.float64, z, y, w, shape, 'matvec')):.4f} ms"
            for name, d in turns))

    presets = chip_smoke.presets()
    for n in (64, 128):
        W, params, bcs, _, _ = chip_smoke.problem("hex", n, dev)
        solver = _build_linear_solver(W, params, _freeze(presets["TPU_DIRECT_PARAMS"]))
        g1, g2 = (bc.grid_values(W.mesh) for bc in bcs)
        walls = []
        for _ in range(11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver(g1, g2)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls[1:])
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                solver(g1, g2)
            torch.cuda.synchronize()
        # the device's own rows (kernels, copies): an operator's row repeats its kernels' time
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        device = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))  # noqa: E731
        total = sum(device(e) for e in rows)
        k1 = sum(device(e) for e in rows if "dpp_apply_kernel" in e.key)
        share = "not measured (no device time in the trace)" if total == 0 else f"{100 * k1 / total:.1f}%"
        print(f"hex {n}^3 TPU_DIRECT_PARAMS: wall {wall:.4f} ms a solve (host clock, median of 10), "
              f"device busy {total / 5e3:.4f} ms a solve, K1's share of device time {share} "
              f"({k1 / 5e3:.4f} ms a solve)")


# copies of csrc/dpp_apply.cu built alone for --only halo, each with one
# part of the halo form set otherwise: (name, [(text, replacement)]). Their
# results are wrong where the part matters; they are timed, not checked.
HALO_VARIANTS = [
    ("every tile general", [("const bool general = (h.o0[2] > 0", "const bool general = true || (h.o0[2] > 0")]),
    ("no tile general", [("const bool general = (h.o0[2] > 0", "const bool general = false && (h.o0[2] > 0")]),
]


def halo_variants() -> dict:
    """:data:`HALO_VARIANTS` built alone (one ``nvcc`` each, in parallel),
    the halo launchers bound: name -> library."""
    src = _cuda.CSRC / "dpp_apply.cu"
    out = _cuda.BUILD_DIR / "halo_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, edits in HALO_VARIANTS:
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"halo variant {name!r}: {old!r} is not in dpp_apply.cu once")
            text = text.replace(old, new)
        key = hashlib.sha256(text.encode()).hexdigest()[:16]
        copy, lib = out / f"dpp_apply_{key}.cu", out / f"libdpp_apply_{key}.so"
        copy.write_text(text)
        jobs.append((name, lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(src.parent), "-o", str(lib), str(copy)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    dlls = {}
    for name, lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(log)
        dll = ctypes.CDLL(str(lib))
        for sym in ("perphil_dpp_apply_halo_f64", "perphil_dpp_apply_halo_f32"):
            getattr(dll, sym).argtypes = _cuda._SIGNATURES[sym]
        dlls[name] = dll
    return dlls


def time_halo() -> None:
    """``--only halo`` (the module's docstring)."""
    import chip_smoke
    import torch.nn.functional as F

    from perphil_tpu_torch.ops import fused_apply as fa
    from perphil_tpu_torch.ops.assembly import dpp_stencils
    from perphil_tpu_torch.parallel.halo import block_geometry, halo_box, loopback_planes, split_blocks

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream().cuda_stream
    probe = fa.halo_probe_library()
    variants = halo_variants()
    _cuda.library()
    entry = ""
    for line in Path(_cuda.BUILD_INFO["path"]).with_suffix(".log").read_text().splitlines():
        text = line.split("ptxas info    :")[-1].strip()
        if "Compiling entry function" in line:
            entry = text.split("'")[1]
        elif "dpp_apply" in entry and ("Used" in line or "spill" in line):
            print(f"  ptxas {entry[:72]}: {text}")
    wave = fa.halo_wave(dev, torch.float64, 3)
    print(f"the card's wave: {wave} blocks (occupancy x SMs)")
    gen = torch.Generator().manual_seed(0)
    k = 8
    for element, n in (("hex", 128), ("quad", 1023)):
        W, params, _, _, _ = chip_smoke.problem(element, n, dev)
        shape, S = W.mesh.node_shape, dpp_stencils(W.mesh, params)
        d = len(shape)
        z = torch.randn((2,) + tuple(shape), generator=gen, dtype=torch.float64).to(dev)
        zp = F.pad(z, [v for p in reversed([(-shape[0]) % k] + [0] * (d - 1)) for v in (0, p)])
        split = split_blocks(zp, (k,))
        planes = loopback_planes(split, (k,))
        local = [zp.shape[1] // k] + list(shape[1:])
        geoms = {c: block_geometry((k,), c, local, shape) for c in split}
        # (own fields, planes, geometry, the extended box for the first form) a launch
        cases = {f"slab {c[0]}": [(split[c][0], split[c][1], planes[c], geoms[c], halo_box(split[c], planes[c]))]
                 for c in [(0,), (3,), (7,)]}
        cases[f"{k} slabs"] = [(split[c][0], split[c][1], planes[c], geoms[c], halo_box(split[c], planes[c]))
                               for c in split]
        cases["padded box"] = [(zp[0], zp[1], (), (None, None, shape), zp)]
        cases["whole box"] = [(z[0], z[1], (), (None, None, None), z)]
        for label, launches in cases.items():
            chunks = [None] + ([2, 3, 4, 5, 6, 8] if d == 3 else [])
            runs = {"first": lambda L=launches: [fa.halo_probe_apply(probe, box, S, "matvec", *g)
                                                 for _, _, _, g, box in L]}
            if label == "whole box":
                runs["K1"] = lambda: [fa.fused_dpp_apply_stacked(z, *S)]
            plans = {}
            for chunk in chunks:
                name = "rule" if chunk is None else f"chunk {chunk}"
                built = []
                for z1, z2, pl, g, box in launches:
                    planes_, box_, geom = fa._planes_geometry(z1, z2, pl, g[1], g[2])
                    plan = fa.halo_plan(box_, *geom, wave=wave, chunk=chunk)
                    built.append((plan, fa._plane_regions(plan, z1, z2, planes_)))
                plans[name] = [p for p, _ in built]
                runs[name] = lambda B=built: [fa._halo_launch(p, r, S, "matvec", torch.float64, dev, d) for p, r in B]
                if chunk is None:
                    for vname, dll in variants.items():
                        def run(B=built, dll=dll):
                            for p, r in B:
                                sym, args, y, table = fa._halo_args(p, r, S, "matvec", torch.float64, dev, d)
                                _cuda.check(getattr(dll, sym)(*args, stream), f"halo variant {sym}")
                        runs[vname] = run
            want = runs["first"]()
            for name, fn in runs.items():
                if name not in variants and name != "K1" and not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                    raise RuntimeError(f"halo {element} {label} {name}: not the first form's bits")
            order = list(runs) + list(reversed(runs))
            times = chip_smoke.in_turns(runs, order)
            print(f"K1 halo form {element} N={n} {label} ({len(launches)} launch(es)): "
                  + ", ".join(f"{name} {_fmt(t)} ms" + (f" ({sorted({(p.blocks, p.chunk) for p in plans[name]})})"
                                                         if name in plans else "")
                              for name, t in times.items()))
        k1 = chip_smoke.in_turns({"K1": lambda: fa.fused_dpp_apply_stacked(z, *S)}, ["K1", "K1"])["K1"]
        print(f"K1 {element} N={n} on the whole grid: {_fmt(k1)} ms")


def phase_library() -> ctypes.CDLL:
    """This checkout's K2 and K3 launchers built alone into one library with
    the phase clocks compiled in (``PERPHIL_DIRECT_PROFILE``; one ``nvcc``
    each, in parallel), bound as the package binds them."""
    csrc = _cuda.CSRC
    out = _cuda.BUILD_DIR / "direct_phases"
    out.mkdir(parents=True, exist_ok=True)
    flags = [*_cuda.NVCC_FLAGS, "-DPERPHIL_DIRECT_PROFILE"]
    sources = [csrc / "fused_direct.cu", csrc / "fused_pcg.cu"]
    procs = [subprocess.Popen([_cuda._nvcc(), *flags, "-c", "-I", str(csrc), "-o", str(out / f"{s.stem}.o"),
                               str(s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s in sources]
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(log)
    lib = out / "libdirect_phases.so"
    subprocess.run([_cuda._nvcc(), *flags, "-shared", "-o", str(lib),
                    *[str(out / f"{s.stem}.o") for s in sources]], check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ("perphil_fused_direct", "perphil_fused_pcg"):
        getattr(dll, name).argtypes = _cuda._SIGNATURES[name]
    for name in ("perphil_fused_direct_profile_take", "perphil_fused_pcg_profile_take"):
        getattr(dll, name).argtypes = [_P]
    return dll


# the phases of each kernel's clocks (fused_direct.cu DirectPhase,
# fused_pcg.cu PcgPhase), in slot order; "pass i": transform pass i
K2_PHASES = ["setup", "matvec", "max reduction", "f32 write"] + [f"pass {i}" for i in range(6)] + ["end"]
K3_PHASES = ["setup", "first preconditioner", "matvec", "<p, A p>", "x, r update"] + [
    f"pass {i}" for i in range(6)] + ["dots, p update", "end"]


def ngs_phase_library() -> ctypes.CDLL:
    """``csrc/fused_ngs.cu`` built alone with its phase clocks compiled in
    (``PERPHIL_NGS_PROFILE``), bound as the package binds it."""
    return _cuda.variant_library("fused_ngs.cu", "PERPHIL_NGS_PROFILE", {
        "perphil_fused_ngs": _cuda._SIGNATURES["perphil_fused_ngs"], "perphil_fused_ngs_profile_take": [_P]})


# the phases of the NGS kernel's clocks (fused_ngs.cu NgsPhase), in slot order
NGS_PHASES = ["own rows", "halo send + wait", "norm rows", "squares to the tree", "tree"]


def ngs_case(n: int, max_it: Optional[int] = None):
    """(solver, b, x0, operator) of the Picard solve (``PICARD_LU_SOLVER_PARAMS``) at
    2D N=n on the card, ``max_it`` iterations at most where given."""
    import chip_smoke
    from perphil_tpu_torch.ops.fused_ngs import FusedNGSSolver

    W, params, bcs, _, _ = chip_smoke.problem("quad", n, torch.device("cuda", torch.cuda.current_device()))
    op = DPPOperator(W, params)
    b, x0 = chip_smoke.picard_inputs(op, bcs)
    picard = sp.PICARD_LU_SOLVER_PARAMS
    solver = FusedNGSSolver(op, rtol=picard["snes_rtol"], atol=picard["snes_atol"],
                            max_it=picard["snes_max_it"] if max_it is None else max_it)
    return solver, b, x0, op


def profile_ngs() -> None:
    """Cycles of thread 0 of block 0 an iteration in each phase of
    ``fused_ngs``, at 2D N=16/64/128."""
    from perphil_tpu_torch.ops.fused_ngs import RESULT_SLOTS

    dll = ngs_phase_library()
    stream = torch.cuda.current_stream().cuda_stream
    counters = np.zeros(len(NGS_PHASES), np.uint64)
    for n in (16, 64, 128):
        solver, b, x0, _ = ngs_case(n)
        ref = solver.launch(b, x0)
        x = torch.empty_like(b)
        result = torch.empty(RESULT_SLOTS, dtype=torch.float64, device=b.device)
        args = solver.launch_args(b, x0, x, result)

        def run():
            _cuda.check(dll.perphil_fused_ngs(*args, stream), "profile launch")

        run()
        torch.cuda.synchronize()
        if not torch.equal(x, ref.x):
            raise RuntimeError(f"N={n}: the clocked kernel's solution is not the package's")
        _cuda.check(dll.perphil_fused_ngs_profile_take(counters.ctypes.data), "profile take")
        ms = median_ms(run, 3)  # four launches
        _cuda.check(dll.perphil_fused_ngs_profile_take(counters.ctypes.data), "profile take")
        its, phases = ref.iterations, solver.sweeper.ncolors + 1
        cycles = counters.astype(np.float64) / 4 / its
        print(f"fused_ngs quad N={n}: {solver.plan}, {its} iterations, {ms:.3f} ms with the clocks "
              f"({ms * 1e3 / (its * phases):.3f} us a phase), {cycles.sum():.0f} cycles an iteration "
              f"({cycles.sum() * its / ms / 1e6:.2f} GHz of thread 0's): " + ", ".join(
                  f"{name} {c:.0f} ({c / cycles.sum() * 100:.1f}%)" for name, c in zip(NGS_PHASES, cycles)))


def cluster_library() -> ctypes.CDLL:
    """The first port's NGS kernel (``csrc/profile/fused_ngs_cluster.cu``:
    the frame's ownership, remote reads, a cluster barrier a colour) built
    alone."""
    out = _cuda.BUILD_DIR / "ngs_cluster"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libngs_cluster.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda.CSRC), "-o", str(lib),
                    str(_cuda.CSRC / "profile" / "fused_ngs_cluster.cu")], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    # b, x0, x, lists, cptr, xchg, result, weights(host), ny, nx, ncolors,
    # rtol, atol, max_it, blocks, nloc, stream
    ints, dbl = [ctypes.c_int], [ctypes.c_double]
    dll.perphil_fused_ngs_cluster.argtypes = [_P] * 8 + ints * 3 + dbl * 2 + ints * 3 + [_P]
    return dll


def cluster_tables(node_shape, colors: np.ndarray, blocks: int, nloc: int):
    """The first port's colour lists: per block its interior rows' slots
    sorted by (colour, slot), value e on block ``(e >> 2) mod blocks`` in
    slot ``((e >> 2) // blocks) * 4 + e mod 4``, and each block's colour
    bounds."""
    ny, nx = node_shape
    ncolors = int(colors.max()) + 1
    e = np.arange(colors.size)
    j, i = np.divmod(e % (ny * nx), nx)
    interior = (j > 0) & (j < ny - 1) & (i > 0) & (i < nx - 1)
    piece = e >> 2
    owner, slot = piece % blocks, (piece // blocks) * 4 + (e & 3)
    lists = np.zeros((blocks, nloc), np.int32)
    cptr = np.zeros((blocks, ncolors + 1), np.int32)
    for b in range(blocks):
        mine = interior & (owner == b)
        order = np.lexsort((slot[mine], colors[mine]))
        lists[b, : order.size] = slot[mine][order]
        cptr[b, 1:] = np.cumsum(np.bincount(colors[mine], minlength=ncolors))
    return lists, cptr


# 2D N=255 runs to this many iterations in --only ngs (its solve is some
# 15,000), so that the turns stay short
NGS_CAP_255 = 2000


def time_ngs() -> None:
    """``fused_ngs`` against the first port's kernel, in turns (older, this,
    this, older; CUDA events, median of 3 each) at 2D N=64/128/255, both
    held to each other bit for bit; the empty phase (the same launch with
    as many empty colours again: a halo exchange with no rows) and the
    latency floor it gives; then each block count the launcher places at
    2D N=32/64/128/255, in turns."""
    from perphil_tpu_torch.ops.fused_gmres import _slice_len, launch_geometry
    from perphil_tpu_torch.ops.fused_ngs import MAX_COLORS, RESULT_SLOTS

    old = cluster_library()
    lib = _cuda.library()
    stream = torch.cuda.current_stream().cuda_stream
    sizes = {64: None, 128: None, 255: NGS_CAP_255}
    for n, cap in sizes.items():
        solver, b, x0, _ = ngs_case(n, cap)
        sw, plan = solver.sweeper, solver.plan
        ny, nx = solver.node_shape
        geo = launch_geometry(b.numel())
        nloc = _slice_len(b.numel(), geo.blocks)
        lists, cptr = (torch.tensor(t, device=b.device) for t in cluster_tables(solver.node_shape, sw.colors,
                                                                                 geo.blocks, nloc))
        x_old, x_new = torch.empty_like(b), torch.empty_like(b)
        res_old = torch.empty(6, dtype=torch.float64, device=b.device)
        res_new = torch.empty(RESULT_SLOTS, dtype=torch.float64, device=b.device)
        xchg = torch.empty(4096, dtype=torch.float64, device=b.device)
        old_args = (b.data_ptr(), x0.data_ptr(), x_old.data_ptr(), lists.data_ptr(), cptr.data_ptr(), xchg.data_ptr(),
                    res_old.data_ptr(), solver.weights.ctypes.data, ny, nx, sw.ncolors, solver.rtol, solver.atol,
                    solver.max_it, geo.blocks, nloc)
        new_args = solver.launch_args(b, x0, x_new, res_new)
        runs = {"older": lambda: _cuda.check(old.perphil_fused_ngs_cluster(*old_args, stream), "older kernel"),
                "this": lambda: _cuda.check(lib.perphil_fused_ngs(*new_args, stream), "fused_ngs")}
        times = {"older": [], "this": []}
        for turn in ("older", "this", "this", "older"):
            times[turn].append(median_ms(runs[turn], 3))
        its = int(res_new[0])
        same = torch.equal(x_old, x_new) and torch.equal(res_old[:3], res_new[:3])
        phases = its * (sw.ncolors + 1)
        print(f"fused_ngs quad N={n}" + (f" (capped at {cap} iterations)" if cap else "") + f": {its} iterations, "
              f"{sw.ncolors} colours; older kernel {geo.blocks} blocks, "
              f"{' / '.join(f'{t:.3f}' for t in times['older'])} ms; this {plan} "
              f"{' / '.join(f'{t:.3f}' for t in times['this'])} ms ({statistics.mean(times['this']) * 1e3 / phases:.3f}"
              f" us a phase, older {statistics.mean(times['older']) * 1e3 / phases:.3f}); x, its, fn and f0 equal: "
              f"{same}", flush=True)
        if not same:
            raise RuntimeError(f"N={n}: the two kernels disagree")
        # the empty phase: up to as many colours again (the kernel takes 32
        # at most), with no rows and no pushes
        c = min(sw.ncolors, MAX_COLORS - sw.ncolors)
        cptr2 = torch.cat([solver.cptr, solver.cptr[:, -1:].expand(-1, c)], 1).contiguous()
        sends2 = torch.cat([solver.sends, torch.zeros_like(solver.sends[:, :c])], 1).contiguous()
        x_empty = torch.empty_like(b)
        args2 = list(new_args)
        args2[2], args2[4], args2[5], args2[10] = x_empty.data_ptr(), cptr2.data_ptr(), sends2.data_ptr(), sw.ncolors + c
        ms = {}
        for turn in ("this", "empty", "empty", "this"):
            fn = runs["this"] if turn == "this" else (
                lambda: _cuda.check(lib.perphil_fused_ngs(*args2, stream), "fused_ngs, empty colours"))
            ms.setdefault(turn, []).append(median_ms(fn, 3))
        if not torch.equal(x_empty, x_new):
            raise RuntimeError(f"N={n}: empty colours changed the solution")
        empty_us = (statistics.mean(ms["empty"]) - statistics.mean(ms["this"])) * 1e3 / (its * c)
        print(f"  empty phase at N={n}: {' / '.join(f'{t:.3f}' for t in ms['empty'])} ms with {c} empty colours "
              f"against {' / '.join(f'{t:.3f}' for t in ms['this'])}: {empty_us:.3f} us an empty phase; latency "
              f"floor {phases} phases x that = {phases * empty_us / 1e3:.3f} ms", flush=True)
    # the block-count sweep
    from perphil_tpu_torch.ops.fused_ngs import FusedNGSSolver

    for n in (32, 64, 128, 255):
        first, b, x0, op = ngs_case(n, NGS_CAP_255 if n == 255 else None)
        cases = {}
        for nb in (1, 2, 4, 8, 16):
            solver = FusedNGSSolver(op, first.sweeper, first.rtol, first.atol, first.max_it, blocks=nb)
            if solver.plan is not None:
                cases[nb] = solver
        times = {nb: [] for nb in cases}
        results = {}
        for _ in range(2):
            for nb, solver in cases.items():
                times[nb].append(median_ms(lambda: solver.launch(b, x0), 3))
        for nb, solver in cases.items():
            results[nb] = solver.launch(b, x0)
        ref = results[max(cases)]
        same = all(torch.equal(r.x, ref.x) and r.iterations == ref.iterations for r in results.values())
        print(f"block count at N={n} ({ref.iterations} iterations): " + ", ".join(
            f"{nb} blocks {' / '.join(f'{t:.3f}' for t in times[nb])} ms" for nb in cases)
            + f"; all equal bit for bit: {same}", flush=True)
        if not same:
            raise RuntimeError(f"N={n}: block counts disagree")


# copies of csrc/fused_ngs.cu with one choice made otherwise (--only
# ngs-variants): (name, replacements, whether the copy keeps the bits)
_NGS_VARIANTS = [
    ("cluster-scope halo ordering", [
        ("mbarrier.arrive.expect_tx.shared::cluster.b64", "mbarrier.arrive.expect_tx.release.cluster.shared::cluster.b64"),
        ("mbarrier.try_wait.parity.shared::cta.b64", "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64")], True),
    ("a reciprocal's product for the divide", [
        ("__ddiv_rn(r, dg[f])", "__dmul_rn(r, rdg[f])"),
        ("__shared__ double ws[2][18], dg[2];", "__shared__ double ws[2][18], dg[2], rdg[2];"),
        ("if (tid < 2) dg[tid] = wt.diag[tid];", "if (tid < 2) {\n    dg[tid] = wt.diag[tid];\n    rdg[tid] = 1.0 / dg[tid];\n  }")],
     False),
]


def ngs_variants() -> None:
    """``fused_ngs`` against copies of it built with one choice made
    otherwise (:data:`_NGS_VARIANTS`, one ``nvcc`` each, in parallel) and
    against its own kernel fed colour runs sorted by offset instead of dealt
    by bank, in turns (package first, then the copies, then back; CUDA
    events, median of 3 each) at 2D N=64/128/255 (255 capped at
    :data:`NGS_CAP_255` iterations). Every copy runs the package's iteration
    count (``rtol = atol = 0``); those that keep the bits are held to it."""
    from perphil_tpu_torch.ops.fused_ngs import RESULT_SLOTS, FusedNGSSolver

    out = _cuda.BUILD_DIR / "ngs_variants"
    out.mkdir(parents=True, exist_ok=True)
    # the halo helpers inlined, so that a variant may change them for this kernel alone
    source = (_cuda.CSRC / "fused_ngs.cu").read_text().replace(
        '#include "cluster_halo.cuh"', (_cuda.CSRC / "cluster_halo.cuh").read_text().replace("#pragma once", ""))
    procs = []
    for k, (name, subs, _) in enumerate(_NGS_VARIANTS):
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in fused_ngs.cu")
            text = text.replace(old, new)
        (out / f"v{k}.cu").write_text(text)
        procs.append(subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda.CSRC),
                                       "-o", str(out / f"v{k}.so"), str(out / f"v{k}.cu")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for k, ((name, _, _), proc) in enumerate(zip(_NGS_VARIANTS, procs)):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(log)
        libs[name] = ctypes.CDLL(str(out / f"v{k}.so"))
        libs[name].perphil_fused_ngs.argtypes = _cuda._SIGNATURES["perphil_fused_ngs"]
    keeps = {"package": True, "colour runs sorted by offset": True, **{name: keep for name, _, keep in _NGS_VARIANTS}}
    stream = torch.cuda.current_stream().cuda_stream
    for n in (64, 128, 255):
        first, b, x0, op = ngs_case(n, NGS_CAP_255 if n == 255 else None)
        ref = first.launch(b, x0)
        solver = FusedNGSSolver(op, first.sweeper, 0.0, 0.0, ref.iterations)
        x = torch.empty_like(b)
        result = torch.empty(RESULT_SLOTS, dtype=torch.float64, device=b.device)
        args = solver.launch_args(b, x0, x, result)
        runs = solver.lists.cpu().numpy().view(np.uint16).copy()
        cptr = solver.cptr.cpu().numpy()
        for blk in range(runs.shape[0]):
            for c in range(cptr.shape[1] - 1):
                runs[blk, cptr[blk, c]:cptr[blk, c + 1]].sort()
        in_order = torch.tensor(runs.view(np.int16), device=b.device)
        sorted_args = list(args)
        sorted_args[3] = in_order.data_ptr()
        lib = _cuda.library()
        cases = {"package": lambda: _cuda.check(lib.perphil_fused_ngs(*args, stream), "fused_ngs"),
                 "colour runs sorted by offset": lambda: _cuda.check(
                     lib.perphil_fused_ngs(*sorted_args, stream), "fused_ngs, sorted runs")}
        for name, dll in libs.items():
            cases[name] = (lambda d=dll, nm=name: _cuda.check(d.perphil_fused_ngs(*args, stream), nm))
        times = {name: [] for name in cases}
        equal = {}
        for order in (list(cases), list(cases)[::-1]):
            for name in order:
                times[name].append(median_ms(cases[name], 3))
                torch.cuda.synchronize()
                equal[name] = torch.equal(x, ref.x) and int(result[0]) == ref.iterations
        phases = ref.iterations * (first.sweeper.ncolors + 1)
        print(f"fused_ngs variants at quad N={n} ({ref.iterations} iterations, {first.plan.blocks} blocks): " + "; ".join(
            f"{name} {' / '.join(f'{t:.3f}' for t in times[name])} ms "
            f"({statistics.mean(times[name]) * 1e3 / phases:.3f} us a phase"
            + (f", bits {'kept' if equal[name] else 'LOST'})" if keeps[name] else ", bits not kept by design)")
            for name in cases), flush=True)
        for name in cases:
            if keeps[name] and not equal[name]:
                raise RuntimeError(f"N={n}: {name} lost the package's bits")


def profile_direct() -> None:
    """Cycles of thread 0 in each phase of K2 and K3 (the phase clocks'
    build), per solve and per step or iteration, at the published sizes."""
    import chip_smoke
    from perphil_tpu_torch.ops import fused_direct

    dev = torch.device("cuda", torch.cuda.current_device())
    dll = phase_library()
    stream = torch.cuda.current_stream().cuda_stream
    counters = np.zeros(16, np.uint64)
    for element, n in (("quad", 4), ("quad", 16), ("quad", 64), ("hex", 8), ("hex", 14),
                       ("triangle", 8), ("tet", 4), ("tet", 8), ("tet", 14)):
        W, params, bcs, _, _ = chip_smoke.problem(element, n, dev)
        op = DPPOperator(W, params)
        b = torch.stack(op.lifted_rhs(*[bc.grid_values(W.mesh) for bc in bcs])).contiguous()
        x = torch.empty_like(b)
        its = torch.zeros(1, dtype=torch.int32, device=dev)
        if W.mesh.is_tensor_product:
            solver = fused_direct.fused_direct_solve(op)
            names, take = K2_PHASES, dll.perphil_fused_direct_profile_take
            run = lambda: dll.perphil_fused_direct(  # noqa: E731
                b.data_ptr(), x.data_ptr(), *solver.launch_args(), stream)
        else:
            solver = fused_direct.fused_simplicial_direct_solve(op)
            names, take = K3_PHASES, dll.perphil_fused_pcg_profile_take
            run = lambda: dll.perphil_fused_pcg(  # noqa: E731
                b.data_ptr(), x.data_ptr(), its.data_ptr(), *solver.launch_args(), stream)
        _cuda.check(run(), "profile launch")
        torch.cuda.synchronize()
        _cuda.check(take(counters.ctypes.data), "profile take")
        launches = 20
        for _ in range(launches):
            _cuda.check(run(), "profile launch")
        torch.cuda.synchronize()
        _cuda.check(take(counters.ctypes.data), "profile take")
        cycles = counters[: len(names)].astype(np.float64) / launches
        loops = int(its.item()) if not W.mesh.is_tensor_product else solver.refinements
        ms = chip_smoke.queued_ms(lambda: run())
        total = cycles.sum()
        print(f"{'K2' if W.mesh.is_tensor_product else 'K3'} {element} N={n}: {solver.last_placement}, "
              f"{total:.0f} cycles a solve ({ms:.4f} ms device with the clocks: "
              f"{total / ms / 1e6:.2f} GHz of thread 0's), "
              f"{loops} {'refinement steps' if W.mesh.is_tensor_product else 'iterations'}")
        print("    cycles a solve: " + ", ".join(f"{name} {c:.0f}" for name, c in zip(names, cycles)))


def former_route(op):
    """The route a mesh the fused kernels do not take goes (as
    ``solvers/solver.py::_monolithic_direct`` sends it): the mixed-precision
    solver on quad/hex, ``cg`` with K1 and the lumped fast-diag on tri/tet.
    A function of the stacked right-hand side."""
    from perphil_tpu_torch.ops.direct import LumpedDPPPreconditioner
    from perphil_tpu_torch.ops.krylov import cg
    from perphil_tpu_torch.ops.mixed import MixedPrecisionDPPDirect

    if op.mesh.is_tensor_product:
        mixed = MixedPrecisionDPPDirect(op.mesh, op.params, device=op.W.device)
        return lambda b: torch.stack(mixed.solve(b[0], b[1]))
    pc, mv = LumpedDPPPreconditioner(op.mesh, op.params, device=op.W.device), op.stacked_matvec()
    return lambda b: cg(mv, b, rtol=1e-13, atol=0.0, max_it=2000, M_inv=pc)[0]


def wall_ms(fn, repeats: int = 10) -> float:
    """Median host-clock time of ``fn()`` followed by a synchronise, in ms."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


DIRECT_CASES = [  # element, N, also time the former route
    ("quad", 4, False), ("quad", 16, False), ("quad", 64, False), ("hex", 8, False), ("hex", 14, False),
    ("triangle", 8, False), ("tet", 4, False), ("tet", 8, False), ("tet", 14, False),
    # beyond the former envelope: one block, then clusters of 2, 4, 8 and 16
    ("quad", 65, True), ("quad", 66, True), ("quad", 80, True), ("quad", 96, True), ("quad", 100, True),
    ("quad", 110, True), ("quad", 120, True), ("quad", 125, True), ("quad", 129, True), ("quad", 130, True),
    ("quad", 160, True), ("quad", 182, True), ("quad", 256, True),
    ("hex", 16, True), ("hex", 17, True), ("hex", 18, True), ("hex", 24, True), ("hex", 32, True),
    ("hex", 33, True), ("hex", 40, True), ("hex", 41, True),
    ("triangle", 51, True), ("triangle", 52, True), ("triangle", 96, True), ("triangle", 128, True),
    ("triangle", 150, True), ("triangle", 160, True), ("triangle", 170, True), ("triangle", 171, True),
    ("triangle", 200, True), ("triangle", 240, True),
    ("tet", 14, True), ("tet", 16, True), ("tet", 24, True), ("tet", 31, True), ("tet", 32, True),
    ("tet", 39, True),
]
#: the published meshes (``--against`` times both trees there)
PUBLISHED = [(element, n) for element, n, beyond in DIRECT_CASES if not beyond]


def _direct_problem(element: str, n: int, dev):
    import chip_smoke

    W, params, bcs, _, _ = chip_smoke.problem(element, n, dev)
    op = DPPOperator(W, params)
    return op, torch.stack(op.lifted_rhs(*[bc.grid_values(W.mesh) for bc in bcs])).contiguous()


def time_direct() -> None:
    import chip_smoke
    from perphil_tpu_torch.ops import fused_direct

    dev = torch.device("cuda", torch.cuda.current_device())
    lib = _cuda.library()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        _cuda.check(lib.perphil_empty_launch(stream), "perphil_empty_launch")

    print(f"empty kernel through ctypes: device {chip_smoke.queued_ms(empty):.4f} ms, "
          f"call {chip_smoke.time_ms(empty, repeats=50):.4f} ms (CUDA events around the Python call)")
    for element, n, beyond in DIRECT_CASES:
        op, b = _direct_problem(element, n, dev)
        mesh = op.mesh
        name = "K2" if mesh.is_tensor_product else "K3"
        line = f"{name} {element} N={n} ({2 * mesh.num_vertices} values)"
        if fused_direct.mesh_plan(op) is None:
            print(f"{line}: the plan places it nowhere", flush=True)
            continue
        # timed where the plan places it, joined or not
        solver = (fused_direct.FusedDirectSolver if mesh.is_tensor_product else fused_direct.FusedSimplicialSolver)(op)
        joins = (fused_direct.fused_direct_supported if mesh.is_tensor_product
                 else fused_direct.fused_simplicial_direct_supported)(op)
        out = solver.launch(b)
        got = out[0] if isinstance(out, tuple) else out
        kernel = lambda: solver.launch(b)  # noqa: E731
        calls = 100 if mesh.num_vertices < 20000 else 10
        line += (f": device {chip_smoke.queued_ms(kernel, calls=calls):.4f} ms, "
                 f"call {chip_smoke.time_ms(kernel, repeats=20):.4f} ms; {solver.plan}, "
                 f"{'joins' if joins else 'left to the former route'}")
        if beyond:
            route = former_route(op)
            ref = route(b)
            torch.cuda.synchronize()
            walls = [wall_ms(fn) for fn in (kernel, lambda: route(b)) * 2]
            line += (f"; former route vs kernel max rel diff {chip_smoke.rel(got, ref):.2e}; wall in turns "
                     f"(host clock, median of 10; kernel, route, kernel, route): "
                     + ", ".join(f"{w:.4f}" for w in walls) + " ms")
        print(line, flush=True)


def wrapper_times(out: Path) -> None:
    """``--only direct-wrapper``: device and call time of the K2/K3 solvers'
    ``launch`` (the interface every version of the package has) at the
    published meshes, with the package of the checkout the process was
    started in; each solution and the two times saved to ``out`` (npz)."""
    import chip_smoke
    import perphil_tpu_torch
    from perphil_tpu_torch.ops import fused_direct

    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"  the package of {Path(perphil_tpu_torch.__file__).parent.parent}", flush=True)
    saved = {}
    for element, n in PUBLISHED:
        op, b = _direct_problem(element, n, dev)
        make = (fused_direct.fused_direct_solve if op.mesh.is_tensor_product
                else fused_direct.fused_simplicial_direct_solve)
        solver = make(op)
        x = solver.launch(b)
        saved[f"{element} N={n}"] = (x[0] if isinstance(x, tuple) else x).cpu().numpy()
        run = lambda: solver.launch(b)  # noqa: E731
        saved[f"{element} N={n} ms"] = np.array([chip_smoke.queued_ms(run), chip_smoke.time_ms(run, repeats=20)])
    np.savez(out, **saved)


def compare_direct(against: Path) -> None:
    """K2/K3 of ``against`` (an older checkout) and of this one at the
    published meshes, each tree timed by ``--only direct-wrapper`` in a
    process started from its own root, in turns (older, this, this, older)."""
    import os

    here = Path.cwd()
    out = _cuda.BUILD_DIR / "direct_wrapper"
    out.mkdir(parents=True, exist_ok=True)
    turns = [("older", against.resolve()), ("this", here), ("this", here), ("older", against.resolve())]
    runs = []
    for k, (_, root) in enumerate(turns):
        path = out / f"turn{k}.npz"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--only", "direct-wrapper", "--out", str(path)],
                       cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, check=True)
        runs.append(np.load(path))
    for element, n in PUBLISHED:
        tag = f"{element} N={n}"
        x_old, x_new = runs[0][tag], runs[1][tag]
        diff = float(np.abs(x_new - x_old).max() / np.abs(x_old).max())
        print(f"{tag}: max rel diff this vs older {diff:.2e}; device ms " + ", ".join(
            f"{t} {r[tag + ' ms'][0]:.4f}" for (t, _), r in zip(turns, runs)) + "; call ms " + ", ".join(
            f"{t} {r[tag + ' ms'][1]:.4f}" for (t, _), r in zip(turns, runs)), flush=True)


def band_libraries() -> dict:
    """The kernels ``--only band`` builds alone (one ``nvcc`` each, in
    parallel): ``band_trisolve`` with its phase clocks
    (``PERPHIL_LEVEL_PROFILE``), a copy with the hardware cluster barrier
    (``PERPHIL_LEVEL_CLUSTER_SYNC``), a copy without the vector's gathers
    (timing alone), the sync-free variant
    (``csrc/profile/band_trisolve_syncfree.cu``) and the first port's dense
    kernel (``csrc/profile/band_trisolve_dense.cu``, ``tools/band_dense.py``)."""
    from perphil_tpu_torch.tools import band_dense

    out = _cuda.BUILD_DIR / "band"
    out.mkdir(parents=True, exist_ok=True)
    # a copy whose lanes read their column indices in place of the vector's
    # values (no gathers; for timing alone, its results are wrong)
    no_gathers = out / "band_trisolve_no_gathers.cu"
    no_gathers.write_text((_cuda.CSRC / "band_trisolve.cu").read_text().replace(
        "v[k] = vec.load(cluster, sc[base + 32 * k]);", "v[k] = (double)sc[base + 32 * k];"))
    units = {"phases": (_cuda.CSRC / "band_trisolve.cu", ["-DPERPHIL_LEVEL_PROFILE"]),
             "cluster-sync": (_cuda.CSRC / "band_trisolve.cu", ["-DPERPHIL_LEVEL_CLUSTER_SYNC"]),
             "no-gathers": (no_gathers, []),
             "syncfree": (_cuda.CSRC / "profile" / "band_trisolve_syncfree.cu", [])}
    procs = {name: subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-shared", "-I", str(_cuda.CSRC), "-o",
                                     str(out / f"lib{name}.so"), str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (src, flags) in units.items()}
    band_dense.library()
    dlls = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(log)
        dlls[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    for name in ("phases", "cluster-sync", "no-gathers"):
        dlls[name].perphil_band_trisolve.argtypes = _cuda._SIGNATURES["perphil_band_trisolve"]
    dlls["phases"].perphil_band_trisolve_profile_take.argtypes = [_P]
    # r, z, vy, vx, fy, fx, blob, slices, perm, nsl_l, nsl, epoch, stream
    dlls["syncfree"].perphil_band_trisolve_syncfree.argtypes = [_P] * 9 + [ctypes.c_int] * 3 + [_P]
    return dlls


class SyncFree:
    """The sync-free variant's launch on a schedule's factor laid out for one
    block: per slice, in level order, the element offsets of its values,
    diagonals, columns and rows words in the blob."""

    def __init__(self, dll, Fc, perm, dev):
        from perphil_tpu_torch.ops import bandsolve as bs

        n = Fc.shape[0]
        rows = np.repeat(np.arange(n), np.diff(Fc.indptr))
        on_diag = np.flatnonzero(Fc.indices == rows)
        parts = [bs._sweep_layout(Fc, rows, on_diag, bs.sweep_levels(Fc, lower), lower, 1) for lower in (True, False)]
        (bl, dl, _), (bu, du, _) = parts
        du = du.copy()
        du[..., 0] += bl.size // 16
        table = []
        for off16, m, w, _ in np.concatenate([dl, du])[:, 0].tolist():
            off, slots, lanes = 16 * off16, 32 * m * w, 32 * m
            table += [((off + 256 * j * w) // 8, (off + 8 * slots + 256 * j) // 8,
                       (off + 8 * (slots + lanes) + 128 * j * w) // 4, (off + 12 * slots + 8 * lanes + 128 * j) // 4)
                      for j in range(m)]
        self.dll, self.nsl_l, self.nsl = dll, int(dl[:, 0, 1].sum()), len(table)
        self.blob = torch.from_numpy(np.concatenate([bl, bu])).to(dev)
        self.slices = torch.tensor(table, dtype=torch.int32, device=dev)
        self.perm = torch.from_numpy(perm.astype(np.int32)).to(dev)
        self.vy, self.vx = (torch.zeros(n, dtype=torch.float64, device=dev) for _ in range(2))
        self.fy, self.fx = (torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(2))
        self.epoch = 0

    def launch(self, r, z):
        self.epoch += 1
        _cuda.check(self.dll.perphil_band_trisolve_syncfree(
            r.data_ptr(), z.data_ptr(), self.vy.data_ptr(), self.vx.data_ptr(), self.fy.data_ptr(), self.fx.data_ptr(),
            self.blob.data_ptr(), self.slices.data_ptr(), self.perm.data_ptr(), self.nsl_l, self.nsl, self.epoch,
            torch.cuda.current_stream().cuda_stream), "sync-free variant")


def _turns(runs: dict, order, repeats: int = 20) -> dict:
    """Each run's median time (CUDA events) in the given order of turns."""
    times = {}
    for name in order:
        times.setdefault(name, []).append(median_ms(runs[name], repeats))
    return times


def _fmt(times) -> str:
    return " / ".join(f"{t:.4f}" for t in times)


def time_band() -> None:
    """``--only band``: ``band_trisolve`` (the level-scheduled sweep) at tet
    nx=16/24/40 in turns with the first port's dense kernel, per apply and
    per sweep; every placement the plan can take, in turns; an empty level
    (the latency floor); its phase clocks; the hardware cluster barrier and
    the sync-free variant; the cuSPARSE pair (``torch.triangular_solve`` on
    the factor's sparse triangles); each engine's host set-up from the
    factor; and the same pair beside ``structured_ilu_apply`` at 2D N=128;
    first the band plans up to nx=64 (host)."""
    import scipy.sparse as sparse

    import chip_smoke
    from perphil_tpu_torch.ops import bandsolve as bs
    from perphil_tpu_torch.tools import band_dense

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cpu").manual_seed(0)
    for nx in (4, 8, 16, 24, 32, 40, 64):
        _, perm, Fc, _ = chip_smoke.parity_factor(nx)
        t0 = time.perf_counter()
        sched = bs.level_schedule(Fc, perm)
        print(f"tet nx={nx}: {sched.n} rows, {sched.nnz} entries, {sched.slots} padded entries, {sched.slices} slices, "
              f"levels {sched.nlev}, {sched.blocks} block(s), vector in {'shared' if sched.shared_vector else 'device'} "
              f"memory, {sched.stages} stages of {sched.stage_bytes} B (schedule {time.perf_counter() - t0:.2f} s); "
              f"{bs.plan_of(sched)}", flush=True)
    dlls = band_libraries()
    stream = torch.cuda.current_stream().cuda_stream
    for nx in (16, 24, 40):
        mesh, perm, Fc, _ = chip_smoke.parity_factor(nx)
        n, grid = Fc.shape[0], (2,) + tuple(mesh.node_shape)
        band = bs.build_band_parity_ilu(bs.level_schedule(Fc, perm), dev)
        r = torch.randn(n, generator=gen, dtype=torch.float64).to(dev)
        ref = bs.level_apply_plain(band, r)
        z = torch.empty_like(r)
        nl, nu = band.nlev

        def level(b=band, desc=None, nlev=None, dll=None):
            return lambda: _cuda.check((dll or _cuda.library()).perphil_band_trisolve(
                *bs.launch_args(b, r, z, desc, nlev), stream), "band_trisolve")

        # the host set-up of each engine from the same factor, in turns (host
        # clock): the dense engine's bandwidth, plan and packed blocks against
        # the level schedule, its plan and its upload
        def setup(kind):
            t0 = time.perf_counter()
            if kind == "dense":
                nv = mesh.num_vertices
                band_dense.dense_band_plan(nv, band_dense.factor_bandwidth(Fc, nv))
                built = band_dense.build_dense_band_ilu(Fc, perm, nv, tuple(mesh.node_shape), dev)
            else:
                sched = bs.level_schedule(Fc, perm)
                bs.plan_of(sched)
                built = bs.build_band_parity_ilu(sched, dev)
            torch.cuda.synchronize()
            return built, (time.perf_counter() - t0) * 1e3

        walls = {}
        for kind in ("dense", "level", "level", "dense"):
            built, ms = setup(kind)
            walls.setdefault(kind, []).append(ms)
            del built
        print(f"tet nx={nx} host set-up from the factor: dense engine {_fmt(walls['dense'])} ms, level schedule "
              f"{_fmt(walls['level'])} ms (host clock, in turns)", flush=True)
        # the first port's dense engine on the same factor
        dense = band_dense.build_dense_band_ilu(Fc, perm, mesh.num_vertices, tuple(mesh.node_shape), dev)
        rg = r.view(grid)
        runs = {"dense": lambda: dense.apply(rg), "level": level()}
        times = _turns(runs, ("dense", "level", "level", "dense"))
        if not torch.equal(z, ref):
            raise RuntimeError(f"nx={nx}: band_trisolve differs from its twin")
        dense_err = chip_smoke.rel(dense.apply(rg).reshape(-1), ref)
        sweeps = {"forward": level(nlev=(nl, 0)),
                  "backward": level(desc=band.desc[nl:].contiguous(), nlev=(0, nu))}
        for name, lower, P in (("L11", True, dense.PL1), ("L22", True, dense.PL2), ("U22", False, dense.PU2),
                               ("U11", False, dense.PU1)):
            rp = torch.randn(P.shape[0] * P.shape[1], generator=gen, dtype=torch.float64).to(dev)
            sweeps[name] = (lambda P=P, rp=rp, lower=lower: band_dense.tri_apply(P, rp, lower, dense.pad))
        st = _turns(sweeps, list(sweeps) + list(sweeps)[::-1])
        # the cuSPARSE pair on the same factor, in turns
        lib = chip_smoke.sparse_pair(sparse.tril(Fc, -1), sparse.triu(Fc), dev)
        rp = r[band.perm.long()]
        lib_err = chip_smoke.rel(lib(rp), ref[band.perm.long()])
        lt = _turns({"level": level(), "cusparse": lambda: lib(rp)}, ("level", "cusparse", "cusparse", "level"), 10)
        print(f"tet nx={nx} apply: band_trisolve {_fmt(times['level'])} ms, dense kernel {_fmt(times['dense'])} ms "
              f"(in turns; its max rel diff {dense_err:.2e}); forward sweep {_fmt(st['forward'])} ms, backward "
              f"{_fmt(st['backward'])}; dense factors L11 {_fmt(st['L11'])}, L22 {_fmt(st['L22'])}, U22 "
              f"{_fmt(st['U22'])}, U11 {_fmt(st['U11'])} ms; cuSPARSE pair {_fmt(lt['cusparse'])} ms against "
              f"{_fmt(lt['level'])} (max rel diff {lib_err:.2e}); plan {band.blocks} block(s), shared vector "
              f"{band.shared_vector}", flush=True)
        del dense, lib
        # every placement, in turns, each held to the twin's bits
        cases = {}
        for blocks in bs.BLOCK_COUNTS:
            for shared in (True, False):
                try:
                    cases[(blocks, shared)] = bs.build_band_parity_ilu(bs.level_schedule(Fc, perm, blocks, shared), dev)
                except ValueError:
                    continue
        pt = _turns({k: level(b) for k, b in cases.items()}, list(cases) * 2)
        for k, b in cases.items():
            level(b)()
            if not torch.equal(z, ref):
                raise RuntimeError(f"nx={nx}: placement {k} differs from the twin")
        print(f"  placements at nx={nx} ({nl + nu} levels): " + "; ".join(
            f"{k[0]} block(s) {'shared' if k[1] else 'device'} {_fmt(pt[k])} ms" for k in cases), flush=True)
        # the empty level: as many levels again with no rows, where they fit
        L = nl + nu
        if bs.smem_bytes(n, 2 * L, band.stages, band.stage_bytes, band.shared_vector, band.blocks) <= bs.SMEM_BUDGET:
            desc2 = torch.cat([band.desc, torch.zeros_like(band.desc)]).contiguous()
            et = _turns({"this": level(), "empty": level(desc=desc2, nlev=(nl, nu + L))},
                        ("this", "empty", "empty", "this"))
            empty_us = (statistics.mean(et["empty"]) - statistics.mean(et["this"])) * 1e3 / L
            print(f"  empty level: {_fmt(et['empty'])} ms with {L} empty levels against {_fmt(et['this'])}: "
                  f"{empty_us:.3f} us an empty level; latency floor {L} x that = {L * empty_us / 1e3:.4f} ms",
                  flush=True)
        # the phase clocks (thread 0 of block 0)
        prof = dlls["phases"]
        buf = (ctypes.c_ulonglong * 3)()
        level(dll=prof)()
        torch.cuda.synchronize()
        prof.perphil_band_trisolve_profile_take(ctypes.addressof(buf))
        for _ in range(10):
            level(dll=prof)()
        torch.cuda.synchronize()
        prof.perphil_band_trisolve_profile_take(ctypes.addressof(buf))
        print("  cycles a level (thread 0 of block 0): " + ", ".join(
            f"{name} {b / 10 / L:.0f}" for name, b in zip(("stage wait", "own rows", "level barrier"), buf)), flush=True)
        # the hardware cluster barrier in place of the mbarrier exchange, in turns
        if band.blocks > 1:
            ht = _turns({"this": level(), "barrier.cluster": level(dll=dlls["cluster-sync"])},
                        ("this", "barrier.cluster", "barrier.cluster", "this"))
            level(dll=dlls["cluster-sync"])()
            if not torch.equal(z, ref):
                raise RuntimeError(f"nx={nx}: the cluster-barrier copy differs from the twin")
            print(f"  hardware cluster barrier {_fmt(ht['barrier.cluster'])} ms against the mbarrier exchange "
                  f"{_fmt(ht['this'])} (in turns)", flush=True)
        # what the vector's gathers cost: the copy without them, in turns
        gt = _turns({"this": level(), "no gathers": level(dll=dlls["no-gathers"])},
                    ("this", "no gathers", "no gathers", "this"))
        print(f"  without the vector's gathers (wrong results, timing alone) {_fmt(gt['no gathers'])} ms against "
              f"{_fmt(gt['this'])} (in turns)", flush=True)
        # the sync-free variant, in turns
        sync = SyncFree(dlls["syncfree"], Fc, perm, dev)
        zs = torch.empty_like(r)
        vt = _turns({"this": level(), "sync-free": lambda: sync.launch(r, zs)}, ("this", "sync-free", "sync-free", "this"))
        print(f"  sync-free variant {_fmt(vt['sync-free'])} ms against {_fmt(vt['this'])} (in turns); bit for bit: "
              f"{bool(torch.equal(zs, ref))}", flush=True)
        del band, cases, sync
    # the cuSPARSE pair beside structured_ilu_apply
    from perphil_tpu_torch.ops.ilu import StructuredILU0

    W, params, _, _, _ = chip_smoke.problem("quad", 128, dev)
    pc = StructuredILU0.for_monolithic(W.mesh, params)
    r = torch.randn(pc.nrows, generator=gen, dtype=torch.float64).to(dev)
    lib = chip_smoke.sparse_pair(*chip_smoke.structured_factor(pc), dev)
    err = chip_smoke.rel(lib(r), pc.launch(r))
    lt = _turns({"kernel": lambda: pc.launch(r), "cusparse": lambda: lib(r)}, ("kernel", "cusparse", "cusparse", "kernel"))
    print(f"structured_ilu_apply 2D N=128 monolithic: {_fmt(lt['kernel'])} ms, cuSPARSE pair {_fmt(lt['cusparse'])} ms "
          f"(in turns; max rel diff {err:.2e})", flush=True)


def time_partri() -> None:
    """``--only partri``: the partri ILU apply issued op by op and replayed
    from a CUDA graph, in turns, beside the wavefront kernel."""
    import chip_smoke
    from perphil_tpu_torch.ops import ilu
    from perphil_tpu_torch.ops.partri import nbytes

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cpu").manual_seed(0)
    for element, n in (("quad", 128), ("quad", 256), ("tet", 16)):
        W, params, _, _, _ = chip_smoke.problem(element, n, dev)
        pc = ilu.PartriILU.for_monolithic(W.mesh, params, dev)
        wave = ilu.StructuredILU0.for_monolithic(W.mesh, params, dev)
        r = torch.randn(pc.nrows, generator=gen, dtype=torch.float64).to(dev)
        # capture one apply on a side stream after a warm-up, as torch.cuda.graph asks
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                pc.apply_flat(r)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            z_graph = pc.apply_flat(r)
        graph.replay()
        z = pc.apply_flat(r)
        torch.cuda.synchronize()
        same = bool(torch.equal(z, z_graph))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            pc.apply_flat(r)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        times = {"issued": [], "graph": []}
        for turn in ("issued", "graph", "graph", "issued"):
            times[turn].append(median_ms((lambda: pc.apply_flat(r)) if turn == "issued" else graph.replay, 20))
        wave_ms = median_ms(lambda: wave.launch(r), 20)
        maps = nbytes(pc)
        bound_ms, _ = chip_smoke.bound(maps + 16 * pc.nrows, maps / 4)
        print(f"partri ILU {element} N={n} monolithic: issued {' / '.join(f'{t:.4f}' for t in times['issued'])} ms, "
              f"CUDA graph {' / '.join(f'{t:.4f}' for t in times['graph'])} ms (in turns; graph result equal to the "
              f"issued one: {same}); structured_ilu_apply {wave_ms:.4f} ms; "
              + (f"{len(kernels)} device kernels an apply, {busy_ms:.4f} ms of kernel time (torch.profiler); "
                 if kernels else "device kernels not measured (the profiler saw none); ")
              + f"maps {maps} B, bound {bound_ms:.4f} ms", flush=True)
        del graph, pc, wave


# the Picard inputs of --only gs: (element, N) on the manufactured solution
GS_TURNS = (("triangle", 16), ("triangle", 64), ("tet", 16))
GS_PLACEMENTS = (("triangle", 64), ("triangle", 128), ("tet", 16), ("tet", 24), ("tet", 34))
GS_ITERATIONS = 200
GS_REPEATS = 40  # --only gs-repeat: launches of each placement on each build
# the phase clocks' slots (fused_gs.cu GsPhase)
GS_PHASES = ["own rows", "level barrier + halo wait", "norm rows", "tree"]


def gs_case(element: str, n: int, max_it: Optional[int] = None, blocks: Optional[int] = None):
    """(solver, b, x0, operator) of the lexicographic Picard solve
    (``PICARD_LU_SOLVER_PARAMS``) on the card; with ``max_it``, that many
    iterations exactly (``rtol = atol = 0``)."""
    import chip_smoke
    from perphil_tpu_torch.ops.fused_gs import FusedGSSolver

    W, params, bcs, _, _ = chip_smoke.problem(element, n, torch.device("cuda", torch.cuda.current_device()))
    op = DPPOperator(W, params)
    b, x0 = chip_smoke.picard_inputs(op, bcs)
    picard = sp.PICARD_LU_SOLVER_PARAMS
    kw = (dict(rtol=picard["snes_rtol"], atol=picard["snes_atol"], max_it=picard["snes_max_it"]) if max_it is None
          else dict(rtol=0.0, atol=0.0, max_it=max_it))
    return FusedGSSolver(op, blocks=blocks, **kw), b, x0, op


def time_gs() -> None:
    """``--only gs`` (the module's docstring)."""
    from perphil_tpu_torch.ops.fused_gs import KERNEL, RESULT_SLOTS as GS_SLOTS, _place, gs_host_loop, probe_library
    from perphil_tpu_torch.ops.ilu import GS_KERNEL

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream().cuda_stream
    picard = sp.PICARD_LU_SOLVER_PARAMS
    snes = dict(rtol=picard["snes_rtol"], atol=picard["snes_atol"], max_it=picard["snes_max_it"])
    # the host route against the kernel, in turns (host clock around a call and a synchronise)
    for element, n in GS_TURNS:
        solver, b, x0, op = gs_case(element, n)
        solver.launch(b, x0)
        walls, counts = {"host route": [], "kernel": []}, {}
        for side in ("host route", "kernel", "kernel", "host route"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = gs_host_loop(op, solver.sweeper, b, x0, **snes) if side == "host route" else solver.launch(b, x0)
            torch.cuda.synchronize()
            walls[side].append((time.perf_counter() - t0) * 1e3)
            counts[side] = res.iterations
        its, levels = counts["kernel"], solver.plan.levels
        host_us, kernel_us = (statistics.mean(walls[side]) * 1e3 / counts[side] for side in ("host route", "kernel"))
        print(f"{element} N={n} ({solver.plan.blocks} block(s), {levels} levels): host route {counts['host route']} "
              f"iterations, {_fmt(walls['host route'])} ms ({host_us:.2f} us/iteration); fused_gs {its} iterations, "
              f"{_fmt(walls['kernel'])} ms ({kernel_us:.3f} us/iteration, {kernel_us / levels:.4f} us/level); "
              f"host clock, in turns", flush=True)
    # every placement, in turns: the package's launch, and the probe build's
    # with and without as many empty levels again a sweep (its empty level)
    probe = probe_library()
    for element, n in GS_PLACEMENTS:
        shape = gs_case(element, n, 1)[0].node_shape
        counts = [nb for nb in (1, 2, 4, 8, 16) if _place(shape, nb) is not None]
        cases = {nb: gs_case(element, n, GS_ITERATIONS, nb) for nb in counts}
        levels = cases[counts[0]][0].plan.levels
        runs, results, outputs = {}, {}, {}
        for nb, (solver, b, x0, _) in cases.items():
            results[nb] = solver.launch(b, x0)
            # the timed launches' outputs: they live as long as their runs
            outputs[nb] = (torch.empty_like(b), torch.empty(GS_SLOTS, dtype=torch.float64, device=dev))
            args = solver.launch_args(b, x0, *outputs[nb])
            runs[(nb, "package")] = lambda a=args: _cuda.launch(KERNEL, "perphil_fused_gs", dev, *a)
            for extra in (0, levels):
                runs[(nb, extra)] = lambda a=args, e=extra: _cuda.check(
                    probe.perphil_fused_gs_probe(*a, e, 0, stream), "perphil_fused_gs_probe")
        times = _turns(runs, list(runs) + list(runs)[::-1], repeats=3)
        ref = results[counts[0]]
        same = all(torch.equal(r.x, ref.x) and r.residual_norm == ref.residual_norm for r in results.values())
        same = same and all(torch.equal(x, ref.x) and res[0].item() == GS_ITERATIONS
                            and res[1].item() == ref.residual_norm for x, res in outputs.values())
        line = f"{element} N={n}, {GS_ITERATIONS} iterations, {levels} levels:"
        per = GS_ITERATIONS * levels * 1e-3
        for nb in counts:
            t, t0, te = (statistics.median(times[(nb, k)]) for k in ("package", 0, levels))
            line += (f" {nb} block(s) {_fmt(times[(nb, 'package')])} ms ({t / per:.4f} us/level; probe build "
                     f"{t0:.4f} ms, an empty level {(te - t0) / per:.4f} us);")
        print(line + f" all bit-equal: {same}", flush=True)
        if not same:
            raise RuntimeError(f"{element} N={n}: placements disagree")
    # cycles of thread 0 of block 0 in each phase
    counters = np.zeros(len(GS_PHASES), np.uint64)
    for element, n in GS_PLACEMENTS[:1] + (("triangle", 16), ("tet", 4), ("hex", 8)) + GS_PLACEMENTS[1:]:
        solver, b, x0, _ = gs_case(element, n, GS_ITERATIONS)
        x, res = torch.empty_like(b), torch.empty(GS_SLOTS, dtype=torch.float64, device=dev)
        args = solver.launch_args(b, x0, x, res)
        _cuda.check(probe.perphil_fused_gs_profile_take(counters.ctypes.data), "profile take")
        _cuda.check(probe.perphil_fused_gs_probe(*args, 0, 1, stream), "profile launch")
        torch.cuda.synchronize()
        _cuda.check(probe.perphil_fused_gs_profile_take(counters.ctypes.data), "profile take")
        per = counters.astype(np.float64) / GS_ITERATIONS
        levels = solver.plan.levels
        print(f"{element} N={n} ({solver.plan.blocks} block(s), {levels} levels): thread 0 of block 0, cycles a level: "
              f"own rows {per[0] / levels:.0f}, barrier + halo wait {per[1] / levels:.0f}; an iteration: norm rows "
              f"{per[2]:.0f}, tree {per[3]:.0f}; shares " + ", ".join(
                  f"{name} {100 * v / per.sum():.1f}%" for name, v in zip(GS_PHASES, per)), flush=True)
    # the GS mode's empty level: its launch on an all-empty schedule of 2L and L levels
    for element, n in (("triangle", 16), ("triangle", 64)):
        solver = gs_case(element, n, 1)[0]
        swp = solver.sweeper
        xg = torch.zeros(swp.nrows, dtype=torch.float64, device=dev)
        z = torch.empty_like(xg)
        geometry = np.zeros(4, np.int32)
        runs = {}
        for mult in (1, 2):
            ptr = torch.zeros(mult * swp.num_levels + 1, dtype=torch.int32, device=dev)
            args = (xg.data_ptr(), xg.data_ptr(), z.data_ptr(), swp.packed.data_ptr(), ptr.data_ptr(),
                    swp.level_rows.data_ptr(), swp.meta.ctypes.data, len(swp.deltas), swp.nrows,
                    mult * swp.num_levels, swp.max_level_rows, geometry.ctypes.data)
            runs[mult] = (lambda a=args, keep=ptr: _cuda.launch(GS_KERNEL, "perphil_gs_sweep", dev, *a))
        times = _turns(runs, [1, 2, 2, 1], repeats=20)
        one, two = statistics.median(times[1]), statistics.median(times[2])
        empty = (two - one) * 1e3 / swp.num_levels
        full = median_ms(lambda: swp.launch(xg, xg), 20)
        print(f"structured_ilu_apply[gs] {element} N={n}: a sweep {full:.4f} ms over {swp.num_levels} levels "
              f"({full * 1e3 / swp.num_levels:.3f} us/level); an empty level {empty:.4f} us (all-empty schedules of "
              f"{swp.num_levels} / {2 * swp.num_levels} levels: {_fmt(times[1])} / {_fmt(times[2])} ms), latency floor "
              f"{empty * swp.num_levels * 1e-3:.4f} ms a sweep", flush=True)


def repeat_gs() -> None:
    """``--only gs-repeat`` (the module's docstring)."""
    from perphil_tpu_torch.ops.fused_gs import KERNEL, RESULT_SLOTS as GS_SLOTS, _place, probe_library

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream().cuda_stream
    probe = probe_library()
    for element, n in GS_PLACEMENTS:
        shape = gs_case(element, n, 1)[0].node_shape
        counts = [nb for nb in (1, 2, 4, 8, 16) if _place(shape, nb) is not None]
        ref, launches, t0 = None, 0, time.perf_counter()
        for nb in counts:
            solver, b, x0, _ = gs_case(element, n, GS_ITERATIONS, nb)
            levels, outputs = solver.plan.levels, []
            for _ in range(GS_REPEATS):  # queued back to back, the probe's between the package's
                for extra in (None, 0, levels):
                    outputs.append((torch.empty_like(b), torch.empty(GS_SLOTS, dtype=torch.float64, device=dev)))
                    args = solver.launch_args(b, x0, *outputs[-1])
                    if extra is None:
                        _cuda.launch(KERNEL, "perphil_fused_gs", dev, *args)
                    else:
                        _cuda.check(probe.perphil_fused_gs_probe(*args, extra, 0, stream), "perphil_fused_gs_probe")
            torch.cuda.synchronize()
            ref = outputs[0] if ref is None else ref
            bad = sum(not (torch.equal(x, ref[0]) and torch.equal(res[:3], ref[1][:3])) for x, res in outputs)
            launches += len(outputs)
            if bad:
                raise RuntimeError(f"{element} N={n} on {nb} block(s): {bad} of {len(outputs)} launches disagree")
        print(f"{element} N={n}, {GS_ITERATIONS} iterations: {launches} launches ({GS_REPEATS} a placement and "
              f"build: the package's, the probe's with 0 and with {levels} empty levels more a sweep) on "
              f"{counts} block(s), all bit-equal to the first; {time.perf_counter() - t0:.1f} s", flush=True)


# --only ngs-blocked: the iterations issued between read-backs
NGS_EVERY = (8, 16, 32, 64)
# loopback layouts of the blocked iteration at 2D N=64, and those on which
# the first blocked loop runs too (its solves take seconds)
NGS_LAYOUTS = ((2,), (4,), (8,), (2, 2))
NGS_FIRST_LAYOUTS = ((2,), (2, 2))
# the measurement builds of the colour step (csrc/ngs_colour_halo.cu)
NGS_STEP_VARIANTS = ("EMPTY_STEP", "NO_TAPS", "NO_DIVIDE", "BARE")
# the measurement builds of the norm (PERPHIL_NGS_NORM_*): the launches
# alone, no rows stage, no taps, no tail
NGS_NORM_PARTS = ("EMPTY", "NO_ROWS", "NO_TAPS", "NO_TAIL")


def _walls_in_turns(runs: dict, order) -> dict:
    """Host wall of a whole call (synchronised before and after) of each
    run, in the given order of turns: name -> (seconds in order, last
    result)."""
    out = {}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runs[name]()
        torch.cuda.synchronize()
        times, _ = out.get(name, ([], None))
        out[name] = (times + [time.perf_counter() - t0], res)
    return out


def _turns_text(order, walls: dict) -> str:
    seen = {}
    parts = []
    for name in order:
        k = seen[name] = seen.get(name, -1) + 1
        parts.append(f"{name} {walls[name][0][k]:.4f}")
    return " / ".join(parts)


def time_ngs_blocked() -> None:
    """``--only ngs-blocked`` (the module's docstring)."""
    import chip_smoke
    from perphil_tpu_torch.ops.fused_ngs import (
        FirstNormSweep,
        FusedNGSSolver,
        NgsBlock,
        NgsSweep,
        blocked_ngs,
        blocked_ngs_probe,
        norm_probe_library,
        probe_library,
    )
    from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper
    from perphil_tpu_torch.parallel.transpose import LoopbackBlocks

    dev = torch.device("cuda", torch.cuda.current_device())
    probe = probe_library()
    first_norm = norm_probe_library()
    time_ngs_norm(dev, first_norm)  # the norm's checks first: a wrong norm fails the solves' checks below
    # the floor of a launch through ctypes: an empty kernel, queued and from
    # a graph of as many launches as 32 iterations make (15 an iteration)
    lib = _cuda.library()

    def empty():
        _cuda.check(lib.perphil_empty_launch(torch.cuda.current_stream().cuda_stream), "perphil_empty_launch")

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(15 * 32):
            empty()
    print(f"an empty launch: queued {chip_smoke.queued_ms(empty, calls=200) * 1e3:.2f} us, from a graph "
          f"{median_ms(graph.replay, 5) / (15 * 32) * 1e3:.2f} us")
    step_sig = [_cuda._P, _cuda._P, _cuda._I, _cuda._P] + [_cuda._I] * 3 + [_cuda._P, _cuda._I, _cuda._I, _cuda._P, _cuda._P]
    variants = {name.lower(): _cuda.variant_library("ngs_colour_halo.cu", f"PERPHIL_NGS_{name}",
                                                    {"perphil_ngs_colour_step": step_sig})
                for name in NGS_STEP_VARIANTS}
    picard = sp.PICARD_LU_SOLVER_PARAMS
    tols = (float(picard["snes_rtol"]), float(picard["snes_atol"]), int(picard["snes_max_it"]))
    for n in (64, 128):
        W, params, bcs, _, _ = chip_smoke.problem("quad", n, dev)
        op = DPPOperator(W, params)
        b, x0 = chip_smoke.picard_inputs(op, bcs)
        sw = ColoredNGSSweeper(W.mesh, params, dev)
        shape = W.mesh.node_shape
        fused = FusedNGSSolver(op, sw, *tols)
        want = fused(b, x0)
        one = LoopbackBlocks((1,))
        c = one.coords[0]
        sweep = NgsSweep(sw, shape, one)

        def held(name, res, x):
            if res.iterations != want.iterations or not torch.equal(x, want.x):
                raise AssertionError(f"2D N={n} {name}: {res.iterations} iterations, not fused_ngs's "
                                     f"{want.iterations} and its iterate")

        # the iterations between read-backs, in turns with fused_ngs
        runs = {f"every {k}": (lambda k=k: blocked_ngs(sweep, {c: b}, {c: x0}, *tols, every=k)) for k in NGS_EVERY}
        runs["fused"] = lambda: fused(b, x0)
        runs["first"] = lambda: blocked_ngs_probe(probe, one, {c: NgsBlock(sw, shape, (1,), c)}, {c: b},
                                                 {c: x0.clone()}, *tols)
        first_sweep = FirstNormSweep(first_norm, sw, shape, one)
        runs["first norm"] = lambda: blocked_ngs(first_sweep, {c: b}, {c: x0}, *tols)
        order = ["first", "first norm", *[f"every {k}" for k in NGS_EVERY], "fused"]
        order = order + order[::-1]
        walls = _walls_in_turns(runs, order)
        for name, (_, res) in walls.items():
            held(name, res, res.x if name == "fused" else res.x[c])
        print(f"blocked Picard 2D N={n} on one block, {want.iterations} iterations, bit for bit with fused_ngs: in "
              f"turns {_turns_text(order, walls)} s (host clock, a solve)")
        # an iteration on the card: k iterations that never stop, from the
        # graph and issued launch by launch (CUDA events around the calls)
        sweep.reset(0.0, 0.0, 2 ** 30)
        sweep.load({c: b}, {c: x0})
        sweep.norm(init=True)
        per_it = {}
        for k in NGS_EVERY:
            per_it[f"graph {k}"] = median_ms(lambda k=k: sweep.issue(k), 5) / k
        per_it["issued"] = median_ms(sweep.iteration, 20)
        per_it["queued"] = chip_smoke.queued_ms(sweep.iteration, calls=50)
        # a colour step (the mean of the colours, queued) beside the
        # measurement builds of ngs_colour_halo.cu, in turns
        stream = torch.cuda.current_stream().cuda_stream

        def steps(fn):
            for colour in range(sweep.ncolors):
                start, edge, end = sweep.spans[colour]
                _cuda.check(fn(sweep.table.data_ptr(), sweep.words.ctypes.data, len(sweep.coords),
                               sweep.rows.data_ptr(), start, edge, end, sweep.weights.ctypes.data, *sweep.n_phys,
                               sweep.state.data_ptr(), stream), "perphil_ngs_colour_step")

        step_fns = {"package": lib.perphil_ngs_colour_step, **{name: v.perphil_ngs_colour_step for name, v in variants.items()}}
        order = list(step_fns) + list(step_fns)[::-1]
        step_us = {name: [] for name in step_fns}
        for name in order:
            step_us[name].append(chip_smoke.queued_ms(lambda fn=step_fns[name]: steps(fn), calls=20) / sweep.ncolors * 1e3)
        print(f"blocked Picard 2D N={n}: a colour step in turns "
              + ", ".join(f"{name} {' / '.join(f'{t:.2f}' for t in ts)} us" for name, ts in step_us.items())
              + " (CUDA events, launches queued; the variants' results are wrong)")
        print(f"blocked Picard 2D N={n}: an iteration {', '.join(f'{k} {v * 1e3:.2f} us' for k, v in per_it.items())}"
              " (from the graph of k iterations; issued: a call of 14 step launches and a norm, host included;"
              " queued: the same behind a sleep)")
        if n != 64:
            continue
        # loopback layouts of the phantom-padded grid, the first loop on some
        for ms in NGS_LAYOUTS:
            pad = [(-v) % s for v, s in zip(shape, ms)] + [0] * (2 - len(ms))
            grid = (shape[0] + pad[0], shape[1] + pad[1])
            L = LoopbackBlocks(ms)
            bs, xs = (L.cut(torch.nn.functional.pad(t, [0, pad[1], 0, pad[0]]), lead=1) for t in (b, x0))
            swl = NgsSweep(sw, grid, L)
            swf = FirstNormSweep(first_norm, sw, grid, L)
            runs = {"this": lambda: blocked_ngs(swl, bs, xs, *tols), "fused": lambda: fused(b, x0),
                    "first norm": lambda: blocked_ngs(swf, bs, xs, *tols)}
            order = ["first norm", "this", "fused", "fused", "this", "first norm"]
            if ms in NGS_FIRST_LAYOUTS:
                parts = {q: NgsBlock(sw, grid, ms, q) for q in L.coords}
                runs["first"] = lambda: blocked_ngs_probe(probe, L, parts, bs, {q: v.clone() for q, v in xs.items()},
                                                         *tols)
                order = ["first"] + order + ["first"]
            walls = _walls_in_turns(runs, order)
            for name, (_, res) in walls.items():
                held(name, res, res.x if name == "fused" else L.join(res.x)[:, :shape[0], :shape[1]])
            print(f"blocked Picard 2D N={n} over loopback {ms} (padded {grid}), bit for bit with fused_ngs: in turns "
                  f"{_turns_text(order, walls)} s (host clock, a solve)")


def time_ngs_norm(dev, first_norm) -> None:
    """The blocked Picard norm (``ngs_colour_norm``: the rows stage, then
    the tree and tail) over ``chip_smoke.COLOUR_LAYOUTS`` (2D N=128, random
    x and b): bit for bit with the twin, the first norm kernel
    (``first_norm``: :func:`fused_ngs.norm_probe_library`) and the package
    at ``NORM_LEAVES`` 2; all in turns (launches queued) beside the bound;
    the measurement builds that skip a part, in turns (the split: launches,
    rows, taps, tree, tail); and on one block and 8 slabs an iteration from
    a graph of 32 with each norm."""
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke
    from perphil_tpu_torch.ops import fused_ngs
    from perphil_tpu_torch.ops.fused_ngs import FN, FirstNormSweep, NgsSweep, norm_variant_library
    from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper
    from perphil_tpu_torch.parallel.transpose import LoopbackBlocks

    with ThreadPoolExecutor(len(NGS_NORM_PARTS)) as pool:
        built = dict(zip(NGS_NORM_PARTS, pool.map(lambda v: norm_variant_library(f"PERPHIL_NGS_NORM_{v}"),
                                                  NGS_NORM_PARTS)))
    _cuda.library()
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True).stdout.strip().splitlines()
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), {nvcc[-1] if nvcc else 'nvcc ?'}, driver {driver}")
    entry = ""  # ptxas -v of the package's norm kernels (where this process built the package)
    for line in str(_cuda.BUILD_INFO.get("log", "")).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else ""
        elif "Used" in line and "ngs_norm" in entry:
            print(f"ptxas {entry}: {line.split('ptxas info    :')[-1].strip()}")
            entry = ""
    W, params = chip_smoke.problem("quad", 128, dev)[:2]
    sw = ColoredNGSSweeper(W.mesh, params, dev)
    shape = W.mesh.node_shape
    gen = torch.Generator(device="cpu").manual_seed(24)
    xq, bq = (torch.randn((2,) + shape, generator=gen, dtype=torch.float64).to(dev) for _ in range(2))

    def launcher(dll, sweep):
        def norm(init=False, residuals=None):
            _cuda.check(dll.perphil_ngs_norm(*sweep.norm_args(init, residuals),
                                             torch.cuda.current_stream().cuda_stream), "perphil_ngs_norm")
        return norm

    for ms, remote in chip_smoke.COLOUR_LAYOUTS:
        pad = [(-v) % s for v, s in zip(shape, ms)] + [0] * (2 - len(ms))
        grid = (shape[0] + pad[0], shape[1] + pad[1])
        L = LoopbackBlocks(ms)
        xs, bs = (L.cut(torch.nn.functional.pad(t, [0, pad[1], 0, pad[0]]), lead=1) for t in (xq, bq))

        def ready(sweep):
            sweep.reset(0.0, 0.0, 2 ** 30)  # tol 0: never done, so that every launch runs
            sweep.load(bs, xs)
            return sweep

        kern = ready(NgsSweep(sw, grid, L, remote=remote))
        twin = ready(NgsSweep(sw, grid, L, remote=remote, plain=True))
        first = ready(FirstNormSweep(first_norm, sw, grid, L, remote=remote))
        fused_ngs.NORM_LEAVES = 2
        try:
            kern2 = ready(NgsSweep(sw, grid, L, remote=remote))
        finally:
            fused_ngs.NORM_LEAVES = 1
        norms = {"this": (kern, kern.norm), "first": (first, first.norm), "leaves 2": (kern2, kern2.norm),
                 "twin": (twin, twin.norm)}
        got = {}
        for name, (sweep, norm) in norms.items():
            r = {c: torch.empty_like(v) for c, v in xs.items()}
            norm(init=True, residuals=r)
            torch.cuda.synchronize()
            got[name] = (L.join(r), float(sweep.state[FN]))
        where = f"2D N=128 over loopback {ms}{' through the exchange buffers' if remote else ''}"
        for name, (r, f) in got.items():
            if not (torch.equal(r, got["twin"][0]) and f == got["twin"][1]):
                raise AssertionError(f"ngs_colour_norm {where} [{name}]: residuals and norm not the twin's bits")
        nb = chip_smoke.bound(*chip_smoke.norm_work(kern))
        runs = {name: fn for name, (_, fn) in norms.items() if name != "twin"}
        order = (*runs, *reversed(runs))
        t = chip_smoke.in_turns(runs, order, calls=20)
        print(f"ngs_colour_norm {where} (padded {grid}; {kern.ctas} tree CTAs, {kern2.ctas} at 2 leaves): bit for "
              f"bit with the twin ({', '.join(n for n in got if n != 'twin')}); in turns "
              f"{chip_smoke.turns_text(order, t)} ms (CUDA events, launches queued); bound {nb[0]:.6f} ms ({nb[1]})",
              flush=True)
        # the split: the builds that skip a part, in turns with the package
        parts = {"this": kern.norm, **{v.lower(): launcher(built[v], kern) for v in NGS_NORM_PARTS}}
        order = (*parts, *reversed(parts))
        t = chip_smoke.in_turns(parts, order, calls=20)
        med = {name: statistics.median(ts) * 1e3 for name, ts in t.items()}
        tail = med["this"] - med["no_tail"]
        print(f"  the split (us, medians of 2 turns): package {med['this']:.2f}, launches alone {med['empty']:.2f}, "
              f"no rows {med['no_rows']:.2f}, no taps {med['no_taps']:.2f}, no tail {med['no_tail']:.2f}: rows "
              f"{med['this'] - med['no_rows']:.2f} (taps {med['this'] - med['no_taps']:.2f}), tail {tail:.2f}, "
              f"tree {med['no_rows'] - med['empty'] - tail:.2f}", flush=True)
        if remote or ms not in ((1,), (8,)):
            continue
        # an iteration from a graph of 32 (every colour's step and a norm)
        per_it = {}
        for name, (sweep, norm) in norms.items():
            if name == "twin":
                continue

            def issue(sweep=sweep, norm=norm):
                for _ in range(32):
                    for colour in range(sw.ncolors):
                        sweep.step(colour)
                    norm()

            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                issue()
            per_it[name] = median_ms(g.replay, 5) / 32 * 1e3
        print("  an iteration from a graph of 32, us: " + ", ".join(f"{k} {v:.2f}" for k, v in per_it.items()),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["gmres", "fieldsplit", "ilu", "sweeps", "k1", "direct", "direct-phases",
                                       "direct-wrapper", "ngs", "ngs-phases", "ngs-variants", "band", "partri", "gs",
                                       "gs-repeat", "halo", "ngs-blocked"],
                    help="profile one kind of kernel alone, or time the sweeps, K1 or K2/K3")
    ap.add_argument("--against", type=Path,
                    help="with --only k1 or direct: an older checkout's kernels to compare with")
    ap.add_argument("--out", type=Path, help="with --only direct-wrapper: the npz file to write")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))  # the checkout's chip_smoke.py: run from its root
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.only == "sweeps":
        time_sweeps()
        return 0
    if args.only == "k1":
        time_k1(args.against)
        return 0
    if args.only == "direct":
        time_direct()
        if args.against is not None:
            compare_direct(args.against)
        return 0
    if args.only == "direct-wrapper":
        wrapper_times(args.out)
        return 0
    if args.only == "direct-phases":
        profile_direct()
        return 0
    if args.only == "ngs":
        time_ngs()
        return 0
    if args.only == "ngs-phases":
        profile_ngs()
        return 0
    if args.only == "ngs-variants":
        ngs_variants()
        return 0
    if args.only == "band":
        time_band()
        return 0
    if args.only == "partri":
        time_partri()
        return 0
    if args.only == "gs":
        time_gs()
        return 0
    if args.only == "gs-repeat":
        repeat_gs()
        return 0
    if args.only == "halo":
        time_halo()
        return 0
    if args.only == "ngs-blocked":
        time_ngs_blocked()
        return 0
    dll = build()
    if args.only in (None, "gmres"):
        for element, n in (("quad", 8), ("quad", 16), ("quad", 64), ("tet", 16)):
            profile_gmres(dll, element, n)
    if args.only in (None, "fieldsplit"):
        time_k8_lines()
        for element, n, pc, inner in (("quad", 64, "fieldsplit_lu", "literal"), ("tet", 8, "fieldsplit_lu", "literal"),
                                      ("quad", 16, "fieldsplit_ilu", "literal"), ("quad", 64, "fieldsplit_ilu", "literal"),
                                      ("quad", 128, "fieldsplit_ilu", "literal"), ("quad", 64, "fieldsplit_ilu", "pcg")):
            profile_gmres(dll, element, n, pc, inner)
    if args.only not in (None, "ilu"):
        return 0
    import chip_smoke

    for n in (64, 128):
        W, params, _, _, _ = chip_smoke.problem("quad", n, torch.device("cuda", torch.cuda.current_device()))
        profile_ilu(dll, f"monolithic 2D N={n}", StructuredILU0.for_monolithic(W.mesh, params))
        profile_ilu(dll, f"field {n + 1}^2", StructuredILU0.for_field(FieldOperator(W.sub(0), params.k1, params.beta, params.mu)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
