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
at 2D N=16 and N=64) the same, with the inner PCG's phases (preconditioner,
field matvec, dots, vector updates) per inner iteration and the
preconditioner's cycles per sweep level (K8) or per transform pass (K6);
for ``structured_ilu_apply`` at 2D N=64/128 monolithic and on a 65^2 and
129^2 field, the time, the time per level, whether the result equals the
plain sweep bit for bit, and the cycles one consumer and one producer thread
spend in each part of a level. ``--only gmres|fieldsplit|ilu`` profiles one
of the three alone.

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

``--only band`` times ``band_trisolve`` (``csrc/band_trisolve.cu``) alone
with the package's library, per factor (L11, L22, U11, U22) of the
ordering-parity ILU at tet nx=4/8/16/24/32/40 (CUDA events, median of 20),
beside the bound (the packed blocks, r and y once at 3.35 TB/s) and the
rate it reached; for each size, and at nx=64 alone, it first prints the
factor's bandwidth and ``band_plan`` (B, nb, packed and workspace bytes),
computed on the host.

``--only partri`` builds nothing of its own: it times the partri ILU apply
(``ops/ilu.py::PartriILU``, torch ops) at 2D N=128/256 and tet nx=16
(monolithic) in turns (CUDA events, median of 20): issued op by op, as the
solvers run it, and replayed from a CUDA graph captured once (the same
kernels without the host between them; its result first held to the
issued apply's bit for bit), beside ``structured_ilu_apply`` on the same
factor, the maps' bytes and bound; and counts, with ``torch.profiler``, the
device kernels of one apply and their summed time.

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

PHASES = ["apply", "dots", "gram-schmidt+norm", "givens", "scale", "end barrier", "restart",
          "inner: preconditioner", "inner: field matvec", "inner: dots", "inner: vector updates"]
_P = ctypes.c_void_p


def build() -> ctypes.CDLL:
    out = _cuda.BUILD_DIR / "profile"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libperphil_profile.so"
    sources = sorted(s for s in (_cuda.CSRC / "profile").glob("*.cu") if s.name != "fused_ngs_cluster.cu")
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


def profile_gmres(dll, element: str, n: int, pc: str = "none") -> None:
    import chip_smoke

    W, params, bcs, _, _ = chip_smoke.problem(element, n, torch.device("cuda", torch.cuda.current_device()))
    op = DPPOperator(W, params)
    b = chip_smoke.newton_rhs(op, bcs)
    kw = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    solver = FusedGMRESSolver(op, pc, **kw)
    result = torch.zeros(RESULT_SLOTS + len(PHASES), dtype=torch.float64, device=b.device)
    (args, _keep), x = solver.launch_args(b, None, result)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = dll.perphil_fused_gmres_profile(*args, stream)
        if err:
            raise RuntimeError(f"perphil_fused_gmres_profile: CUDA error {err}")

    ms = median_ms(run, 3)
    got = solver.read_result(x, result)
    cycles = result.tolist()[RESULT_SLOTS:]
    its, total = got.iterations, sum(cycles)
    print(f"fused GMRES pc {pc} {element} N={n}: {its} iterations, geometry {solver.last_geometry}, "
          f"{ms:.4f} ms, {ms * 1e3 / its:.3f} us/iteration, {total / its:.0f} cycles/iteration on block 0")
    for name, c in zip(PHASES, cycles):
        if c:
            print(f"    {name:>22}: {100 * c / total:5.1f}%  {c / its:11.0f} cycles/iteration  "
                  f"{ms * 1e3 / its * c / total:9.3f} us/iteration")
    if pc.startswith("fieldsplit"):
        inner, solves = solver.launch_inner  # the kernel's own inner PCG counts
        applications = inner + solves
        pc_cycles = cycles[PHASES.index("inner: preconditioner")]
        print(f"    inner PCG {inner} iterations in {solves} solves; {total / max(inner, 1):.0f} cycles/inner "
              f"iteration, {pc_cycles / applications:.0f} preconditioner cycles/application")
        if pc == "fieldsplit_ilu":
            nlev = solver.field_ilu[0].num_levels
            print(f"    {pc_cycles / (2 * nlev * applications):.0f} cycles/sweep level ({nlev} levels a sweep)")
        else:
            passes = 2 * len(solver.node_shape)
            print(f"    {pc_cycles / (passes * applications):.0f} cycles/transform pass "
                  f"({passes} passes an application)")


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
    out = _cuda.BUILD_DIR / "ngs_phases"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libngs_phases.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DPERPHIL_NGS_PROFILE", "-shared", "-I", str(_cuda.CSRC),
                    "-o", str(lib), str(_cuda.CSRC / "fused_ngs.cu")], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.perphil_fused_ngs.argtypes = _cuda._SIGNATURES["perphil_fused_ngs"]
    dll.perphil_fused_ngs_profile_take.argtypes = [_P]
    return dll


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
    source = (_cuda.CSRC / "fused_ngs.cu").read_text()
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


def time_band() -> None:
    """``--only band``: ``band_trisolve`` alone, per factor, at the
    published tet sizes; the band plans up to nx=64."""
    import chip_smoke
    from perphil_tpu_torch.ops import bandsolve as bs

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cpu").manual_seed(0)
    for nx in (4, 8, 16, 24, 32, 40, 64):
        mesh, _, Fc, bw = chip_smoke.parity_factor(nx)
        nv = mesh.num_vertices
        plan = bs.band_plan(nv, bw)
        print(f"tet nx={nx}: {nv} vertices a field, {plan}")
        if nx == 64:  # the plan only
            continue
        L11, _, L22, U11, _, U22 = bs.split_monolithic_factor(Fc, nv)
        for name, M, lower in (("L11", L11, True), ("L22", L22, True), ("U11", U11, False), ("U22", U22, False)):
            P = bs.build_blocks(M, plan.B, lower, dev)
            r = torch.randn(P.shape[0] * plan.B, generator=gen, dtype=torch.float64).to(dev)
            ms, nbytes, (bound_ms, bound_by) = chip_smoke.band_factor_time(P, r, lower, nv, bw)
            print(f"  band_trisolve {name}: {ms:.4f} ms (bound {bound_ms:.4f} ms, {bound_by}; "
                  f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s of the needed bytes)")
            del P


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["gmres", "fieldsplit", "ilu", "sweeps", "k1", "direct", "direct-phases",
                                       "direct-wrapper", "ngs", "ngs-phases", "ngs-variants", "band", "partri"],
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
    dll = build()
    if args.only in (None, "gmres"):
        for element, n in (("quad", 8), ("quad", 16), ("quad", 64), ("tet", 16)):
            profile_gmres(dll, element, n)
    if args.only in (None, "fieldsplit"):
        for element, n, pc in (("quad", 64, "fieldsplit_lu"), ("tet", 8, "fieldsplit_lu"),
                               ("quad", 16, "fieldsplit_ilu"), ("quad", 64, "fieldsplit_ilu")):
            profile_gmres(dll, element, n, pc)
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
