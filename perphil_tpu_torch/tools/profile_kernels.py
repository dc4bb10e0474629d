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
    sources = sorted((_cuda.CSRC / "profile").glob("*.cu"))
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["gmres", "fieldsplit", "ilu", "sweeps", "k1"],
                    help="profile one kind of kernel alone, or time the sweeps or K1")
    ap.add_argument("--against", type=Path, help="with --only k1: an older checkout's K1 to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.only == "sweeps":
        time_sweeps()
        return 0
    if args.only == "k1":
        time_k1(args.against)
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
