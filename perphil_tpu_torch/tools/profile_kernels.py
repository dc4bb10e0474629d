"""Where the fused GMRES kernel and the ILU apply spend their time, on the
card: ``python -m perphil_tpu_torch.tools.profile_kernels`` from the root of
a checkout (needs an NVIDIA GPU and ``nvcc``).

It builds the two translation units of ``csrc/profile/`` on their own
(seconds, not the minute and a half of the whole library): the pc none GMRES
kernel and ``structured_ilu_apply``, each with its cycle counters compiled
in. The package's library holds neither counter.
For plain GMRES at 2D N=8/16/64 and tet nx=16 it prints the blocks taken,
the time (CUDA events, median) and the share of block 0's cycles in each
phase of a step; for ``structured_ilu_apply`` at 2D N=64/128 monolithic and
on a 129^2 field, the time, the time per level, and whether the result
equals the plain sweep bit for bit, and the cycles one consumer and one
producer thread spend in each part of a level. ``--only gmres|ilu`` profiles
one kernel alone.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator, FieldOperator
from perphil_tpu_torch.ops.fused_apply import pack_weights
from perphil_tpu_torch.ops.fused_direct import _grid_args
from perphil_tpu_torch.ops.fused_gmres import FusedGMRESSolver
from perphil_tpu_torch.ops.ilu import StructuredILU0
from perphil_tpu_torch.solvers import parameters as sp

PHASES = ["apply", "dots", "gram-schmidt+norm", "givens", "scale", "end barrier", "restart"]
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


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
    for proc in procs:
        log = proc.communicate()[0]
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print("  ptxas:", line.split("ptxas info    :")[-1].strip())
        if proc.returncode:
            raise RuntimeError(log)
    subprocess.run(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib), *[str(out / f"{s.stem}.o") for s in sources]],
        check=True,
    )
    dll = ctypes.CDLL(str(lib))
    dll.perphil_fused_gmres_profile.argtypes = [_P] * 7 + [_I] * 4 + [_D] * 3 + [_I] * 2 + [_P]
    dll.perphil_structured_ilu_apply.argtypes = [_P] * 8 + [_I] * 4 + [_P, _P]
    dll.perphil_ilu_profile_take.argtypes = [_P]
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


def profile_gmres(dll, element: str, n: int) -> None:
    import chip_smoke

    W, params, bcs, _, _ = chip_smoke.problem(element, n, torch.device("cuda", torch.cuda.current_device()))
    op = DPPOperator(W, params)
    b = chip_smoke.newton_rhs(op, bcs)
    kw = {k: sp.GMRES_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    solver = FusedGMRESSolver(op, "none", **kw)
    x0, x = torch.zeros_like(b), torch.empty_like(b)
    basis = torch.empty((solver.restart + 1) * b.numel(), dtype=torch.float64, device=b.device)
    xchg = torch.empty(4096, dtype=torch.float64, device=b.device)
    result = torch.zeros(7 + len(PHASES), dtype=torch.float64, device=b.device)
    w = pack_weights(*solver.stencils)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = dll.perphil_fused_gmres_profile(
            b.data_ptr(), x0.data_ptr(), x.data_ptr(), basis.data_ptr(), xchg.data_ptr(),
            result.data_ptr(), w.ctypes.data, *_grid_args(solver.node_shape),
            solver.rtol, solver.atol, solver.dtol, solver.max_it, solver.restart, stream,
        )
        if err:
            raise RuntimeError(f"perphil_fused_gmres_profile: CUDA error {err}")

    ms = median_ms(run, 3)
    out = result.tolist()
    its, blocks, cycles = int(out[0]), int(out[3]), out[7:]
    total = sum(cycles)
    print(f"fused GMRES pc none {element} N={n}: {its} iterations, {blocks} blocks, basis slice in shared "
          f"memory {bool(out[4])}, matvec input in shared memory {bool(out[6])}, {ms:.4f} ms, {ms * 1e3 / its:.3f} us/iteration, "
          f"{total / its:.0f} cycles/iteration on block 0")
    for name, c in zip(PHASES, cycles):
        print(f"    {name:>18}: {100 * c / total:5.1f}%  {c / its:9.0f} cycles/iteration  "
              f"{ms * 1e3 / its * c / total:7.3f} us/iteration")


def profile_ilu(dll, tag: str, pc: StructuredILU0) -> None:
    r = torch.randn(pc.nrows, dtype=torch.float64, generator=torch.Generator().manual_seed(0)).to(pc.device)
    z, y = torch.empty_like(r), torch.empty_like(r)
    geometry = np.zeros(3, np.int32)
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
          f"ring stages {geometry[0]}, z in shared memory {bool(geometry[1])}, {geometry[2]} B dynamic, "
          f"{ms:.4f} ms, {ms * 1e3 / (2 * pc.num_levels):.3f} us/level, max abs diff vs plain sweep {diff:.1e}")
    for name, c in zip(names, cycles.tolist()):
        print(f"    {name:>34}: {c / levels:8.0f} cycles/level")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["gmres", "ilu"], help="profile one of the two kernels alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dll = build()
    for element, n in (("quad", 8), ("quad", 16), ("quad", 64), ("tet", 16)):
        if args.only != "ilu":
            profile_gmres(dll, element, n)
    if args.only == "gmres":
        return 0
    import chip_smoke

    for n in (64, 128):
        W, params, _, _, _ = chip_smoke.problem("quad", n, torch.device("cuda", torch.cuda.current_device()))
        profile_ilu(dll, f"monolithic 2D N={n}", StructuredILU0.for_monolithic(W.mesh, params))
    profile_ilu(dll, "field 129^2", StructuredILU0.for_field(FieldOperator(W.sub(0), params.k1, params.beta, params.mu)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
