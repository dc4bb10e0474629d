"""Build, load and launch the package's CUDA kernels.

The sources under ``perphil_tpu_torch/csrc/`` (``*.cu``, ``*.cuh``) are
compiled at first use with ``nvcc`` (one process per ``.cu``, all started
together, then one link) into one shared library with a plain C
interface, loaded with ``ctypes``. The library's name carries a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
build. Nothing here runs at import; a machine without ``nvcc`` fails only
when a kernel is launched.

Every ``extern "C"`` launcher returns ``cudaGetLastError()`` after its
launch; :func:`check` raises on a non-zero code. ``KERNEL_LAUNCHES`` counts
launches per kernel name: each wrapper adds one where it launches, and
nowhere else; launches captured in a CUDA graph (:class:`CapturedLaunches`)
count at each replay, not at the capture.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "perphil_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: Launches per kernel name since the last ``clear()``.
KERNEL_LAUNCHES: Dict[str, int] = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_F = ctypes.c_float

# argtypes of every launcher (pointers and the stream as c_void_p, so no
# pointer is cut to 32 bits)
_SIGNATURES = {
    # z1, z2, y1, y2, weights(host, 81 doubles), nz, ny, nx, dim, mode, stream
    "perphil_dpp_apply_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "perphil_dpp_apply_f64": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # regions(host, 7 x 5 int64: the two fields' addresses, off, sz, sy), y1, y2,
    # weights(host, 81 doubles), dim, mode, plan(host, 25 ints: ops/fused_apply.py::HaloPlan), stream
    "perphil_dpp_apply_halo_f32": [_P, _P, _P, _P, _I, _I, _P, _P],
    "perphil_dpp_apply_halo_f64": [_P, _P, _P, _P, _I, _I, _P, _P],
    # dim, f64 (returns the halo form's blocks the device holds at once, < 0: an error)
    "perphil_dpp_apply_halo_wave": [_I, _I],
    # b, x, Sx, Sy, Sz, a11, a22, idet, a12, weights, nz, ny, nx, dim,
    # refinements, placement(host, 4 ints), stream
    "perphil_fused_direct": [_P] * 8 + [_F, _P] + [_I] * 5 + [_P, _P],
    # b, x, its, Sx, Sy, Sz, isc, dense, weights, nz, ny, nx, dim, rtol,
    # max_it, placement(host, 4 ints), stream
    "perphil_fused_pcg": [_P] * 9 + [_I] * 4 + [_D, _I, _P, _P],
    # dim (returns the kernels' largest static shared memory in bytes, < 0: none)
    "perphil_fused_direct_static_smem": [_I],
    "perphil_fused_pcg_static_smem": [_I],
    # b, x0, x, V, work, xchg, result, weights, mass, dinv, F0L, F0U, F1L, F1U,
    # L0L, L0U, L1L, L1U, level_ptr, level_rows, ilu_meta, Sx, Sy, Sz, sc, nz, ny, nx,
    # dim, pc, noffs, nlev, rtol, atol, dtol, max_it, restart, coef, in_rtol, in_atol,
    # in_max, in_restart, in_dtol, max_level_rows, stream
    "perphil_fused_gmres": [_P] * 25 + [_I] * 7 + [_D, _D, _D, _I, _I, _D, _D, _D, _I, _I, _D, _I, _P],
    # pc, dim (returns the kernel's static shared memory in bytes, < 0: none)
    "perphil_fused_gmres_static_smem": [_I, _I],
    # r, z, y, packed_lower, packed_upper, level_ptr, level_rows, meta, noffs,
    # nrows, nlev, max_level_rows, geometry(host, 4 ints), stream
    "perphil_structured_ilu_apply": [_P] * 8 + [_I, _I, _I, _I, _P, _P],
    # x, b, z, packed, level_ptr, level_rows, meta, noffs, nrows, nlev,
    # max_level_rows, geometry(host, 4 ints), stream
    "perphil_gs_sweep": [_P] * 7 + [_I] * 4 + [_P, _P],
    # b, x0, x, lists, cptr, sends, result, weights(host, 38 doubles), ny,
    # nx, ncolors, rtol, atol, max_it, blocks, rows, nloc, width, stream
    "perphil_fused_ngs": [_P] * 8 + [_I] * 3 + [_D, _D] + [_I] * 5 + [_P],
    # b, x0, x, lists, cptr, sends, result, tap_w, tap_d, tap_nc (host), dim,
    # nz, ny, nx, rtol, atol, max_it, blocks, rows, nloc, width, nlev,
    # sweep_warps, stream
    "perphil_fused_gs": [_P] * 10 + [_I] * 4 + [_D, _D] + [_I] * 7 + [_P],
    # parts, words(host: the table's copy), nparts, rows, start, edge, end,
    # weights(host, 38 doubles), ny, nx, state, stream
    "perphil_ngs_colour_step": [_P, _P, _I, _P] + [_I] * 3 + [_P, _I, _I, _P, _P],
    # parts, words(host), nparts, ctas, weights(host), ny, nx, state, work
    # (the squares and partials), arrivals, init, local, stream
    "perphil_ngs_norm": [_P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P],
    # state, init, stream
    "perphil_ngs_finish": [_P, _I, _P],
    # r, z, vec, blob, desc, perm, n, nlev_l, nlev_u, blocks, shared_vector,
    # stages, stage_bytes, stream
    "perphil_band_trisolve": [_P] * 6 + [_I] * 7 + [_P],
    # stream (an empty kernel: the floor of a launch through this interface)
    "perphil_empty_launch": [_P],
}

_LIB = None
_BUILD_ERROR: Optional[RuntimeError] = None  # a failed build is not retried
BUILD_INFO: Dict[str, object] = {}


def header_constant(header: str, name: str) -> int:
    """The integer of ``constexpr int <name> = <value>;`` in
    ``csrc/<header>``: a number the host's plans share with the kernels."""
    found = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", (CSRC / header).read_text())
    if found is None:
        raise RuntimeError(f"no constexpr int {name} in {header}")
    return int(found.group(1))


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(flags) -> str:
    """A hash of the flags and every source, for a library's name."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library path."""
    lib = BUILD_DIR / f"libperphil_kernels_{_digest(NVCC_FLAGS)}.so"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        # one nvcc per source, all at once, then one link
        objs, procs = [], []
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = str(Path(tmpdir) / f"{src.stem}.o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        # each unit's output read on a thread of its own, so that each
        # unit's end is seen when it comes
        units: Dict[str, float] = {}

        def wait(name, proc):
            out = proc.communicate()[0]
            units[name] = time.perf_counter() - t0
            return out

        with ThreadPoolExecutor(len(procs)) as pool:
            logs = list(pool.map(lambda item: wait(*item), procs))
        failed = [p.returncode for _, p in procs if p.returncode != 0]
        tmp = str(Path(tmpdir) / lib.name)
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs], capture_output=True, text=True
            )
            logs.append(link.stdout + link.stderr)
            failed = [link.returncode] if link.returncode != 0 else []
        log = "\n".join(logs)
        lib.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, lib)
    seconds = time.perf_counter() - t0
    BUILD_INFO.update(path=str(lib), seconds=seconds, cached=False, log=log, units=units)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB, _BUILD_ERROR
    if _BUILD_ERROR is not None:
        raise _BUILD_ERROR
    if _LIB is None:
        try:
            path = build()
        except RuntimeError as err:
            _BUILD_ERROR = err
            raise
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.perphil_error_string.argtypes = [ctypes.c_int]
        lib.perphil_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def variant_library(source: str, define: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """``csrc/<source>`` built alone with ``-D<define>`` (a measurement
    build: what a kernel compiles in under that macro, such as phase clocks
    or a probe's entry point), into the build directory under a hash of the
    sources, the flags and the macro, loaded with ``signatures`` (launcher
    name: argtypes) bound. Its launches are counted nowhere."""
    flags = [*NVCC_FLAGS, f"-D{define}"]
    # the package's sources and this one (a probe under csrc/profile/ is not among them)
    key = _digest(flags + [hashlib.sha256((CSRC / source).read_bytes()).hexdigest()])
    lib = BUILD_DIR / "variants" / f"lib{Path(source).stem}_{define.lower()}_{key}.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run([_nvcc(), *flags, "-shared", "-I", str(CSRC), "-o", str(tmp), str(CSRC / source)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc failed ({run.returncode}) on {source} with -D{define}:\n{run.stdout}{run.stderr}")
        os.replace(tmp, lib)
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in signatures.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def check(err: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = library().perphil_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Call launcher ``symbol`` on ``device``'s current stream, check its
    error code and count one launch of ``kernel``."""
    fn = getattr(library(), symbol)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, symbol)
    KERNEL_LAUNCHES[kernel] += 1


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device):
    """Validate one kernel argument: a CUDA tensor on ``device``, its dtype
    and contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernels take CUDA tensors")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class CapturedLaunches:
    """The launches ``issue()`` makes through :func:`launch` on ``device``,
    captured once in a CUDA graph (``torch.cuda.CUDAGraph``) and replayed
    by :meth:`replay`. The capture launches nothing, so it counts nothing;
    each replay counts the launches it makes."""

    def __init__(self, device: torch.device, issue) -> None:
        library()  # built and loaded before the capture
        before = collections.Counter(KERNEL_LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(self.graph):
            issue()
        self.launches = KERNEL_LAUNCHES - before
        KERNEL_LAUNCHES.clear()
        KERNEL_LAUNCHES.update(before)

    def replay(self) -> None:
        self.graph.replay()
        KERNEL_LAUNCHES.update(self.launches)
