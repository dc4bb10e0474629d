"""The host engine's C++ kernels: ILU(0) and ILU-preconditioned GMRES on CSR.

Builds the repository's shared host source ``csrc/csr_solver.cpp`` (the
same file the JAX package loads; it is plain C++, not a TPU kernel) with
``g++`` at first use into ``build/perphil_tpu_torch/`` and loads it with
``ctypes``. The library's name carries a hash of the source and the flags,
so an edit rebuilds and an unchanged tree reuses the build; the build is
written under a temporary name and renamed, so concurrent first uses do not
collide. The flags leave out ``-march=native``: a build copied to another
host still runs there. A failed build raises and names ``g++``; there is no
numpy fallback (``ops/ordering.py``'s ``host_ilu0``, ``host_ilu_apply`` and
``host_gmres`` are the twins the tests hold these kernels to).

The semantics are the JAX package's (``perphil_tpu/ops/ordering.py``
``native_ilu0``, ``native_ilu_gmres_solver`` and ``host_gs_sweeps``): IKJ
ILU(0) on the stored pattern, left-preconditioned GMRES(restart) from
``x = 0`` with classical Gram-Schmidt and the preconditioned residual norm,
and sequential pointwise Gauss-Seidel sweeps with SNES's stopping tests. Indices go to
the kernels as int32 (PETSc's default ``PetscInt``) while the matrix has
fewer than 2**31 rows and entries, as int64 beyond.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Tuple

import numpy as np
import scipy.sparse as sp

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "csr_solver.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "perphil_tpu_torch"
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_LIB = None

_DP = ctypes.POINTER(ctypes.c_double)


def _index_types(bits: int):
    ip = ctypes.POINTER(ctypes.c_int32 if bits == 32 else ctypes.c_int64)
    return np.int32 if bits == 32 else np.int64, ip


def build() -> Path:
    """Compile ``csrc/csr_solver.cpp`` (if this hash has no library yet) and
    return the library path."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libperphil_csr_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / lib.name
        try:
            done = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
        except FileNotFoundError as err:
            raise RuntimeError("g++ not found: the host CSR kernels (csrc/csr_solver.cpp) cannot be built") from err
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed ({done.returncode}) on csrc/csr_solver.cpp:\n{done.stdout}{done.stderr}")
        os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded host library (built at first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for bits, suffix in ((64, ""), (32, "_i32")):
            _, ip = _index_types(bits)
            fn = getattr(lib, "csr_ilu0_factorize" + suffix)
            fn.argtypes = [ctypes.c_int64, ip, ip, _DP, ip]
            fn.restype = ctypes.c_int64
            fn = getattr(lib, "csr_gmres_ilu" + suffix)
            fn.argtypes = [
                ctypes.c_int64, ip, ip, _DP,  # n, A
                ip, ip, _DP, ip,  # F and its diagonal positions
                _DP, ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,  # b, rtol, atol, restart, max_it
                _DP, _DP, _DP,  # x out, rnorm out, history (may be null)
            ]
            fn.restype = ctypes.c_int64
            fn = getattr(lib, "csr_gs_sweeps" + suffix)
            fn.argtypes = [
                ctypes.c_int64, ip, ip, _DP, _DP, _DP,  # n, A, b, x (in: x0; out: the last sweep)
                ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int64,  # rtol, atol, stol, max_it
            ]
            fn.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def _sorted_csr(A: sp.spmatrix) -> sp.csr_matrix:
    A = A.tocsr().copy()
    A.sort_indices()
    return A


def _bits(A: sp.csr_matrix) -> int:
    return 32 if max(A.nnz, A.shape[0]) < 2**31 else 64


def _factor(A: sp.csr_matrix, bits: int):
    """The in-place factorisation of a copy of ``A``'s values: ``(indptr,
    indices, values, diag)`` in the index type of ``bits``."""
    itype, ip = _index_types(bits)
    n = A.shape[0]
    ai = np.ascontiguousarray(A.indptr, dtype=itype)
    aj = np.ascontiguousarray(A.indices, dtype=itype)
    fv = np.array(A.data, dtype=np.float64)
    diag = np.zeros(n, dtype=itype)
    fn = library().csr_ilu0_factorize_i32 if bits == 32 else library().csr_ilu0_factorize
    if fn(n, ai.ctypes.data_as(ip), aj.ctypes.data_as(ip), fv.ctypes.data_as(_DP), diag.ctypes.data_as(ip)) != 0:
        raise ZeroDivisionError("ILU(0): zero or missing pivot")
    return ai, aj, fv, diag


def native_ilu0(A: sp.spmatrix) -> Tuple[sp.csr_matrix, np.ndarray]:
    """:func:`ordering.host_ilu0` in C++: ``(F, diag)``, the combined factor
    and each row's diagonal position (int64)."""
    A = _sorted_csr(A)
    ai, aj, fv, diag = _factor(A, _bits(A))
    return sp.csr_matrix((fv, aj.astype(np.int64), ai.astype(np.int64)), shape=A.shape), diag.astype(np.int64)


def native_ilu_gmres_solver(
    A: sp.spmatrix, rtol: float = 1e-8, atol: float = 1e-12, restart: int = 30, max_it: int = 10000
) -> Callable[[np.ndarray], Tuple[int, np.ndarray, float]]:
    """Factor ``A`` once (PETSc's PCSetUp, outside the solve) and return
    ``solve(b) -> (its, x, rnorm)``: ILU(0)-preconditioned GMRES on
    ``A x = b`` from ``x = 0``, ``rnorm`` the final preconditioned residual
    norm."""
    A = _sorted_csr(A)
    bits = _bits(A)
    _, ip = _index_types(bits)
    ai, aj, fv, diag = _factor(A, bits)
    av = np.ascontiguousarray(A.data, dtype=np.float64)
    n = A.shape[0]
    gmres = library().csr_gmres_ilu_i32 if bits == 32 else library().csr_gmres_ilu

    def solve(b: np.ndarray) -> Tuple[int, np.ndarray, float]:
        bb = np.ascontiguousarray(b, dtype=np.float64)
        if bb.shape != (n,):
            raise ValueError(f"b has shape {bb.shape}, expected ({n},)")
        x = np.zeros(n, dtype=np.float64)
        rnorm = np.zeros(1, dtype=np.float64)
        its = gmres(
            n, ai.ctypes.data_as(ip), aj.ctypes.data_as(ip), av.ctypes.data_as(_DP),
            ai.ctypes.data_as(ip), aj.ctypes.data_as(ip), fv.ctypes.data_as(_DP), diag.ctypes.data_as(ip),
            bb.ctypes.data_as(_DP), float(rtol), float(atol), int(restart), int(max_it),
            x.ctypes.data_as(_DP), rnorm.ctypes.data_as(_DP), ctypes.cast(None, _DP),
        )
        return int(its), x, float(rnorm[0])

    return solve


def native_gs_sweeps(
    A: sp.spmatrix, b: np.ndarray, x0: np.ndarray, rtol: float, atol: float, stol: float, max_it: int
) -> int:
    """Sequential pointwise Gauss-Seidel sweeps on ``A x = b`` from ``x0``
    (``csr_gs_sweeps``): the count until ``||b - A x|| <= max(rtol ||b - A
    x0||, atol)``, ``||dx|| < stol ||x||`` or ``max_it``."""
    A = _sorted_csr(A)
    bits = _bits(A)
    itype, ip = _index_types(bits)
    n = A.shape[0]
    ai = np.ascontiguousarray(A.indptr, dtype=itype)
    aj = np.ascontiguousarray(A.indices, dtype=itype)
    av = np.ascontiguousarray(A.data, dtype=np.float64)
    bb = np.ascontiguousarray(b, dtype=np.float64)
    x = np.array(x0, dtype=np.float64)
    if bb.shape != (n,) or x.shape != (n,):
        raise ValueError(f"b and x0 have shapes {bb.shape} and {x.shape}, expected ({n},)")
    fn = library().csr_gs_sweeps_i32 if bits == 32 else library().csr_gs_sweeps
    return int(fn(
        n, ai.ctypes.data_as(ip), aj.ctypes.data_as(ip), av.ctypes.data_as(_DP), bb.ctypes.data_as(_DP),
        x.ctypes.data_as(_DP), float(rtol), float(atol), float(stol), int(max_it),
    ))
