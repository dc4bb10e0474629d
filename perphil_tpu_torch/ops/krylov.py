"""Krylov solvers: restarted GMRES and preconditioned conjugate gradients.

Counterpart of ``perphil_tpu/ops/krylov.py`` (``gmres``, ``gmres_ef64``,
``cg``). The loops run on the host and read back once per iteration; the
operator, the preconditioner and every vector operation run on the
tensors' device.

GMRES keeps PETSc's semantics so that iteration counts reproduce: restart
30, classical Gram-Schmidt, left preconditioning with the preconditioned
residual norm, ``rnorm <= max(rtol * rnorm0, atol)`` and divergence at
``rnorm > dtol * rnorm0``. Its rounding is part of the specification: every
dot product, norm and basis combination is a pairwise halving tree
(:func:`tree_sum`), the Givens chain and the back-substitution are
sequential scalar f64, and no multiply is fused into an add. The fused
kernel (``ops/fused_gmres.py``, ``csrc/fused_gmres.cu``) reproduces this
arithmetic bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

Op = Callable[[torch.Tensor], torch.Tensor]

#: PETSc's ``KSPConvergedDefault`` divergence tolerance (divtol) default.
DEFAULT_DTOL = 1.0e4


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool


def tree_sum(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along ``dim`` as a pairwise halving tree: zero-pad to a power of
    two ``L``, then ``p[:L/2] + p[L/2:]`` until one entry is left
    (``perphil_tpu/ops/krylov.py:625-646``). Padding further with zeros
    leaves the result unchanged (but for the sign of a total of ``-0.0``),
    which lets the kernel pad to its thread count."""
    size = p.shape[dim]
    width = 1 << max(0, (size - 1).bit_length())
    if width != size:
        pad = list(p.shape)
        pad[dim] = width - size
        p = torch.cat([p, p.new_zeros(pad)], dim=dim)
    while width > 1:
        width //= 2
        p = p.narrow(dim, 0, width) + p.narrow(dim, width, width)
    return p.select(dim, 0)


def _halve(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The halving tree along ``dim`` (a power of two long), which it drops."""
    width = t.shape[dim]
    while width > 1:
        width //= 2
        t = t.narrow(dim, 0, width) + t.narrow(dim, width, width)
    return t.select(dim, 0)


#: threads of one block of the fused GMRES kernel
CLUSTER_THREADS = 512


def tree_sum_cluster(p: torch.Tensor, blocks: int) -> torch.Tensor:
    """:func:`tree_sum` of a 1-D tensor, taken as the fused GMRES kernel
    takes it on ``blocks`` thread blocks of 512 threads
    (``csrc/fused_gmres.cuh``, "Ownership" and "Reductions"); the result
    equals :func:`tree_sum` bit for bit.

    With ``Lt`` the power of two that is at least 512 and the length, value
    ``e`` belongs to thread ``tau = e mod (512 * blocks)``, ``tau = (h *
    blocks + b) * 4 + lo``: block ``b``, thread ``(h, lo)``. The tree then
    runs over the thread's own leaves ``s = e // (512 * blocks)``, over the top three bits of ``h`` (shuffles inside a warp),
    over its other bits (the warps, through shared memory), over the blocks
    (through device memory) and over ``lo``. A padding leaf is ``+0.0``
    without a load, but its addition is made: ``x + 0.0`` changes no bit of
    ``x`` except ``-0.0``, which becomes ``+0.0`` here as in
    :func:`tree_sum`. The one difference: a length that is a power of two
    below 512 is padded here and not there, so a total of exactly
    ``-0.0`` comes out as ``+0.0``."""
    if p.dim() != 1:
        raise ValueError("tree_sum_cluster takes a 1-D tensor")
    if blocks < 1 or blocks & (blocks - 1):
        raise ValueError("blocks must be a power of two")
    threads, size = CLUSTER_THREADS, p.shape[0]
    padded = max(threads, 1 << max(0, (size - 1).bit_length()))
    if threads * blocks > padded:
        raise ValueError(f"{blocks} blocks of {threads} threads for {size} values: more threads than leaves")
    leaves = padded // (threads * blocks)
    if padded != size:
        p = torch.cat([p, p.new_zeros(padded - size)])
    t = p.reshape(leaves, 8, threads // 32, blocks, 4)  # s, h's lane bits, warp, b, lo
    for _ in range(5):
        t = _halve(t, 0)
    return t


def _norm(v: torch.Tensor) -> torch.Tensor:
    v = v.reshape(-1)
    return torch.sqrt(tree_sum(v * v))


def _givens(col: List[float], cs: List[float], sn: List[float], j: int) -> Tuple[float, float]:
    """Apply the stored rotations 0..j-1 to Hessenberg column ``col``
    (entries 0..j+1), then the new rotation j that zeroes ``col[j+1]``;
    stores rotation j in ``cs``/``sn`` and returns it as ``(c, s)``."""
    for i in range(j):
        hi, hi1 = col[i], col[i + 1]
        col[i] = cs[i] * hi + sn[i] * hi1
        col[i + 1] = -sn[i] * hi + cs[i] * hi1
    a, b = col[j], col[j + 1]
    denom = math.sqrt(a * a + b * b)
    c, s = (a / denom, b / denom) if denom > 0.0 else (1.0, 0.0)
    cs[j], sn[j] = c, s
    col[j] = c * a + s * b
    return c, s


def _back_substitute(R: List[List[float]], g: List[float], j: int) -> List[float]:
    """Solve the upper-triangular ``R[:j, :j] y = g[:j]`` (R by columns),
    rows from the bottom, each sum left to right."""
    y = [0.0] * j
    for i in range(j - 1, -1, -1):
        s = g[i]
        for k in range(i + 1, j):
            s = s - R[k][i] * y[k]
        y[i] = s / R[i][i]
    return y


def gmres(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    M_inv: Optional[Op] = None,
    dtol: float = DEFAULT_DTOL,
) -> KrylovResult:
    """Left-preconditioned restarted GMRES, PETSc-compatible.

    :param A: matrix-free operator on tensors of ``b``'s shape.
    :param M_inv: left preconditioner application (None = identity).
    Stops on convergence, ``max_it``, divergence, a non-finite residual
    estimate, or a restart cycle that made no step. Returns
    ``KrylovResult(x, iterations, residual_norm, converged)``.
    """
    P = M_inv or (lambda v: v)
    shape, m = b.shape, int(restart)
    x = torch.zeros_like(b) if x0 is None else x0
    rnorm = float(_norm(P(b - A(x))))
    tol = max(rtol * rnorm, atol)
    div = dtol * rnorm
    its = 0
    done = rnorm <= tol
    while not done:
        r = P(b - A(x)).reshape(-1)
        beta_t = _norm(r)
        beta = float(beta_t)
        V = r.new_zeros((m + 1, r.numel()))
        V[0] = r / beta_t if beta > 0.0 else r
        R = [[0.0] * m for _ in range(m)]  # R[k] is column k
        g = [beta] + [0.0] * m
        cs, sn = [0.0] * m, [0.0] * m
        j, rnorm = 0, beta
        while j < m and its < max_it and rnorm > max(tol, 0.0) and rnorm <= div:
            w = P(A(V[j].view(shape))).reshape(-1)
            h = tree_sum(V[: j + 1] * w, dim=1)
            w = w - tree_sum(h[:, None] * V[: j + 1], dim=0)
            hj1_t = _norm(w)
            col = torch.cat([h, hj1_t[None]]).tolist()  # the one read-back
            V[j + 1] = w / hj1_t if col[j + 1] > 0.0 else w
            c, s = _givens(col, cs, sn, j)
            R[j][: j + 1] = col[: j + 1]
            gj = g[j]
            g[j], g[j + 1] = c * gj, -s * gj
            rnorm = abs(g[j + 1])
            j += 1
            its += 1
        if j > 0:
            y = torch.tensor(_back_substitute(R, g, j), dtype=b.dtype, device=b.device)
            x = x + tree_sum(y[:, None] * V[:j], dim=0).view(shape)
        done = (
            rnorm <= tol or its >= max_it or rnorm > div or not math.isfinite(rnorm) or j == 0
        )
    return KrylovResult(x, its, rnorm, rnorm <= tol)


def gmres_ef64(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-5,
    atol: float = 1.0e-50,
    max_it: int = 10000,
    restart: int = 30,
    dtol: float = DEFAULT_DTOL,
) -> KrylovResult:
    """Unpreconditioned :func:`gmres`: counterpart of
    ``perphil_tpu/ops/krylov.py::gmres_ef64``, the twin of the f64-faithful
    TPU kernel. The JAX package needs it apart because the TPU has no f64
    and emulates it; in native f64, with the halving-tree reductions, it and
    :func:`gmres` are one algorithm."""
    return gmres(A, b, x0, rtol, atol, max_it, restart, None, dtol)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(u.reshape(-1), v.reshape(-1))


def cg(
    A: Op,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    rtol: float = 1.0e-8,
    atol: float = 1.0e-12,
    max_it: int = 10000,
    M_inv: Optional[Op] = None,
) -> Tuple[torch.Tensor, int, float]:
    """Preconditioned conjugate gradients for SPD operators.

    Converges on the unpreconditioned residual 2-norm,
    ``||r|| <= max(rtol ||r0||, atol)``; also stops on a non-finite residual.
    Shape-agnostic (grid or flat tensors). Returns (x, iterations,
    residual_norm).
    """
    P = M_inv or (lambda v: v)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - A(x)
    z = P(r)
    p = z
    rz = _dot(r, z)
    rnorm = math.sqrt(float(_dot(r, r)))
    tol = max(rtol * rnorm, atol)
    its = 0
    while rnorm > tol and its < max_it:
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = P(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm = math.sqrt(float(_dot(r, r)))
        its += 1
        if not math.isfinite(rnorm):
            break
    return x, its, rnorm
