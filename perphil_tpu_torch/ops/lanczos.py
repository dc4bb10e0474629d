"""Lanczos extremal-eigenvalue estimation on the card.

Counterpart of ``perphil_tpu/ops/lanczos.py``, the replacement of ARPACK
(scipy ``svds``/``eigsh``) in the reference's sparse condition-number path.
Every matrix the analysis takes (the BC-eliminated monolithic DPP matrix and
its diagonal blocks) is symmetric positive definite, so its singular values
are its eigenvalues and ``kappa = lam_max(A) / lam_min(A)``.

``lam_max`` comes from Lanczos on ``A``, ``lam_min`` from Lanczos on
``A^{-1}`` where an exact inverse application is given (the shift-invert
trick of ARPACK, with the library's direct solvers). The k-step recurrence
reorthogonalises each new vector against the whole basis twice (a ``(k+1,
n)`` matrix on the device) and tests for breakdown on the device, so the
loop never waits for the host; the Rayleigh-Ritz step on ``H = V A V^T``
runs on the host with ``numpy.linalg.eigvalsh``, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from perphil_tpu_torch.config import DeviceLike, default_dtype, resolve_device


def lanczos_extreme(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    num_iters: int = 100,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[float, float]:
    """k-step Lanczos with full reorthogonalisation on a symmetric operator:
    (largest, smallest) Ritz values.

    :param matvec: the symmetric operator on flat f64 vectors of length n on
        ``device``.
    :param num_iters: the Krylov dimension k (the basis holds k + 1 vectors).
    :param seed: ``v0`` is ``numpy.random.default_rng(seed).standard_normal(n)``,
        normalised.
    """
    dev = resolve_device(device)
    k = int(min(num_iters, n))
    v0 = np.random.default_rng(seed).standard_normal(n)
    V = torch.zeros((k + 1, n), dtype=default_dtype(), device=dev)
    V[0] = torch.as_tensor(v0 / np.linalg.norm(v0), device=dev)
    AV = torch.zeros((k, n), dtype=default_dtype(), device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    scale_max = torch.zeros((), dtype=default_dtype(), device=dev)
    for j in range(k):
        w_raw = matvec(V[j])
        AV[j] = torch.where(done, 0.0, w_raw)
        # full reorthogonalisation (the unused rows are zero), twice: the
        # basis stays orthonormal across tight clusters (the BC identity rows
        # give an eigenvalue of multiplicity ~ the boundary nodes)
        w = w_raw - V.T @ (V @ w_raw)
        w = w - V.T @ (V @ w)
        beta = torch.linalg.vector_norm(w)
        scale_max = torch.maximum(scale_max, torch.linalg.vector_norm(w_raw))
        done = done | (beta <= 1e-10 * scale_max)
        V[j + 1] = torch.where(done, 0.0, w / torch.where(beta > 0, beta, 1.0))
    # Rayleigh-Ritz on the explicit projection H = V A V^T: for an
    # orthonormal basis its Ritz values lie inside [lam_min, lam_max] (the
    # three-term tridiagonal, which the reorthogonalisation invalidates,
    # could give spurious extremes)
    Vn = V[:k].cpu().numpy()
    AVn = AV.cpu().numpy()
    row_ok = np.linalg.norm(Vn, axis=1) > 0.5
    if not row_ok.any():
        return float("nan"), float("nan")
    H = Vn[row_ok] @ AVn[row_ok].T
    ritz = np.linalg.eigvalsh(0.5 * (H + H.T))
    return float(ritz[-1]), float(ritz[0])


def spd_extremal_eigenvalues(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    inv_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    num_iters: int = 100,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[float, float]:
    """Extremal eigenvalues (lam_max, lam_min) of an SPD operator: lam_max
    from Lanczos on A; lam_min from Lanczos on A^{-1} (seed + 1) when an
    inverse application is given, else the smallest Ritz value of A (slower
    to converge)."""
    lam_max, lam_min_direct = lanczos_extreme(matvec, n, num_iters, seed, device)
    if inv_apply is None:
        return lam_max, lam_min_direct
    inv_max, _ = lanczos_extreme(inv_apply, n, num_iters, seed + 1, device)
    return lam_max, 1.0 / inv_max
