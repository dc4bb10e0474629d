"""Chained-marginal timing: the one implementation of (T(2K) - T(K)) / K.

Counterpart of ``perphil_tpu/utils/marginal.py`` over torch tensors. A
timed chain of K dependent applications pays a fixed cost once (the first
launch's latency, the final read-back and synchronise); dividing T(K) by K
folds that cost into every per-application figure, and the marginal
between a K-trip and a 2K-trip chain cancels it. Three rules, all enforced
here so callers cannot diverge:

1. **Size K from the marginal.** The pilot runs both K and 2K and
   estimates the per-trip cost from their difference, never from
   ``T(K)/K``, which the fixed cost inflates.
2. **The marginal window T(2K) - T(K) must dwarf the clock's jitter.** K
   grows until the window reaches ``window`` seconds (default 0.25 s), so
   a jitter of a millisecond moves the figure by under 1%.
3. **A jitter-scale marginal is a failed measurement, not a number.**
   Callers get a :class:`MarginalTimingError` when the window comes out
   non-positive or stays below the window at the K cap, never a clamped
   epsilon.

The clock is ``time.perf_counter`` read after ``torch.cuda.synchronize()``
(where there is a card), around a chain that ends in one scalar read back.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch


class MarginalTimingError(RuntimeError):
    """The (T(2K)-T(K)) window came out non-positive or jitter-scale: the
    measurement is invalid. Re-run; do not clamp."""


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def chained_marginal(
    make_chain: Callable[[int], Callable],
    args: Sequence,
    k0: int,
    *,
    window: float = 0.25,
    best_of: int = 3,
    k_max: int = 200_000,
) -> float:
    """Per-application seconds of the chained computation ``make_chain``.

    ``make_chain(length)`` must return a callable running ``length``
    dependent applications (each trip's input perturbed by the previous
    trip's output, :func:`keepalive_feedback`) ending in one scalar.
    ``chained_marginal`` warms each chain once, takes the best of
    ``best_of`` timed runs per length, and grows K geometrically (at most
    64x a step) until the window T(2K)-T(K) reaches ``window`` seconds.
    Returns (T(2K)-T(K))/K at the final K.
    """

    def run(chain: Callable) -> float:
        s = float(chain(*args))  # warm-up
        assert np.isfinite(s), "chain produced a non-finite keep-alive sum"
        best = float("inf")
        for _ in range(best_of):
            _synchronize()
            t0 = time.perf_counter()
            s = float(chain(*args))
            _synchronize()
            best = min(best, time.perf_counter() - t0)
            assert np.isfinite(s)
        return best

    K = max(1, int(k0))
    while True:
        t1, t2 = run(make_chain(K)), run(make_chain(2 * K))
        gap = t2 - t1
        if gap >= 0.8 * window or K >= k_max:
            break
        per = gap / K
        if per > 0:
            target = int(np.ceil(window / per))
            K = min(k_max, max(8 * K, min(target, 64 * K)))
        else:  # jitter swamped the pilot window entirely: grow blind
            K = min(k_max, 8 * K)
    if gap <= 0:
        raise MarginalTimingError(
            f"non-positive marginal at K={K}: T(K)={t1:.4f}s >= T(2K)={t2:.4f}s "
            "(jitter exceeded the window; re-run)"
        )
    if gap < 0.8 * window and K >= k_max:
        raise MarginalTimingError(
            f"marginal window unreachable: T(2K)-T(K)={gap:.4f}s < "
            f"{0.8 * window:.3f}s at the K cap ({k_max}); raise k_max or "
            "accept that the per-application cost is below measurement "
            "resolution"
        )
    return gap / K


def _flatten(tree: Any) -> Tuple[List[torch.Tensor], Callable[[List[torch.Tensor]], Any]]:
    """The tensors of a tensor / tuple / list / dict tree (dict keys
    sorted, as JAX orders them) and the function that rebuilds the tree."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_flatten(t) for t in tree]
    else:
        raise TypeError(f"not a tensor tree: {type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new: List[torch.Tensor]) -> Any:
        out, at = [], 0
        for (_, build), n in zip(parts, sizes):
            out.append(build(new[at : at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def keepalive_feedback(out: Any, carry: Any) -> Any:
    """Next-trip chain inputs as a negligible function of every output
    tensor and every carry tensor: the per-leaf sums keep every output
    used, the full-array dependence through leaf 0 keeps the output
    materialised, and perturbing every carry leaf makes each trip depend on
    the last. The sums add one reduction per output leaf, so tiny stages'
    figures are mild upper bounds."""
    lo, _ = _flatten(out)
    cl, rebuild = _flatten(carry)
    eps = 1e-30
    s = sum(leaf.sum() for leaf in lo)
    new = []
    for i, c in enumerate(cl):
        c = c + eps * s.to(c.dtype)
        if i == 0 and lo[0].shape == c.shape:
            c = c + eps * lo[0].to(c.dtype)
        new.append(c)
    return rebuild(new)


def fn_chain_maker(fn: Callable) -> Callable[[int], Callable]:
    """``make_chain`` for a function of tensors: ``length`` dependent
    applications issued back to back with :func:`keepalive_feedback`
    wiring, reduced to one scalar tensor."""

    def make(length: int) -> Callable:
        def chain(*a):
            carry = tuple(a)
            for _ in range(length):
                carry = keepalive_feedback(fn(*carry), carry)
            return _flatten(carry)[0][0].sum()

        return chain

    return make
