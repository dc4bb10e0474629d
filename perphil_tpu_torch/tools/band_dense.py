"""The first port's dense-band ILU apply, kept for measurements
(``tools/profile_kernels.py --only band`` times it in turns with the
package's level-scheduled ``band_trisolve`` on the same factor).

The ordering-parity ILU's factor blocks L11, L22, U11, U22 are banded under
the cell-RCM numbering; each is covered by ``nb = ceil(nv / B)`` dense
``B x B`` diagonal blocks, ``B`` the smallest multiple of 32 above the
bandwidth, so a row couples at most one block back (lower) or ahead
(upper). The trisolve is the block recurrence ``u = r_k - C_k y_{k-1}``,
``y_k = u + X_k u`` (lower, unit diagonal; the upper factor ``y_k = X_k u``
with ``y_{k+1}``), ``X_k`` the inverse of the diagonal block, ``C_k`` the
coupling; one packed ``(nb, B, B)`` f64 array holds both. The inter-field
couplings L21 and U12 apply as varying-coefficient 3^d stencils in the
natural order between two permutation gathers. This is the JAX package's
design (``perphil_tpu/ops/bandsolve.py``, a ``lax.scan`` of dense matvecs
for the TPU's matrix unit) in f64.

The recurrence runs in ``csrc/profile/band_trisolve_dense.cu`` (:func:`tri_apply`,
one cooperative launch a factor, four an apply), built alone by
:func:`library`; :func:`tri_apply_plain` is its twin and the CPU path. It
is no part of the package's solvers.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import NamedTuple, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from perphil_tpu_torch.config import DeviceLike, resolve_device
from perphil_tpu_torch.ops import _cuda

SOURCE = _cuda.CSRC / "profile" / "band_trisolve_dense.cu"
#: the block size's quantum: a warp's width (the kernel's rows come in whole warps)
BLOCK_QUANTUM = 32


def band_block_size(bandwidth: int) -> int:
    """The smallest multiple of 32 that is at least ``bandwidth + 1`` (so a
    row's couplings reach at most the neighbouring block)."""
    return max(BLOCK_QUANTUM, -(-(int(bandwidth) + 1) // BLOCK_QUANTUM) * BLOCK_QUANTUM)


class DenseBandPlan(NamedTuple):
    """What the band engine holds on the card for ``nv`` vertices a field:
    block size ``B``, ``nb`` blocks a factor, ``packed_bytes`` for the four
    packed factors, and ``workspace_bytes``, the rest at the build's peak
    (the two coupling stencils, the permutations, one factor's scatter
    lists, and one diagonal block's dense copy, identity, inverse and the
    solve's own copy)."""

    bandwidth: int
    B: int
    nb: int
    packed_bytes: int
    workspace_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.packed_bytes + self.workspace_bytes


def dense_band_plan(nv: int, bandwidth: int, dim: int = 3) -> DenseBandPlan:
    """The band engine's device memory for ``nv`` vertices a field and the
    factor's ``bandwidth`` (:func:`factor_bandwidth`)."""
    B = band_block_size(bandwidth)
    nb = -(-int(nv) // B)
    taps = 3**dim
    workspace = (
        2 * taps * nv * 8  # the L21 / U12 stencils
        + 2 * nv * 8  # the permutation and its inverse
        + 2 * taps * nv * 16  # a factor's scatter lists (index, value), at most 3^d a row
        + 4 * B * B * 8  # a diagonal block, the identity, its inverse, the solve's copy
        + B * B  # the inverse's mask
    )
    return DenseBandPlan(int(bandwidth), B, nb, 4 * nb * B * B * 8, workspace)


def split_monolithic_factor(Fc: sp.csr_matrix, nv: int) -> Tuple[sp.csr_matrix, ...]:
    """The combined ILU(0) factor's six two-field blocks: L11, L21, L22
    strictly lower (unit diagonal implied), U11, U12, U22 upper with the
    diagonal. Index arrays are copied (``eliminate_zeros`` works in place)."""
    n = Fc.shape[0]
    rows = np.repeat(np.arange(n), np.diff(Fc.indptr))

    def part(mask):
        M = sp.csr_matrix((Fc.data * mask, Fc.indices.copy(), Fc.indptr.copy()), shape=Fc.shape)
        M.eliminate_zeros()
        return M

    L = part(Fc.indices < rows)
    U = part(Fc.indices >= rows)
    return L[:nv, :nv], L[nv:, :nv], L[nv:, nv:], U[:nv, :nv], U[:nv, nv:], U[nv:, nv:]


def _parts_bandwidth(parts: Tuple[sp.csr_matrix, ...]) -> int:
    L11, _, L22, U11, _, U22 = parts
    bw = 0
    for M, sign in ((L11, 1), (L22, 1), (U11, -1), (U22, -1)):
        coo = M.tocoo()
        if coo.nnz:
            bw = max(bw, int((sign * (coo.row.astype(np.int64) - coo.col)).max()))
    return bw


def factor_bandwidth(Fc: sp.csr_matrix, nv: int) -> int:
    """The largest distance from the diagonal in the four per-field blocks
    of the combined factor."""
    return _parts_bandwidth(split_monolithic_factor(Fc, nv))


def _block_coo(M: sp.spmatrix, B: int, lower: bool):
    """Flat scatter positions into ``(nb, B, B)`` of a banded triangular
    factor: ``(diag_idx, diag_vals, coup_idx, coup_vals, nb)``, f64 values.
    ``lower``: couplings reach block k-1 (the forward recurrence); else block
    k+1. Entries come in row order, so the diagonal entries of block k are
    one contiguous run."""
    n = M.shape[0]
    nb = -(-n // B)
    coo = M.tocoo()
    r, c, v = coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data.astype(np.float64)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    k = r // B
    lr = r - k * B
    in_diag = c // B == k
    d_idx = (k[in_diag] * B + lr[in_diag]) * B + (c[in_diag] - k[in_diag] * B)
    off = ~in_diag
    kc = c[off] // B
    if not np.array_equal(kc, k[off] - 1 if lower else k[off] + 1):
        raise ValueError("bandwidth exceeds the block size: a coupling reaches beyond the adjacent block")
    c_idx = (k[off] * B + lr[off]) * B + (c[off] - kc * B)
    return d_idx, v[in_diag], c_idx, v[off], nb


def _masks(B: int, pad: int, lower: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xmask, cmask)``: where a packed block holds the inverse's entries
    and where the coupling's. Lower: the strict lower triangle (the unit
    diagonal is implied) and columns ``>= row + pad``; upper: the upper
    triangle with the diagonal and columns ``<= row - pad``."""
    i = torch.arange(B, device=device)[:, None]
    j = torch.arange(B, device=device)[None, :]
    if lower:
        return j < i, j >= i + pad
    return j >= i, j <= i - pad


def build_blocks(M: sp.spmatrix, B: int, lower: bool, device: DeviceLike = None) -> torch.Tensor:
    """Pack one banded triangular factor into ``(nb, B, B)`` f64 on
    ``device``: each diagonal block's inverse (its strict lower triangle for
    the unit-lower factors, its upper triangle with the diagonal for the
    upper ones) and the coupling entries in the complementary positions.
    The blocks are inverted one at a time, so the workspace is a few
    ``B x B`` matrices (:func:`dense_band_plan`). Padded tail rows are identity
    rows."""
    dev = resolve_device(device)
    d_idx, d_vals, c_idx, c_vals, nb = _block_coo(M, B, lower)
    P = torch.zeros((nb, B, B), dtype=torch.float64, device=dev)
    xmask, _ = _masks(B, 1, lower, dev)
    eye = torch.eye(B, dtype=torch.float64, device=dev)
    bounds = np.searchsorted(d_idx // (B * B), np.arange(nb + 1))
    d_idx_t = torch.from_numpy(d_idx).to(dev)
    d_vals_t = torch.from_numpy(d_vals).to(dev)
    for k in range(nb):
        s, e = int(bounds[k]), int(bounds[k + 1])
        D = torch.zeros(B * B, dtype=torch.float64, device=dev)
        D[d_idx_t[s:e] - k * B * B] = d_vals_t[s:e]
        D = D.view(B, B)
        diag = D.diagonal()
        if lower:
            diag.fill_(1.0)  # strictly lower storage: the unit diagonal
        else:
            diag.masked_fill_(diag == 0.0, 1.0)  # padded tail rows
        X = torch.linalg.solve_triangular(D, eye, upper=not lower)
        P[k] = X.masked_fill_(~xmask, 0.0)
        del D, X
    P.view(-1)[torch.from_numpy(c_idx).to(dev)] = torch.from_numpy(c_vals).to(dev)
    return P


def _check_blocks(P: torch.Tensor, r: torch.Tensor, pad: int) -> Tuple[int, int]:
    if P.dim() != 3 or P.shape[1] != P.shape[2]:
        raise ValueError(f"P has shape {tuple(P.shape)}, expected (nb, B, B)")
    nb, B, _ = P.shape
    if tuple(r.shape) != (nb * B,):
        raise ValueError(f"r has shape {tuple(r.shape)}, expected ({nb * B},)")
    if not 1 <= pad <= B:
        raise ValueError(f"pad {pad} outside [1, {B}]")
    return nb, B


def tri_apply_plain(P: torch.Tensor, r: torch.Tensor, lower: bool, pad: int) -> torch.Tensor:
    """The banded triangular solve as the block recurrence, one block at a
    time with two matvecs (plain PyTorch twin of the kernel; any device).
    ``P``: ``(nb, B, B)`` packed ``[inverse | coupling]`` blocks
    (:func:`build_blocks`); ``r``: the ``(nb * B,)`` padded right-hand side;
    ``pad``: ``B`` minus the bandwidth."""
    nb, B = _check_blocks(P, r, pad)
    xmask, cmask = _masks(B, pad, lower, P.device)
    rk = r.view(nb, B)
    y = torch.empty_like(rk)
    carry = None
    for k in range(nb) if lower else range(nb - 1, -1, -1):
        u = rk[k] if carry is None else rk[k] - torch.where(cmask, P[k], 0.0) @ carry
        xu = torch.where(xmask, P[k], 0.0) @ u
        carry = u + xu if lower else xu
        y[k] = carry
    return y.view(-1)


def tri_apply(P: torch.Tensor, r: torch.Tensor, lower: bool, pad: int) -> torch.Tensor:
    """:func:`tri_apply_plain`'s function: on CUDA tensors one cooperative
    launch of ``csrc/profile/band_trisolve_dense.cu``, on CPU tensors the
    twin."""
    nb, B = _check_blocks(P, r, pad)
    if P.device.type == "cpu" and r.device.type == "cpu":
        return tri_apply_plain(P, r, lower, pad)
    dev = P.device
    _cuda.require_cuda_tensor(P, "P", torch.float64, dev)
    _cuda.require_cuda_tensor(r, "r", torch.float64, dev)
    y = torch.empty_like(r)
    u = torch.empty(B, dtype=torch.float64, device=dev)
    barrier = torch.zeros(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = library().perphil_band_trisolve_dense(
            P.data_ptr(), r.data_ptr(), y.data_ptr(), u.data_ptr(), barrier.data_ptr(),
            nb, B, int(pad), int(bool(lower)), torch.cuda.current_stream(dev).cuda_stream,
        )
    _cuda.check(err, "perphil_band_trisolve_dense")
    return y


def tri_apply_traffic(n: int, B: int, pad: int, lower: bool) -> Tuple[int, int]:
    """``(bytes, flops)`` that one banded triangular solve of ``n`` rows
    (:func:`tri_apply`) needs: each masked block entry of a real row and
    column read once (the first step takes no coupling; the padded tail is
    left out), ``r`` read and ``y`` written once, and a multiply and an add
    for each entry read. The dense kernel's bound in
    ``tools/profile_kernels.py --only band``."""
    nb = -(-int(n) // B)
    i = np.arange(B, dtype=np.int64)
    entries = 0
    for k in range(nb):
        rows = min(B, n - k * B)
        ii = i[:rows]
        if lower:  # X_k at columns < i; C_k at columns >= i + pad of the full block k-1
            x, c, first = ii, np.maximum(0, B - ii - pad), k == 0
        else:  # X_k at columns >= i; C_k at columns <= i - pad of block k+1
            after = min(B, n - (k + 1) * B) if k + 1 < nb else 0
            x, c, first = rows - ii, np.clip(ii - pad + 1, 0, after), k == nb - 1
        entries += int(x.sum()) + (0 if first else int(c.sum()))
    return 8 * (entries + 2 * int(n)), 2 * entries


def coupling_stencil_vals(M: sp.spmatrix, vperm: np.ndarray, grid_shape: Tuple[int, ...]) -> np.ndarray:
    """A permuted-space inter-field factor block as a varying-coefficient
    3^d stencil in the natural order, f64 ``(3^d, *grid_shape)``: ``M[i,
    j]`` couples natural vertices ``vperm[i]`` and ``vperm[j]``, which the
    ILU(0) pattern (the finite-element adjacency) keeps grid-adjacent."""
    d = len(grid_shape)
    coo = M.tocoo()
    rpos = np.stack(np.unravel_index(vperm[coo.row], grid_shape), axis=1)
    cpos = np.stack(np.unravel_index(vperm[coo.col], grid_shape), axis=1)
    delta = cpos - rpos
    if coo.nnz and (delta.min() < -1 or delta.max() > 1):
        raise ValueError("factor entry is not grid-adjacent")
    oidx = np.zeros(coo.nnz, dtype=np.int64)
    for ax in range(d):
        oidx = oidx * 3 + (delta[:, ax] + 1)
    vals = np.zeros((3**d,) + tuple(grid_shape), dtype=np.float64)
    vals[(oidx,) + tuple(rpos.T)] = coo.data
    return vals


def apply_varying_stencil(u: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``y[p] = sum_o vals[o, p] * u[p + off_o]`` over the 3^d offsets, the
    slowest axis first (the zero-padded shifts of ``stencil.apply_stencil``),
    as one product with the 3^d shifted windows of the padded field (views)
    and one sum over them."""
    d = u.dim()
    windows = F.pad(u, (1, 1) * d)
    for ax, s in enumerate(u.shape):
        windows = windows.unfold(ax, s, 1)  # (3,) * d + u.shape
    return (vals.view((3,) * d + tuple(u.shape)) * windows).sum(dim=tuple(range(d)))


class DenseBandILU(nn.Module):
    """The parity ILU apply, built once a solver (PCSetUp):
    :meth:`apply` maps the stacked natural-order residual ``(2, *grid)`` to
    ``P^T U^-1 L^-1 P r``. Buffers: the four packed factors ``PL1``, ``PL2``,
    ``PU1``, ``PU2`` ``(nb, B, B)`` f64, the permutation ``vperm`` (natural
    index of each permuted vertex) and its inverse ``ivperm``, and the
    natural-order stencils ``vals21`` (L21) and ``vals12`` (U12)."""

    def __init__(self, nv: int, B: int, pad: int, grid_shape: Tuple[int, ...], vperm: np.ndarray,
                 factors: Tuple[torch.Tensor, ...], vals21: np.ndarray, vals12: np.ndarray):
        super().__init__()
        dev = factors[0].device
        self.nv, self.B, self.pad, self.grid_shape = int(nv), int(B), int(pad), tuple(grid_shape)
        self.nb = int(factors[0].shape[0])
        ivperm = np.empty_like(vperm)
        ivperm[vperm] = np.arange(nv, dtype=vperm.dtype)
        self.register_buffer("vperm", torch.from_numpy(vperm.astype(np.int64)).to(dev))
        self.register_buffer("ivperm", torch.from_numpy(ivperm.astype(np.int64)).to(dev))
        for name, P in zip(("PL1", "PL2", "PU1", "PU2"), factors):
            self.register_buffer(name, P)
        self.register_buffer("vals21", torch.from_numpy(vals21).to(dev))
        self.register_buffer("vals12", torch.from_numpy(vals12).to(dev))

    def _to_p(self, u: torch.Tensor) -> torch.Tensor:
        """Natural grid -> permuted, zero-padded to ``nb * B``."""
        out = u.new_zeros(self.nb * self.B)
        out[: self.nv] = u.reshape(-1)[self.vperm]
        return out

    def _to_n(self, yp: torch.Tensor) -> torch.Tensor:
        """Permuted padded -> natural grid."""
        return yp[: self.nv][self.ivperm].reshape(self.grid_shape)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """``z = P^T U^-1 L^-1 P r`` on stacked natural fields ``(2, *grid)``."""
        y1 = tri_apply(self.PL1, self._to_p(r[0]), True, self.pad)
        # r2' = r2 - L21 y1, in the natural order
        y2 = tri_apply(self.PL2, self._to_p(r[1] - apply_varying_stencil(self._to_n(y1), self.vals21)), True, self.pad)
        x2 = tri_apply(self.PU2, y2, False, self.pad)
        x2n = self._to_n(x2)
        # y1' = y1 - U12 x2
        x1 = tri_apply(self.PU1, y1 - self._to_p(apply_varying_stencil(x2n, self.vals12)), False, self.pad)
        return torch.stack([self._to_n(x1), x2n])

    forward = apply


def build_dense_band_ilu(
    Fc: sp.csr_matrix, perm: np.ndarray, nv: int, grid_shape: Tuple[int, ...], device: DeviceLike = None
) -> DenseBandILU:
    """The device apply of the host-factored parity system: ``Fc`` the
    combined ILU(0) factor of ``Ap = A[perm][:, perm]`` (``ordering.parity_system``,
    ``_native.native_ilu0``), ``perm`` the blocked DoF permutation (field 1's
    vertices first). The stencils first, then one factor at a time."""
    dev = resolve_device(device)
    parts = split_monolithic_factor(Fc, nv)
    L11, L21, L22, U11, U12, U22 = parts
    bw = _parts_bandwidth(parts)
    B = band_block_size(bw)
    vperm = np.asarray(perm[:nv], dtype=np.int64)
    vals21 = coupling_stencil_vals(L21, vperm, grid_shape)
    vals12 = coupling_stencil_vals(U12, vperm, grid_shape)
    factors = tuple(build_blocks(M, B, lower, dev) for M, lower in ((L11, True), (L22, True), (U11, False), (U22, False)))
    return DenseBandILU(nv, B, B - bw, grid_shape, vperm, factors, vals21, vals12)


_LIB = None


def library() -> ctypes.CDLL:
    """The dense kernel, built alone (one ``nvcc``) at first call."""
    global _LIB
    if _LIB is None:
        out = _cuda.BUILD_DIR / "band_dense"
        out.mkdir(parents=True, exist_ok=True)
        lib = out / "libband_dense.so"
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib), str(SOURCE)],
                       check=True, capture_output=True)
        dll = ctypes.CDLL(str(lib))
        # P, r, y, u, barrier, nb, B, pad, lower, stream
        dll.perphil_band_trisolve_dense.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        dll.perphil_band_trisolve_dense.restype = ctypes.c_int
        _LIB = dll
    return _LIB
