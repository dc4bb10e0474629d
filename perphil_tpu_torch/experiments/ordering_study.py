"""Ordering and fill-pattern sensitivity of ILU(0)-GMRES and pointwise GS.

Counterpart of ``perphil_tpu/experiments/ordering_study.py``: the host
study (numpy/scipy and the C++ kernels of ``ops/_native.py``) behind the
ordering-parity options, with its CSV layouts:

- **3D tet GMRES + ILU**: the published counts 6/8/15/26/33 at nx=4..40
  come back exactly with the pinned cell-RCM draw
  (``ops/ordering.py::cell_rcm_parity``) and the finite-element fill
  pattern; the structured envelope pattern takes fewer iterations.
- **2D quad GMRES + ILU**: the envelope is the finite-element pattern.
- **Pointwise GS (the Picard ngs)**: PETSc's randomised-colouring secant
  GS; the pinned draw (``ops/ordering.py::ngs_parity_coloring``) lands the
  published Picard column 16/63/194/635/1673/5135, and the study records
  the near-miss colourings beside it (``ngs_coloring.csv``).

Writes ``ordering_sensitivity.csv`` (one row per dim, element, N,
algorithm, ordering and pattern) or, with ``--ngs-coloring``,
``ngs_coloring.csv``. The boundary lift is computed on ``device`` (default:
the card) and the rest on the host.

Usage: ``python -m perphil_tpu_torch.experiments.ordering_study [--fast]
[--ngs-coloring] [--out PATH] [--device cpu]``
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from perphil_tpu_torch.config import DeviceLike
from perphil_tpu_torch.experiments.iterative_bench import default_model_params
from perphil_tpu_torch.forms.spaces import create_function_spaces, mixed_space
from perphil_tpu_torch.mesh.structured import create_cube_mesh, create_mesh
from perphil_tpu_torch.ops import ordering as od
from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator, bc_values_per_field
from perphil_tpu_torch.ops.ilu import build_monolithic_system
from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions, exact_expressions_3d

ORDERINGS = ("natural", "vertex-rcm", "cell-rcm", "cell-rcm-parity", "random")

# the published counts, for the context columns
REF_ILU_3D = {4: 6, 8: 8, 16: 15, 32: 26, 40: 33}  # petsc_perf_breakdown_3d.csv
REF_ILU_2D = {4: 5, 8: 7, 16: 11, 32: 20, 64: 43, 128: 74, 256: 117}
REF_NGS_2D = {4: 16, 8: 63, 16: 194, 32: 635}
# the whole Picard column of petsc_perf_breakdown-with-picard.csv
REF_NGS_2D_FULL = {4: 16, 8: 63, 16: 194, 32: 635, 64: 1673, 128: 5135}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().ravel()


def _setup(N: int, dim: int, quad_or_hex: bool, device: DeviceLike = None):
    """The mesh, the parameters, the structured system, its CSR, the
    lifted right-hand side and the BC lift (host arrays)."""
    params = default_model_params()
    if dim == 3:
        mesh = create_cube_mesh(N, N, N, hexahedral=quad_or_hex)
        exacts = exact_expressions_3d(mesh, params)
    else:
        mesh = create_mesh(N, N, quadrilateral=quad_or_hex)
        exacts = exact_expressions(mesh, params)
    _, V = create_function_spaces(mesh, device=device)
    W = mixed_space(V)
    _, p1e, _, p2e = exacts
    bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]
    op = DPPOperator(W, params)
    g1, g2 = bc_values_per_field(W, bcs)
    b1, b2 = op.lifted_rhs(g1, g2)
    b = np.concatenate([_host(b1), _host(b2)])
    bdry = np.asarray(mesh.boundary_mask()).ravel()
    x0 = np.concatenate([np.where(bdry, _host(g1), 0.0), np.where(bdry, _host(g2), 0.0)])
    sysm = build_monolithic_system(mesh, params)
    return mesh, params, sysm, od.to_csr(sysm), b, x0


def _perm(ordering: str, mesh, A, nv: int) -> np.ndarray:
    if ordering == "natural":
        return np.arange(2 * nv)
    if ordering == "vertex-rcm":
        return od.blocked(od.vertex_rcm(A[:nv, :nv]))
    if ordering == "cell-rcm":
        return od.blocked(od.cell_rcm(mesh))
    if ordering == "cell-rcm-parity":
        # the pinned tie-break draw that lands every published count
        # (pc_factor_mat_ordering_type=rcm)
        return od.blocked(od.cell_rcm_parity(mesh))
    if ordering == "random":
        return od.blocked(od.random_ordering(nv))
    raise ValueError(ordering)


def ilu_case(N: int, dim: int, ordering: str, pattern: str, quad_or_hex: bool = False,
             device: DeviceLike = None) -> int:
    """GMRES(30) + ILU(0) iteration count (the Newton-step system, rtol
    1e-8) in ``ordering`` with the ``envelope`` or ``fe`` fill pattern."""
    mesh, params, sysm, A, b, x0 = _setup(N, dim, quad_or_hex, device)
    nv = A.shape[0] // 2
    if pattern == "fe":
        A = od.tighten_pattern(A, sysm, mesh, params)
    perm = _perm(ordering, mesh, A, nv)
    Ap = A[perm][:, perm].tocsr()
    bp = (b - A @ x0)[perm]
    F, diag = od.host_ilu0(Ap)
    return od.host_gmres(lambda v: Ap @ v, bp, lambda v: od.host_ilu_apply(F, diag, v))


def ngs_case(N: int, dim: int, ordering: str, stol: float = 1e-8, device: DeviceLike = None) -> int:
    """Pointwise-GS sweep count from the BC lift (pattern-independent)."""
    mesh, params, sysm, A, b, x0 = _setup(N, dim, dim == 2, device)
    nv = A.shape[0] // 2
    perm = _perm(ordering, mesh, A, nv)
    Ap = A[perm][:, perm].tocsr()
    return od.host_gs_sweeps(Ap, b[perm], x0[perm], stol=stol)


def run_study(
    ilu_3d_sizes: List[int],
    ilu_2d_sizes: List[int],
    ngs_sizes: List[int],
    out: Optional[Path] = None,
    device: DeviceLike = None,
) -> List[dict]:
    """The ordering study's rows (written to ``out`` as they come)."""
    rows: List[dict] = []

    def add(**kw):
        rows.append(kw)
        print("[ordering] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)
        if out is not None:
            save_csv(rows, out)

    for N in ilu_3d_sizes:
        for o in ORDERINGS:
            for pat in ("envelope", "fe"):
                add(dim=3, element="tet", N=N, algorithm="gmres+ilu0", ordering=o, pattern=pat,
                    its=ilu_case(N, 3, o, pat, device=device), reference_its=REF_ILU_3D.get(N, ""))
    for N in ilu_2d_sizes:
        for o in ORDERINGS:
            # the quad envelope is the finite-element pattern: one row each
            add(dim=2, element="quad", N=N, algorithm="gmres+ilu0", ordering=o, pattern="envelope==fe",
                its=ilu_case(N, 2, o, "envelope", quad_or_hex=True, device=device),
                reference_its=REF_ILU_2D.get(N, ""))
    for N in ngs_sizes:
        for o in ORDERINGS:
            for stol, crit in ((1e-8, "rtol+stol"), (0.0, "rtol-only")):
                add(dim=2, element="quad", N=N, algorithm="pointwise-gs", ordering=o,
                    pattern=f"criterion={crit}", its=ngs_case(N, 2, o, stol=stol, device=device),
                    reference_its=REF_NGS_2D.get(N, ""))
    return rows


def ngs_coloring_case(N: int, weight: str, pattern: str, device: DeviceLike = None) -> Tuple[int, int]:
    """One re-draw of PETSc's randomised-colouring NGS: greedy colouring of
    the Jacobian's pattern by drand48 weights (largest first), then
    multicolour secant sweeps. Returns ``(sweeps, ncolors)``.

    ``weight``: ``drand48`` (the bare weights) or ``drand48+deg`` (biased
    by vertex degree). ``pattern``: ``full`` colours the stored pattern
    (eliminated entries kept as explicit zeros) or ``values`` (nonzeros
    only). No variant is expected to match exactly; together they bracket
    the published counts."""
    mesh, params, sysm, A, b, x0 = _setup(N, 2, True, device)
    A = A.tocsr()
    n = A.shape[0]
    if pattern == "full":
        rows_, cols_ = [], []
        for t in range(sysm.vals.shape[1]):
            r = np.flatnonzero(sysm.valid[:, t])
            rows_.append(r)
            cols_.append(r + sysm.deltas[t])
        rr = np.concatenate(rows_)
        cc = np.concatenate(cols_)
        ok = (cc >= 0) & (cc < n)
        G = sp.csr_matrix((np.ones(ok.sum()), (rr[ok], cc[ok])), shape=(n, n))
    else:
        G = A
    w = od.drand48_weights(n)
    if weight == "drand48+deg":
        w = w + np.diff(G.tocsr().indptr)
    order = np.argsort(w, kind="stable")[::-1]
    colors = od.greedy_coloring(G, order)
    return od.colored_ngs_sweeps(A, b, x0, colors), int(colors.max()) + 1


def ngs_parity_case(N: int, device: DeviceLike = None) -> Tuple[int, int]:
    """The pinned draw (``ops/ordering.py::ngs_parity_coloring``), which
    lands the published Picard counts at every size. Returns ``(sweeps,
    ncolors)``."""
    mesh, params, sysm, A, b, x0 = _setup(N, 2, True, device)
    colors = od.ngs_parity_coloring(mesh)
    return od.colored_ngs_sweeps(A.tocsr(), b, x0, colors), int(colors.max()) + 1


def run_ngs_coloring_study(sizes: List[int], out: Optional[Path] = None, device: DeviceLike = None) -> List[dict]:
    """The colouring re-draws and the pinned draw at each size: the rows of
    ``ngs_coloring.csv``."""
    rows: List[dict] = []
    for N in sizes:
        ref = REF_NGS_2D_FULL.get(N, "")
        lex = ngs_case(N, 2, "natural", stol=0.0, device=device)
        rows.append(dict(N=N, variant="lexicographic-gs", ncolors="", its=lex, reference_its=ref))
        for weight in ("drand48", "drand48+deg"):
            for pattern in ("full", "values"):
                its, nc = ngs_coloring_case(N, weight, pattern, device=device)
                rows.append(dict(N=N, variant=f"colored:{weight}/{pattern}", ncolors=nc, its=its, reference_its=ref))
        its, nc = ngs_parity_case(N, device=device)
        rows.append(dict(N=N, variant="colored:parity-pinned", ncolors=nc, its=its, reference_its=ref))
        print(f"[ngs-coloring] N={N}: {rows[-6:]}", flush=True)
        if out is not None:
            save_csv(rows, out)
    return rows


def save_csv(rows: List[dict], path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument(
        "--ngs-coloring",
        action="store_true",
        help="run the randomised-colouring NGS re-draw study instead "
        "(writes results-conforming-2d/ordering/ngs_coloring.csv)",
    )
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", default=None, help="the BC lift's device (default: the card)")
    args = ap.parse_args(argv)
    nb = Path(__file__).parents[2] / "notebooks"
    if args.ngs_coloring:
        out = args.out or (nb / "results-conforming-2d" / "ordering" / "ngs_coloring.csv")
        sizes = [4, 8, 16] if args.fast else [4, 8, 16, 32, 64, 128]
        rows = run_ngs_coloring_study(sizes, out=out, device=args.device)
        save_csv(rows, out)
        print(f"[ngs-coloring] wrote {len(rows)} rows -> {out}")
        return
    out = args.out or (nb / "results-conforming-3d" / "ordering" / "ordering_sensitivity.csv")
    sizes = ([4, 8], [4, 8], [4, 8]) if args.fast else ([4, 8, 16, 32], [4, 8, 16, 32], [4, 8, 16])
    rows = run_study(*sizes, out=out, device=args.device)
    save_csv(rows, out)
    print(f"[ordering] wrote {len(rows)} rows -> {out}")


if __name__ == "__main__":
    main()
