"""Walls of the single-device degree-p linear solves on the card, against
another checkout's in the same process.

    python perphil_tpu_torch/tools/degree_p_walls.py [--against DIR] [--repeats R] [--out FILE]
    python perphil_tpu_torch/tools/degree_p_walls.py --ops [--against DIR] [--device cpu]

Times the cached degree-p solves (``solvers/solver.py::_degree_solver``:
the lift and the solve) at the Qp and P2 rows of ``chip_smoke.py``'s phase
12 (Q2 and Q3 at N=4/8/16 direct; Q2 GMRES with jacobi and with the
multiplicative fieldsplit at N=4/8/16; P2 on triangles, GMRES + jacobi at
N=8/16/32) and at full width (Q2 2D N=128 direct and GMRES + fieldsplit at
rtol 1e-8, Q2 hex N=32 direct, P2 tri N=64 GMRES + jacobi at rtol 1e-8),
and the operator's matvec alone (P2 tri N=32/64, Q2 2D N=128).

``--against DIR`` loads the port of the checkout ``DIR`` beside this one,
as a copy renamed ``perphil_tpu_against`` (its imports rewritten, in a
temporary directory), and times both packages' calls in alternation (A B,
then B A), so that the machine's drift falls on both alike: the row gives
each package's median and the median of the paired ratios (this tree over
``DIR``). Each call is built and run once first (``first_s``: the set-up
and a cold solve); a solve row times R solves (host clock between
synchronisations) and divides by the iterations; a matvec row times R
batches of 100 calls issued back to back. ``--ops`` instead counts the
torch operators one warm call dispatches at N=8 (:data:`OPS_ROWS`, on
``--device``, the CPU too): the host's share of a call, free of the
clock's spread. Prints one JSON object (and writes it to ``--out``): the
card's name and power limit (``cpu`` on the CPU), the checkouts, and the
rows.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# (element, N, degree, solve); the options as in chip_smoke.py's phase 12
ROWS = (
    [("quad", n, p, "direct") for p in (2, 3) for n in (4, 8, 16)]
    + [("quad", n, 2, s) for s in ("jacobi-1e-13", "fieldsplit-1e-12") for n in (4, 8, 16)]
    + [("triangle", n, 2, "jacobi-1e-13") for n in (8, 16, 32)]
    + [("quad", 128, 2, "direct"), ("quad", 128, 2, "fieldsplit-1e-8"), ("hex", 32, 2, "direct"),
       ("triangle", 64, 2, "jacobi-1e-8")]
    + [("triangle", 32, 2, "matvec"), ("triangle", 64, 2, "matvec"), ("quad", 128, 2, "matvec")]
)
MATVEC_CALLS = 100
OPS_ROWS = (("triangle", 8, 2, "jacobi-1e-8"), ("quad", 8, 2, "jacobi-1e-8"), ("quad", 8, 2, "fieldsplit-1e-8"),
            ("quad", 8, 2, "direct"), ("triangle", 8, 2, "matvec"), ("quad", 8, 2, "matvec"))
HERE, AGAINST = "perphil_tpu_torch", "perphil_tpu_against"


def options(solve: str) -> dict:
    """The solver options of a row's ``solve``: ``direct`` or
    ``<pc>-<rtol>``."""
    if solve == "direct":
        return {"ksp_type": "preonly", "pc_type": "lu"}
    pc, rtol = solve.split("-", 1)
    opts = {"ksp_type": "gmres", "pc_type": pc, "ksp_rtol": float(rtol), "ksp_max_it": 20000}
    if pc == "fieldsplit":
        opts["pc_fieldsplit_type"] = "multiplicative"
    return opts


def card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def load_against(checkout: str, into: str) -> None:
    """Copy the port of ``checkout`` into ``into`` as the package
    ``perphil_tpu_against`` (every ``perphil_tpu_torch`` in its Python
    sources renamed) and put ``into`` first on the import path."""
    dst = Path(into) / AGAINST
    shutil.copytree(Path(checkout) / HERE, dst, ignore=shutil.ignore_patterns("__pycache__"))
    for f in dst.rglob("*.py"):
        f.write_text(re.sub(rf"\b{HERE}\b", AGAINST, f.read_text()))
    sys.path.insert(0, str(into))


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def problem(pkg: str, element: str, n: int, degree: int, device):
    """The space, the boundary conditions and the parameters of a row, in
    the package ``pkg``."""
    forms, mesh_mod = _mod(pkg, "forms"), _mod(pkg, "mesh")
    params = _mod(pkg, "models.dpp").DPPParameters()
    exact = _mod(pkg, "utils.manufactured_solutions")
    if element == "hex":
        mesh = mesh_mod.create_cube_mesh(n, n, n, hexahedral=True)
        _, p1e, _, p2e = exact.exact_expressions_3d(mesh, params)
    else:
        mesh = mesh_mod.create_mesh(n, n, quadrilateral=element == "quad")
        _, p1e, _, p2e = exact.exact_expressions(mesh, params)
    W = forms.mixed_space(forms.FunctionSpace(mesh, degree=degree, device=device))
    bc = _mod(pkg, "ops.assembly").DirichletBC
    return W, [bc(W.sub(0), p1e), bc(W.sub(1), p2e)], params


def call(pkg: str, element: str, n: int, degree: int, solve: str, device):
    """The row's call in the package ``pkg``, built (its solver or operator
    set up), ``() -> (fields, iterations)``: a solve of the cached solver,
    or one matvec."""
    W, bcs, params = problem(pkg, element, n, degree, device)
    g = _mod(pkg, "ops.assembly").bc_values_per_field(W, bcs)
    if solve == "matvec":
        mesh = W.mesh
        op = (_mod(pkg, "ops.tensorfem").TensorDPPOperator(mesh, params, degree, device=W.device)
              if mesh.is_tensor_product else
              _mod(pkg, "ops.simplexfem").P2SimplexDPPOperator(mesh, params, device=W.device))
        return lambda: (op.matvec(*g)[0], 1)
    solver_mod = _mod(pkg, "solvers.solver")
    solver = solver_mod._degree_solver(W, params, solver_mod._freeze(options(solve)))

    def run():
        out = solver(*g)
        return out[0], int(out[2])

    return run


def count_ops(pkg: str, element: str, n: int, degree: int, solve: str, device) -> dict:
    """The torch operators one warm call of the row dispatches."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    fn = call(pkg, element, n, degree, solve, device)
    fn()
    with Count() as c:
        _, its = fn()
    total = sum(c.ops.values())
    return dict(package=pkg, element=element, N=n, degree=degree, solve=solve, its=its, ops=total,
                ops_per_it=total / its)


def time_row(pkgs, element: str, n: int, degree: int, solve: str, repeats: int, device) -> dict:
    """A row timed in every package of ``pkgs``, in alternation: ms an
    iteration (a matvec: a call) per package, its median, and the median of
    the paired ratios of the first package over the others."""
    import torch

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    calls = {}
    out = dict(element=element, N=n, degree=degree, solve=solve, first_s={}, its={}, finite={}, ms={})
    for pkg in pkgs:
        sync()
        t0 = time.perf_counter()
        calls[pkg] = call(pkg, element, n, degree, solve, device)
        z, its = calls[pkg]()
        sync()
        out["first_s"][pkg] = time.perf_counter() - t0
        out["its"][pkg], out["finite"][pkg], out["ms"][pkg] = its, bool(torch.isfinite(z).all()), []
    batch = MATVEC_CALLS if solve == "matvec" else 1
    for r in range(repeats):
        for pkg in (pkgs if r % 2 == 0 else pkgs[::-1]):
            sync()
            t0 = time.perf_counter()
            for _ in range(batch):
                calls[pkg]()
            sync()
            out["ms"][pkg].append((time.perf_counter() - t0) * 1e3 / batch / out["its"][pkg])
    out["median_ms"] = {pkg: statistics.median(v) for pkg, v in out["ms"].items()}
    out["paired_ratio"] = {pkg: statistics.median(a / b for a, b in zip(out["ms"][pkgs[0]], out["ms"][pkg]))
                           for pkg in pkgs[1:]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None, help="another checkout's root, timed beside this tree")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ops", action="store_true", help="count the operators a warm call dispatches")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from perphil_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        pkgs = [HERE]
        if args.against:
            load_against(args.against, tmp)
            pkgs.append(AGAINST)
        if args.ops:
            rows = [count_ops(pkg, *row, device) for row in OPS_ROWS for pkg in pkgs]
        else:
            rows = [time_row(pkgs, *row, args.repeats, device) for row in ROWS]
    record = dict(card=card(device), packages={HERE: str(Path(__file__).resolve().parents[2]),
                                               AGAINST: args.against}, repeats=args.repeats, rows=rows)
    text = json.dumps(record)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)
    return record


if __name__ == "__main__":
    main()
