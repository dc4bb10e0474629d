"""The port's 3D profiling driver on the CPU (``experiments/profiling_3d.py``)
at tet nx=4, held to the JAX package's ``run_perf_once_3d`` and to the
committed ``petsc_perf_breakdown_3d.csv`` (hex nx=4:
``test_torch_profiling_hex.py``):

- every approach: ``iterations``, ``dofs``, ``num_cells``, the ``flops_*``
  and ``mem_mat_*`` columns equal, ``residual`` within 1e-8 relative but
  for plain GMRES (a stagnation tail: two f64 reduction orders report
  residuals up to ~15% apart, both below ``rtol ||r0||``; bound 20%);
  SS-GMRES + ILU's K8 twin runs the preset's own inner GMRES + ILU, as the
  JAX CPU route does; the row's columns are the committed header's;
- the ordering-parity GMRES + ILU row (``ordering_parity=True``): the
  published 6, on the engine the open option takes on the CPU (the host
  engine), which the metadata records with the backend that measured it.

The JAX rows run with its chaining off (``CHAIN_BUDGET_S = 0``) and its ILU
in float64 (``PERPHIL_TPU_ILU_DTYPE``; hence the ``cache_clear``).
"""

import csv
from pathlib import Path

import pytest

import perphil_tpu.experiments.profiling as jprof
import perphil_tpu.experiments.profiling_3d as jprof3
import perphil_tpu.solvers.solver as jsolver
from perphil_tpu.experiments.iterative_bench import Approach as JApproach

import perphil_tpu_torch.experiments.profiling_3d as prof3
from perphil_tpu_torch.experiments.iterative_bench import Approach

RESULTS = Path(__file__).resolve().parent.parent / "notebooks/results-conforming-3d/petsc_profiling"
APPROACHES = list(Approach)
ELEMENT, HEX = "tet", False
RESIDUAL_BOUND = 1e-8  # relative, but for plain GMRES


def jax_rows_3d(hexahedral, approaches, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PERPHIL_TPU_ILU_DTYPE", "float64")
        mp.setattr(jprof, "CHAIN_BUDGET_S", 0.0)
        jsolver._build_linear_solver.cache_clear()
        jsolver._build_nonlinear_solver.cache_clear()
        rows = {ap: jprof3.run_perf_once_3d(4, JApproach(ap.value), repeats=1, backend="wall",
                                            hexahedral=hexahedral, **kw) for ap in approaches}
        jsolver._build_linear_solver.cache_clear()
        jsolver._build_nonlinear_solver.cache_clear()
    return rows


def check_row(approach, got, ref, header, element):
    got, ref = got.to_dict(), ref.to_dict()
    assert list(got) == header
    for k in ("approach", "nx", "ny", "iterations", "dofs", "num_cells"):
        assert got[k] == ref[k], k
    analytic = [k for k in ref if k.startswith(("flops_", "mem_mat_"))]
    assert len(analytic) == 12
    for k in analytic:
        assert got[k] == ref[k], k
    if approach == Approach.PLAIN_GMRES:
        # both stopped below rtol ||r0||; they part in the stagnation tail
        assert got["residual"] > 0.0 and abs(got["residual"] - ref["residual"]) <= 0.2 * ref["residual"]
    elif ref["residual"] == 0.0:
        assert got["residual"] == 0.0
    else:
        assert abs(got["residual"] - ref["residual"]) <= RESIDUAL_BOUND * ref["residual"]
    meta = got["metadata"]
    assert (meta["dim"], meta["element"], meta["ordering"]) == (3, element, "natural")
    assert meta["backend"] == "events" and meta["device"] == "cpu" and "engine" not in meta
    assert got["measurement_class"] == "cpu-x64" and got["time_total"] > 0.0


@pytest.fixture(scope="module")
def rows():
    port = {ap: prof3.run_perf_once_3d(4, ap, repeats=1, hexahedral=HEX, device="cpu") for ap in APPROACHES}
    return port, jax_rows_3d(HEX, APPROACHES)


@pytest.mark.parametrize("approach", APPROACHES, ids=[a.name.lower() for a in APPROACHES])
def test_run_perf_once_3d_matches_jax(approach, rows):
    with (RESULTS / "petsc_perf_breakdown_3d.csv").open() as f:
        header = next(csv.reader(f))
    port, jax = rows
    check_row(approach, port[approach], jax[approach], header, ELEMENT)


def test_ordering_parity_row_records_its_engine():
    got = prof3.run_perf_once_3d(4, Approach.GMRES_ILU, repeats=1, ordering_parity=True, device="cpu")
    ref = jax_rows_3d(False, [Approach.GMRES_ILU], ordering_parity=True)[Approach.GMRES_ILU]
    assert got.iterations == ref.iterations == 6
    assert got.to_dict()["flops_KSPSolve"] == ref.to_dict()["flops_KSPSolve"]
    assert abs(got.residual - ref.residual) <= 1e-8 * ref.residual
    meta = got.metadata
    assert (meta["ordering"], meta["engine"], meta["backend"]) == ("rcm-parity", "host", "events")
    assert got.measurement_class == "host-cpu"
    assert got.times["MatMult"] > 0.0 and got.times["PCApply"] == 0.0  # the host engine has no apply alone
