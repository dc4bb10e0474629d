"""The port's 2D profiling driver on the CPU (``experiments/profiling.py``),
held to the JAX package's and to the committed ``petsc_perf_breakdown.csv``:

- ``PerfResult.to_dict`` has the committed header's 45 columns in its
  order; the JAX package's row has the same keys (its order puts
  ``measurement_class`` earlier, the committed files carry it last);
- ``run_perf_once`` at 2D N=4 for the six approaches: ``iterations``,
  ``dofs``, ``num_cells``, every ``flops_*`` and ``mem_mat_*`` column equal
  to the JAX package's, and ``residual`` within 1e-8 relative but for plain
  GMRES, which stops in a stagnation tail where two f64 reduction orders
  report residuals ~2.5x apart, both below ``rtol ||r0||``. SS-GMRES + ILU's
  route is K8 (its twin here), whose blocks run the preset's own inner
  GMRES + ILU, as the JAX package's CPU route does;
- the backend waterfall (a failed probe falls to ``wall`` with truthful
  metadata), the trace and stage backends, a sweep with its CSV and JSON;
- the CSV writers (the ``csv`` module) against the JAX package's pandas
  writers: the files parse to the same rows, and a splice keeps the rows
  it does not replace.

The JAX rows run with its chaining switched off (``CHAIN_BUDGET_S = 0``,
its dispatch loop: the same solves without a compiled chain per length) and
its ILU in float64 (``PERPHIL_TPU_ILU_DTYPE``, not in its solver cache key,
hence the ``cache_clear``).
"""

import csv
import math
from pathlib import Path

import pandas as pd
import pytest
import torch

import perphil_tpu.experiments.profiling as jprof
import perphil_tpu.solvers.solver as jsolver
from perphil_tpu.experiments.iterative_bench import Approach as JApproach

import perphil_tpu_torch.experiments.profiling as prof
from perphil_tpu_torch.experiments.iterative_bench import Approach

RESULTS = Path(__file__).resolve().parent.parent / "notebooks/results-conforming-2d/petsc_profiling"
APPROACHES = list(Approach)
RESIDUAL_BOUND = 1e-8  # relative; plain GMRES: both below rtol ||r0||


def _header(path: Path):
    with path.open() as f:
        return next(csv.reader(f))


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX package's N=4 rows, one per approach (the ``wall`` backend:
    the analytic columns do not depend on it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PERPHIL_TPU_ILU_DTYPE", "float64")
        mp.setattr(jprof, "CHAIN_BUDGET_S", 0.0)
        jsolver._build_linear_solver.cache_clear()
        jsolver._build_nonlinear_solver.cache_clear()
        rows = {ap: jprof.run_perf_once(4, 4, JApproach(ap.value), repeats=1, backend="wall", eager=False)
                for ap in APPROACHES}
        jsolver._build_linear_solver.cache_clear()
        jsolver._build_nonlinear_solver.cache_clear()
    return rows


@pytest.fixture(scope="module")
def port_rows():
    return {ap: prof.run_perf_once(4, 4, ap, repeats=2, backend="events", device="cpu") for ap in APPROACHES}


def test_event_vocabulary_matches():
    assert prof.EVENT_ALIASES == jprof.EVENT_ALIASES
    assert prof.DEFAULT_LOGICAL_EVENTS == jprof.DEFAULT_LOGICAL_EVENTS
    for e in prof.DEFAULT_LOGICAL_EVENTS:
        assert prof.EVENT_ALIASES[e] == e
    assert (prof.KSP_CHUNK, prof.NGS_CHUNK) == (2010, 500)


def test_to_dict_columns_are_the_committed_header(port_rows, jax_rows):
    header = _header(RESULTS / "petsc_perf_breakdown.csv")
    assert len(header) == 45
    assert _header(RESULTS / "petsc_perf_breakdown-with-picard.csv") == header
    for ap in APPROACHES:
        row = port_rows[ap].to_dict()
        assert list(row) == header
        assert set(row) == set(jax_rows[ap].to_dict())


@pytest.mark.parametrize("approach", APPROACHES, ids=[a.name.lower() for a in APPROACHES])
def test_run_perf_once_matches_jax(approach, port_rows, jax_rows):
    got, ref = port_rows[approach].to_dict(), jax_rows[approach].to_dict()
    for k in ("approach", "nx", "ny", "iterations", "dofs", "num_cells"):
        assert got[k] == ref[k], k
    analytic = [k for k in ref if k.startswith(("flops_", "mem_mat_"))]
    assert len(analytic) == 12
    for k in analytic:
        assert got[k] == ref[k], k
    if approach == Approach.PLAIN_GMRES:
        r0 = prof._lift_norm(*_lift_op(4))
        assert 0.0 < got["residual"] <= 1e-8 * r0 and 0.0 < ref["residual"] <= 1e-8 * r0 * (1 + 1e-9)
    elif ref["residual"] == 0.0:
        assert got["residual"] == 0.0
    else:
        assert abs(got["residual"] - ref["residual"]) <= RESIDUAL_BOUND * ref["residual"]
    meta = got["metadata"]
    assert meta["backend"] == "events" and meta["repeats"] == 2 and meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__ and "perphil_tpu_torch_version" in meta
    assert got["measurement_class"] == "cpu-x64"
    assert got["time_total"] > 0.0 and got["time_total_repeats"] >= got["time_total"]
    assert got["time_PCSetUp"] > 0.0 and got["time_MatMult"] > 0.0
    assert got["mem_device_bytes_in_use"] is None and got["mem_device_peak_bytes"] is None
    event = "time_SNESSolve" if approach == Approach.PICARD_MUMPS else "time_KSPSolve"
    assert got[event] > 0.0


def _lift_op(n):
    from perphil_tpu_torch.experiments.iterative_bench import build_mesh, build_spaces, default_model_params
    from perphil_tpu_torch.ops.assembly import DirichletBC, DPPOperator, bc_values_per_field
    from perphil_tpu_torch.utils.manufactured_solutions import exact_expressions

    mesh = build_mesh(n, n)
    _, _, W = build_spaces(mesh, "cpu")
    params = default_model_params()
    _, p1e, _, p2e = exact_expressions(mesh, params)
    g1, g2 = bc_values_per_field(W, [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)])
    return DPPOperator(W, params), g1, g2


def test_explicit_backend_failure_falls_back_to_wall(monkeypatch, capsys):
    """A requested backend whose probe fails still ships a wall measurement
    and says so, never a zero row under the requested name."""

    def boom(*a, **k):
        raise RuntimeError("probe exploded")

    monkeypatch.setattr(prof, "_profile_with_events", boom)
    res = prof.run_perf_once(4, 4, Approach.SS_GMRES, backend="events", device="cpu")
    assert res.metadata["backend"] == "wall"
    assert res.time_total > 0.0 and res.times["KSPSolve"] > 0.0 and res.iterations == 4
    assert "backend 'events' failed" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["trace", "stage"])
def test_backend_variants_measure(backend):
    """The trace backend sums the traced operators' time (the CPU's; on the
    card the kernels'); the stage backend times the solve by the wall
    clock. Both give nonzero solve times and the right tag."""
    res = prof.run_perf_once(4, 4, Approach.GMRES_ILU, repeats=2, backend=backend, device="cpu")
    assert res.metadata["backend"] == backend
    assert res.time_total > 0.0 and res.times["KSPSolve"] > 0.0
    assert res.iterations == 5
    if backend == "trace":
        assert res.times["MatMult"] > 0.0 and res.times["PCApply"] > 0.0
    else:
        assert res.times["MatMult"] == 0.0


def test_ensure_logging_names_cuda():
    if torch.cuda.is_available():
        assert prof.ensure_logging() is True
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            prof.ensure_logging()


def _parsed(path):
    return pd.read_csv(path, keep_default_na=True)


def test_sweep_and_save_match_pandas(tmp_path):
    rows = prof.run_perf_sweep([4], approaches=[Approach.MONOLITHIC_MUMPS, Approach.SS_GMRES], repeats=1,
                               device="cpu")
    assert len(rows) == 2
    prof.save_perf_csv(rows, tmp_path / "port.csv")
    prof.save_perf_json(rows, tmp_path / "perf.json")
    jprof.save_perf_csv(rows, tmp_path / "jax.csv")
    with (tmp_path / "port.csv").open() as f:
        got = list(csv.DictReader(f))
    assert {r["approach"] for r in got} == {"Monolithic LU with MUMPS", "Scale-Splitting GMRES"}
    assert list(got[0]) == _header(RESULTS / "petsc_perf_breakdown.csv")
    pd.testing.assert_frame_equal(_parsed(tmp_path / "port.csv"), _parsed(tmp_path / "jax.csv"))
    import json

    assert [r["iterations"] for r in json.loads((tmp_path / "perf.json").read_text())] == [1, 4]


def test_sweep_keeps_going_past_a_failed_row(monkeypatch, capsys):
    real = prof.run_perf_once

    def flaky(n, ny, ap, **kw):
        if ap == Approach.SS_GMRES:
            raise RuntimeError("row failed")
        return real(n, ny, ap, **kw)

    monkeypatch.setattr(prof, "run_perf_once", flaky)
    rows = prof.run_perf_sweep([4], approaches=[Approach.SS_GMRES, Approach.MONOLITHIC_MUMPS], repeats=1,
                               device="cpu")
    assert [r["approach"] for r in rows] == ["Monolithic LU with MUMPS"]
    assert "FAILED" in capsys.readouterr().out


def test_splice_matches_pandas_and_keeps_other_rows(tmp_path, port_rows):
    committed = (RESULTS / "petsc_perf_breakdown.csv").read_text()
    for name in ("port.csv", "jax.csv"):
        (tmp_path / name).write_text(committed)
    rows = [port_rows[Approach.PLAIN_GMRES].to_dict(), port_rows[Approach.GMRES_ILU].to_dict()]
    prof.splice_perf_csv(rows, tmp_path / "port.csv")
    jprof.splice_perf_csv(rows, tmp_path / "jax.csv")
    got, ref = _parsed(tmp_path / "port.csv"), _parsed(tmp_path / "jax.csv")
    pd.testing.assert_frame_equal(got, ref)
    old = _parsed(RESULTS / "petsc_perf_breakdown.csv")
    assert len(got) == len(old) and list(got.columns) == list(old.columns)
    replaced = {("GMRES", 4), ("GMRES + ILU PC", 4)}
    for (_, a), (_, b) in zip(got.iterrows(), old.iterrows()):
        if (a["approach"], a["nx"]) not in replaced:
            assert a.equals(b) or all(
                (x == y) or (isinstance(x, float) and math.isnan(x) and math.isnan(y)) for x, y in zip(a, b)
            )
    new = got[(got["nx"] == 4) & (got["approach"] == "GMRES")].iloc[0]
    assert new["measurement_class"] == "cpu-x64" and math.isnan(new["mem_device_peak_bytes"])
    # a new file is written whole
    prof.splice_perf_csv(rows, tmp_path / "new.csv")
    assert len(_parsed(tmp_path / "new.csv")) == 2
