"""The port's convergence study on the CPU (``experiments/convergence_2d.py``,
``convergence_3d.py`` and the study half of ``iterative_bench.py``), held
to the JAX package and to the published 2D table
(``notebooks/results-conforming-2d/convergence.csv``):

- the approaches' labels, option sets and default solver sweeps equal the
  JAX package's;
- ``run_one`` at 2D N=4/8 for the five approaches of the published table:
  ``it`` equal to the CSV's, the four error columns within ``ERROR_BOUND``
  of it; at N=4 the same against the JAX package's ``run_one`` (which
  reproduces the CSV bit for bit on the CPU), within 1.5e-10. Every
  approach's route is the JAX package's native-f64 one: "Scale-Splitting
  GMRES + ILU PC" runs K8's twin, whose block solves are the preset's own
  inner GMRES(30) + ILU, as PETSc's and the JAX package's;
- ``compute_eoc`` against the JAX function on the published rows, and
  against ``convergence_eoc.csv``;
- ``run_one_3d`` at hex N=4: the direct row against the JAX package's,
  the fieldsplit-LU GMRES row against the direct one; ``main --degree 2``
  against the JAX package's, row for row; ``main`` of both study scripts
  writes the JAX package's CSV schema.

The JAX ILU runs in float64 (``PERPHIL_TPU_ILU_DTYPE``, not in its solver
cache key, hence the ``cache_clear``).
"""

import csv
from pathlib import Path

import pytest
import torch

import perphil_tpu.experiments.convergence_2d as jc2
import perphil_tpu.experiments.convergence_3d as jc3
import perphil_tpu.experiments.iterative_bench as jib
import perphil_tpu.solvers.solver as jsolver
from perphil_tpu.models.dpp import DPPParameters as JParams

import perphil_tpu_torch.experiments.convergence_2d as c2
import perphil_tpu_torch.experiments.convergence_3d as c3
import perphil_tpu_torch.experiments.iterative_bench as ib
from perphil_tpu_torch.mesh import create_mesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.utils.postprocessing import l2_error

RESULTS = Path(__file__).resolve().parent.parent / "notebooks/results-conforming-2d"
ERRORS = ("e1_L2", "e2_L2", "e1_H1s", "e2_H1s")
TABLE = [a for a in ib.Approach if a is not ib.Approach.PICARD_MUMPS]
ERROR_BOUND = {a: 1.5e-10 for a in TABLE}


def _published():
    with (RESULTS / "convergence.csv").open() as f:
        return {(int(r["N"]), r["solver"]): r for r in csv.DictReader(f)}


@pytest.fixture
def jax_f64_ilu(monkeypatch):
    monkeypatch.setenv("PERPHIL_TPU_ILU_DTYPE", "float64")
    jsolver._build_linear_solver.cache_clear()
    yield
    jsolver._build_linear_solver.cache_clear()


def _row(N, approach):
    return c2.run_one(N, c2.SolverSpec(approach.value, ib.params_for(approach)), True, 1, DPPParameters(),
                      device="cpu")


def test_study_definitions_match_jax():
    assert [a.value for a in ib.Approach] == [a.value for a in jib.Approach]
    assert [a.name for a in ib.Approach] == [a.name for a in jib.Approach]
    for a in ib.Approach:
        assert ib.params_for(a) == jib.params_for(jib.Approach(a.value)), a
    for pc in ("lu", "ilu", "jacobi"):
        assert ib.make_fieldsplit_params_with(pc) == jib.make_fieldsplit_params_with(pc)
    ours, theirs = c2._default_solvers([1e-8, 1e-10]), jc2._default_solvers([1e-8, 1e-10])
    assert [(s.name, s.params) for s in ours] == [(s.name, s.params) for s in theirs]
    assert [(s.name, s.params) for s in c3.default_solvers_3d()] == [
        ("mumps", jc3.LINEAR_SOLVER_PARAMS), ("fs-lu_gmres", {**jc3.GMRES_PARAMS, **jc3.FIELDSPLIT_LU_PARAMS})]


@pytest.mark.parametrize("approach", TABLE, ids=[a.name for a in TABLE])
@pytest.mark.parametrize("N", [4, 8])
def test_published_rows(N, approach):
    row = _row(N, approach)
    pub = _published()[(N, approach.value)]
    assert (row["N"], row["h"], row["degree"], row["quad"], row["solver"]) == (
        N, float(pub["h"]), 1, 1, approach.value)
    assert row["it"] == int(pub["it"])
    for k in ERRORS:
        assert abs(row[k] - float(pub[k])) / float(pub[k]) <= ERROR_BOUND[approach], k
    if approach is ib.Approach.MONOLITHIC_MUMPS:
        assert row["res"] == 0.0


@pytest.mark.parametrize("approach", TABLE, ids=[a.name for a in TABLE])
def test_rows_match_jax(approach, jax_f64_ilu):
    row = _row(4, approach)
    jrow = jc2.run_one(4, jc2.SolverSpec(approach.value, jib.params_for(jib.Approach(approach.value))), True, 1,
                       JParams())
    assert list(row) == list(jrow)
    assert row["it"] == jrow["it"]
    for k in ERRORS:
        assert abs(row[k] - jrow[k]) / jrow[k] <= ERROR_BOUND[approach], k


def test_compute_eoc_matches_jax_and_published():
    rows = [
        {**{k: float(v) for k, v in r.items() if k != "solver"}, "solver": r["solver"]}
        for r in _published().values()
    ]
    got, want = c2.compute_eoc(rows), jc2.compute_eoc(rows)
    assert [(e["solver"], e["err"]) for e in got] == [(e["solver"], e["err"]) for e in want]
    for g, w in zip(got, want):
        assert abs(g["slope"] - w["slope"]) <= 1e-12
    with (RESULTS / "convergence_eoc.csv").open() as f:
        published = [(r["solver"], r["err"], float(r["slope"])) for r in csv.DictReader(f)]
    assert [(e["solver"], e["err"]) for e in got] == [p[:2] for p in published]
    for e, (_, _, slope) in zip(got, published):
        assert abs(e["slope"] - slope) <= 1e-8


def test_run_one_3d_matches_jax():
    """Hex N=4: the direct row against the JAX package's (1e-10), the
    fieldsplit-LU GMRES row (4 iterations) against the direct one (1e-7:
    GMRES stops at rtol 1e-8)."""
    specs = c3.default_solvers_3d()
    rows = [c3.run_one_3d(4, s, hexahedral=True, params=DPPParameters(), device="cpu") for s in specs]
    jrow = jc3.run_one_3d(4, jc2.SolverSpec(specs[0].name, specs[0].params), hexahedral=True, params=JParams())
    assert list(rows[0]) == list(jrow) and rows[0]["hex"] == 1
    assert (rows[0]["it"], rows[1]["it"]) == (jrow["it"], 4) == (1, 4)
    for k in ERRORS:
        assert abs(rows[0][k] - jrow[k]) / jrow[k] <= 1e-10, k
        assert abs(rows[1][k] - rows[0][k]) / rows[0][k] <= 1e-7, k


def test_main_writes_the_jax_schema(tmp_path):
    out, eoc_out = tmp_path / "conv.csv", tmp_path / "eoc.csv"
    c2.main(["--Ns", "4", "8", "--rtols", "1e-8", "--out", str(out), "--eoc-out", str(eoc_out), "--device", "cpu"])
    with out.open() as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["N", "h", "degree", "quad", "solver", "it", "res", *ERRORS]
    assert [r["solver"] for r in rows] == ["mumps", "gmres_rtol=1e-08", "fs-lu_gmres_rtol=1e-08"] * 2
    assert [int(r["it"]) for r in rows] == [1, 10, 4, 1, 40, 4]
    with eoc_out.open() as f:
        assert len(list(csv.DictReader(f))) == 12
    out3 = tmp_path / "conv3d.csv"
    c3.main(["--Ns", "2", "3", "--out", str(out3), "--device", "cpu"])
    with out3.open() as f:
        rows3 = list(csv.DictReader(f))
    assert list(rows3[0]) == ["N", "h", "degree", "hex", "solver", "it", "res", *ERRORS]
    assert [r["solver"] for r in rows3] == ["mumps", "fs-lu_gmres"] * 2


def test_main_degree_2_matches_jax(tmp_path):
    """``--degree 2``: the Qp route under ``main``'s default solvers,
    row for row against the JAX package's ``main`` (equal counts; errors
    within 1e-12, plain GMRES's within 1e-8: its rtol 1e-8 iterate carries
    the stagnation tail's rounding, 1.1e-9 here)."""
    args = ["--Ns", "4", "--degree", "2", "--rtols", "1e-8"]
    c2.main(args + ["--out", str(tmp_path / "port.csv"), "--device", "cpu"])
    jc2.main(args + ["--out", str(tmp_path / "jax.csv")])
    with (tmp_path / "port.csv").open() as f, (tmp_path / "jax.csv").open() as g:
        rows, jrows = list(csv.DictReader(f)), list(csv.DictReader(g))
    assert [(r["solver"], r["degree"], r["it"]) for r in rows] == [(r["solver"], r["degree"], r["it"]) for r in jrows]
    assert [int(r["it"]) for r in rows] == [1, 99, 4]
    for r, j in zip(rows, jrows):
        bound = 1e-8 if r["solver"].startswith("gmres") else 1e-12
        for k in ERRORS:
            assert abs(float(r[k]) - float(j[k])) / float(j[k]) <= bound, (r["solver"], k)


def test_study_on_mesh_helpers():
    """``solve_on_mesh`` with the default (homogeneous) BCs, and the
    per-field errors against a reference solution."""
    _, V, W = ib.build_spaces(ib.build_mesh(4, 4), device="cpu")
    assert W.device == torch.device("cpu") and V.degree == 1
    res = ib.solve_on_mesh(W, ib.Approach.SS_GMRES)
    assert res.approach is ib.Approach.SS_GMRES and res.residual_error == 0.0
    assert all(float(f.data.abs().max()) == 0.0 for f in res.fields)
    ref = ib.solve_on_mesh(W, ib.Approach.MONOLITHIC_MUMPS, bcs=[
        ib.DirichletBC(W.sub(0), 1.0), ib.DirichletBC(W.sub(1), 2.0)])
    norms = tuple(l2_error(f, lambda x, y: 0.0 * x) for f in ref.fields)
    assert norms[0] > 0.5 and norms[1] > 1.0
    assert ib.l2_errors_against_reference(W, res.fields, ref.fields) == pytest.approx(norms, rel=1e-12)
    assert ib.l2_errors_against_reference(W, ref.fields, ref.fields) == (0.0, 0.0)


def test_entry_points_default_to_the_card():
    """With no ``device`` the study runs on the card: without one it raises
    and names CUDA."""
    if torch.cuda.is_available():
        assert ib.build_spaces(create_mesh(2, 2))[2].device.type == "cuda"
        return
    spec = c2.SolverSpec("mumps", ib.params_for(ib.Approach.MONOLITHIC_MUMPS))
    for call in (lambda: c2.run_one(4, spec, True, 1, DPPParameters()),
                 lambda: c3.run_one_3d(2, spec, True, DPPParameters()),
                 lambda: ib.build_spaces(create_mesh(2, 2)),
                 lambda: c2.main(["--Ns", "4"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
