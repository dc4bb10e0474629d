"""The port's ordering study on the CPU (``experiments/ordering_study.py``,
``ops/ordering.py::random_ordering`` and ``host_gs_sweeps``), held to the
JAX package's and to the committed CSVs:

- ``random_ordering`` is the JAX package's permutation, bit for bit;
- ``host_gs_sweeps`` (the C++ kernel, built by ``ops/_native.py``) counts
  the JAX package's sweeps, from both stopping tests, in every ordering;
- ``ilu_case`` at 3D tet N=4 (both patterns) and 2D N=4/8/16, ``ngs_case``
  at N=4/8 and ``ngs_coloring_case`` / ``ngs_parity_case`` at N=4/8: the
  counts of ``ordering_sensitivity.csv`` / ``ngs_coloring.csv`` (the
  ``cell-rcm-parity`` rows, which that CSV predates, against the JAX
  package's); ``run_study`` and ``run_ngs_coloring_study`` give the CSVs'
  rows and schema.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import perphil_tpu.experiments.ordering_study as jstudy
import perphil_tpu.ops.ordering as jord

import perphil_tpu_torch.experiments.ordering_study as study
import perphil_tpu_torch.ops.ordering as tord

NB = Path(__file__).resolve().parent.parent / "notebooks"
SENSITIVITY = NB / "results-conforming-3d/ordering/ordering_sensitivity.csv"
COLORING = NB / "results-conforming-2d/ordering/ngs_coloring.csv"


def _csv(path):
    with path.open() as f:
        return list(csv.DictReader(f))


def _published():
    return {(int(r["dim"]), int(r["N"]), r["algorithm"], r["ordering"], r["pattern"]): int(r["its"])
            for r in _csv(SENSITIVITY)}


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 0), (50, 3), (1000, 12345)])
def test_random_ordering_is_the_jax_packages(n, seed):
    got, ref = tord.random_ordering(n, seed), jord.random_ordering(n, seed)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("ordering", study.ORDERINGS)
def test_host_gs_sweeps_match_jax(ordering):
    mesh, params, sysm, A, b, x0 = study._setup(8, 2, True, "cpu")
    nv = A.shape[0] // 2
    perm = study._perm(ordering, mesh, A, nv)
    Ap = A[perm][:, perm].tocsr()
    for stol in (1e-8, 0.0):
        got = tord.host_gs_sweeps(Ap, b[perm], x0[perm], stol=stol)
        assert got == jord.host_gs_sweeps(Ap, b[perm], x0[perm], stol=stol)
    # max_it stops it, and x0 is not written
    x_in = x0[perm].copy()
    assert tord.host_gs_sweeps(Ap, b[perm], x_in, stol=0.0, max_it=3) == 3
    assert np.array_equal(x_in, x0[perm])


def test_host_gs_sweeps_rejects_bad_shapes():
    A = sp.identity(4, format="csr")
    with pytest.raises(ValueError, match="shapes"):
        tord.host_gs_sweeps(A, np.ones(3), np.zeros(4))


ILU_CASES = [(3, 4, "envelope"), (3, 4, "fe"), (2, 4, "envelope"), (2, 8, "envelope"), (2, 16, "envelope")]


@pytest.mark.parametrize("dim,n,pattern", ILU_CASES, ids=[f"{d}d-{n}-{p}" for d, n, p in ILU_CASES])
def test_ilu_case_matches_the_csv_and_jax(dim, n, pattern):
    pub = _published()
    quad = dim == 2
    for o in study.ORDERINGS:
        got = study.ilu_case(n, dim, o, pattern, quad_or_hex=quad, device="cpu")
        key = (dim, n, "gmres+ilu0", o, "envelope==fe" if quad else pattern)
        if key in pub:
            assert got == pub[key], (key, got)
        else:  # cell-rcm-parity: newer than the CSV
            assert got == jstudy.ilu_case(n, dim, o, pattern, quad_or_hex=quad), (key, got)


@pytest.mark.parametrize("n", [4, 8])
def test_ngs_case_matches_the_csv_and_jax(n):
    pub = _published()
    for o in study.ORDERINGS:
        for stol, crit in ((1e-8, "rtol+stol"), (0.0, "rtol-only")):
            got = study.ngs_case(n, 2, o, stol=stol, device="cpu")
            key = (2, n, "pointwise-gs", o, f"criterion={crit}")
            ref = pub[key] if key in pub else jstudy.ngs_case(n, 2, o, stol=stol)
            assert got == ref, (key, got)


def test_ngs_coloring_cases_match_the_csv_and_jax():
    pub = {(int(r["N"]), r["variant"]): r for r in _csv(COLORING)}
    for n in (4, 8):
        for weight in ("drand48", "drand48+deg"):
            for pattern in ("full", "values"):
                its, nc = study.ngs_coloring_case(n, weight, pattern, device="cpu")
                row = pub[(n, f"colored:{weight}/{pattern}")]
                assert (its, nc) == (int(row["its"]), int(row["ncolors"]))
                if n == 4:
                    assert (its, nc) == jstudy.ngs_coloring_case(n, weight, pattern)
        assert study.ngs_parity_case(n, device="cpu") == (int(pub[(n, "colored:parity-pinned")]["its"]),
                                                          int(pub[(n, "colored:parity-pinned")]["ncolors"]))


def test_studies_write_the_csv_schemas(tmp_path):
    rows = study.run_ngs_coloring_study([4, 8], out=tmp_path / "ngs_coloring.csv", device="cpu")
    written = _csv(tmp_path / "ngs_coloring.csv")
    pub = _csv(COLORING)
    assert list(written[0]) == list(pub[0])
    assert written == [r for r in pub if int(r["N"]) in (4, 8)]
    assert len(rows) == 12
    rows = study.run_study([4], [4], [4], out=tmp_path / "ordering.csv", device="cpu")
    written = _csv(tmp_path / "ordering.csv")
    assert list(written[0]) == list(_csv(SENSITIVITY)[0])
    assert len(written) == len(rows) == 10 + 5 + 10
    pub = _published()
    for r in written:
        key = (int(r["dim"]), int(r["N"]), r["algorithm"], r["ordering"], r["pattern"])
        if key in pub:
            assert int(r["its"]) == pub[key]


def test_main_writes_the_coloring_study(tmp_path):
    study.main(["--ngs-coloring", "--fast", "--out", str(tmp_path / "c.csv"), "--device", "cpu"])
    assert len(_csv(tmp_path / "c.csv")) == 18
