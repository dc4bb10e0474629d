"""The port's 3D profiling driver on the CPU at hex nx=4, held to the JAX
package's ``run_perf_once_3d`` row for row, as ``test_torch_profiling_3d.py``
holds the tet rows (its ``check_row`` states the bounds)."""

import csv
from pathlib import Path

import pytest
from test_torch_profiling_3d import check_row, jax_rows_3d

import perphil_tpu_torch.experiments.profiling_3d as prof3
from perphil_tpu_torch.experiments.iterative_bench import Approach

RESULTS = Path(__file__).resolve().parent.parent / "notebooks/results-conforming-3d/petsc_profiling"
APPROACHES = list(Approach)


@pytest.fixture(scope="module")
def rows():
    port = {ap: prof3.run_perf_once_3d(4, ap, repeats=1, hexahedral=True, device="cpu") for ap in APPROACHES}
    return port, jax_rows_3d(True, APPROACHES)


@pytest.mark.parametrize("approach", APPROACHES, ids=[a.name.lower() for a in APPROACHES])
def test_run_perf_once_hex_matches_jax(approach, rows):
    with (RESULTS / "petsc_perf_breakdown_3d.csv").open() as f:
        header = next(csv.reader(f))
    port, jax = rows
    check_row(approach, port[approach], jax[approach], header, "hex")
