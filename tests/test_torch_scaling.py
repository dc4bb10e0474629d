"""The port's scaling harness (``experiments/scaling.py``) in worlds of one
and two gloo ranks on the CPU against the JAX package's CSV schema, the
multi-process runtime's environment contract (``parallel/distributed.py``)
and the multihost dry run (``tools/dryrun.py``)."""

import csv
import re

import pytest

from perphil_tpu.experiments.scaling import ScalingRow as JScalingRow

from perphil_tpu_torch.experiments.iterative_bench import Approach
from perphil_tpu_torch.experiments.scaling import ScalingRow, _halo_bytes, _weak_size, run_scaling, save_scaling_csv
from perphil_tpu_torch.parallel import distributed
from perphil_tpu_torch.tools.dryrun import dryrun_multihost, dryrun_size, mesh_axes

ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "PERPHIL_NUM_PROCESSES", "PERPHIL_PROCESS_ID",
       "PERPHIL_COORDINATOR")


@pytest.fixture(scope="module")
def rows():
    return run_scaling(modes=("strong", "weak"), device_counts=(1, 2), base_n=8, dim=2, repeats=1, device="cpu")


def test_rows_follow_the_jax_schema(rows, tmp_path):
    """Every row has the JAX package's columns, in its order; the CSV
    round-trips."""
    assert list(ScalingRow.__dataclass_fields__) == list(JScalingRow.__dataclass_fields__)
    assert len(rows) == 2 * 2 * 2  # approaches x modes x rank counts
    path = tmp_path / "scaling.csv"
    save_scaling_csv(rows, path)
    with open(path, newline="") as f:
        read = list(csv.DictReader(f))
    assert [list(r) for r in read] == [list(JScalingRow.__dataclass_fields__)] * len(rows)
    assert [int(r["iterations"]) for r in read] == [r.iterations for r in rows]


@pytest.mark.parametrize("approach", [Approach.SS_GMRES.value, Approach.GMRES_ILU.value])
def test_rows_on_gloo_ranks(rows, approach):
    """Iteration parity with the single-device solve at every rank count,
    CPU provenance with no speedup or efficiency, the weak mode's growth,
    the halo bytes of native f64 planes and the counted collectives."""
    mine = [r for r in rows if r.approach == approach]
    for r in mine:
        assert r.iteration_parity and r.iterations == r.its_single_device > 0
        assert r.platform == "cpu" and r.measurement_class == "cpu-gloo-validation"
        assert r.speedup == "" and r.efficiency == "" and r.time_s > 0
        assert r.N == (8 if r.mode == "strong" else _weak_size(8, r.devices, 2))
        assert r.mesh_axes == str(r.devices) and r.dofs == 2 * (r.N + 1) ** 2
        nodes = r.N + 1
        padded_y = nodes + (-nodes) % r.devices
        assert r.halo_bytes_per_exchange == (0 if r.devices == 1 else 2 * nodes * 2 * 8)
        assert r.halo_bytes_per_exchange == _halo_bytes((padded_y, nodes), (r.devices,))
        # one plane exchange a matvec; an iteration: the matvec's exchange,
        # two all-reduces (the Hessenberg column, the norm), the gathered
        # preconditioner's all-gather
        assert r.matvec_collectives == "matvec:cp=1;ar=0;ag=0|iteration:cp=1;ar=2;ag=1"
        assert re.fullmatch(r"matvec:cp=\d+;ar=\d+;ag=\d+\|iteration:cp=\d+;ar=\d+;ag=\d+", r.matvec_collectives)


def test_environment_contract(monkeypatch):
    """No variables: a single process, nothing started, False. One of size
    and rank without the other: refused. The backend follows the device."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_from_env() is False and not distributed.is_initialized()
    monkeypatch.setenv("PERPHIL_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="Partial multi-process configuration"):
        distributed.initialize_from_env(device="cpu")
    monkeypatch.delenv("PERPHIL_NUM_PROCESSES")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="Partial multi-process configuration"):
        distributed.initialize_from_env(device="cpu")
    import torch

    assert distributed.backend_for(torch.device("cpu")) == "gloo"
    assert distributed.backend_for(torch.device("cuda", 0)) == "nccl"
    assert not distributed.is_initialized()


def test_dryrun_meshes():
    """The JAX dry run's mesh and size: 8 ranks as (4, 2) at N=7."""
    assert mesh_axes(8) == [4, 2] and mesh_axes(4) == [2, 2] and mesh_axes(2) == [2] and mesh_axes(6) == [3, 2]
    assert dryrun_size([4, 2]) == 7 and dryrun_size([1, 1]) == 7 and dryrun_size([8]) == 15


def test_multihost_dry_run(capsys):
    """Two interpreters through the environment contract solve what one
    process solves (the count and the solution's norm)."""
    result = dryrun_multihost(2, device="cpu")
    assert result["its"] == 4
    assert "dryrun_multihost: 2 processes" in capsys.readouterr().out
