"""The port's tooling on the CPU (``utils/marginal.py``, ``roofline.py``,
``checkpoint.py`` and ``plotting.py``):

- ``marginal``: the JAX package's tests of the chained-marginal protocol on
  a simulated clock (the fixed cost cancels, K grows to the window, a
  non-positive or jitter-scale marginal raises), and ``fn_chain_maker`` /
  ``keepalive_feedback`` over torch tensors;
- ``roofline``: the H100's published peaks, ``analyze`` against them, an
  unknown card raises;
- ``checkpoint``: scalar, mixed and row round trips, and files written by
  either package load in the other with the arrays bit for bit;
- ``plotting`` (matplotlib's Agg backend, here only);
- no module of the port imports matplotlib or pandas when imported (the
  card's machine has neither), nor JAX or the JAX package.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import perphil_tpu.utils.checkpoint as jckpt  # noqa: E402
from perphil_tpu.forms import Function as JFunction  # noqa: E402
from perphil_tpu.forms import create_function_spaces as jspaces  # noqa: E402
from perphil_tpu.forms import mixed_space as jmixed  # noqa: E402
from perphil_tpu.mesh import create_mesh as jmesh  # noqa: E402

import perphil_tpu_torch.utils.checkpoint as ckpt  # noqa: E402
from perphil_tpu_torch.forms import Function, create_function_spaces, mixed_space  # noqa: E402
from perphil_tpu_torch.mesh import create_cube_mesh, create_mesh  # noqa: E402
from perphil_tpu_torch.utils import marginal as marginal_mod  # noqa: E402
from perphil_tpu_torch.utils import roofline  # noqa: E402
from perphil_tpu_torch.utils.marginal import (  # noqa: E402
    MarginalTimingError,
    chained_marginal,
    fn_chain_maker,
    keepalive_feedback,
)
from perphil_tpu_torch.utils.plotting import plot_2d_mesh, plot_scalar_field, plot_vector_field  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

# -- marginal --------------------------------------------------------------


class _SimClock:
    """A deterministic stand-in for the ``time`` module inside marginal.py:
    chains advance it by their modelled cost."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


@pytest.fixture
def sim_clock(monkeypatch):
    clock = _SimClock()
    monkeypatch.setattr(marginal_mod, "time", clock)
    return clock


def _fake_chain_maker(clock, fixed: float, per_trip: float):
    def make(length):
        def chain():
            clock.advance(fixed + length * per_trip)
            return 0.0

        return chain

    return make


def test_marginal_cancels_a_fixed_cost(sim_clock):
    per = 2e-4
    t = chained_marginal(_fake_chain_maker(sim_clock, 0.02, per), (), 4, window=0.02, best_of=1)
    assert t == pytest.approx(per, rel=1e-9)


def test_k_grows_until_window_reached(sim_clock):
    calls = []

    def make(length):
        calls.append(length)

        def chain():
            sim_clock.advance(0.001 + length * 1e-5)
            return 0.0

        return chain

    t = chained_marginal(make, (), 2, window=0.04, best_of=1)
    assert max(calls) >= 0.8 * 0.04 / 1e-5 / 2
    assert t == pytest.approx(1e-5, rel=1e-9)


def test_nonpositive_marginal_raises_not_clamps(sim_clock):
    with pytest.raises(MarginalTimingError):
        chained_marginal(_fake_chain_maker(sim_clock, 0.003, 0.0), (), 1, window=0.05, best_of=1, k_max=4)


def test_unreachable_window_raises(sim_clock):
    with pytest.raises(MarginalTimingError, match="unreachable"):
        chained_marginal(_fake_chain_maker(sim_clock, 0.0, 1e-9), (), 1, window=0.05, best_of=1, k_max=64)


def test_fn_chain_maker_end_to_end_cpu():
    def f(x):
        return x @ x * 0.999

    x = torch.eye(16, dtype=torch.float32)
    t = chained_marginal(fn_chain_maker(f), (x,), 8, window=0.01, best_of=2)
    assert 0 < t < 0.01


def test_keepalive_feedback_preserves_structure():
    out = {"b": torch.zeros((2, 2)), "a": torch.ones((3,))}
    carry = (torch.ones((3,)), torch.full((2, 2), 2.0))
    new = keepalive_feedback(out, carry)
    assert isinstance(new, tuple) and len(new) == 2
    assert new[0].shape == (3,) and new[1].shape == (2, 2)
    assert torch.allclose(new[0], carry[0]) and torch.allclose(new[1], carry[1])
    nested = keepalive_feedback(torch.ones(3), {"x": [torch.ones(3)], "y": torch.zeros(1)})
    assert set(nested) == {"x", "y"} and isinstance(nested["x"], list)
    with pytest.raises(TypeError):
        keepalive_feedback(1.0, (torch.ones(1),))


# -- roofline ----------------------------------------------------------------


def test_roofline_h100_peaks():
    peaks, key = roofline.device_peaks("NVIDIA H100 80GB HBM3")
    assert key == "H100 80GB HBM3"
    assert (peaks["hbm_bytes_per_s"], peaks["f64"], peaks["f32"]) == (3.35e12, 34e12, 67e12)
    assert (peaks["f64_tc"], peaks["tf32_tc"], peaks["bf16_tc"], peaks["fp8_tc"]) == (67e12, 495e12, 989e12, 1979e12)


def test_roofline_analyze_bytes_bound():
    # 128^3 K1 f64 matvec: 2 fields in, 2 out (67 MB), ~1e8 flops, in 0.0444 ms
    p = roofline.analyze("k1", 0.0444e-3, 1.1e8, 68.7e6, device="NVIDIA H100 80GB HBM3")
    assert p.bound == "memory" and p.device == "H100 80GB HBM3" and p.arithmetic == "f64"
    assert p.hbm_frac == pytest.approx(68.7e6 / 0.0444e-3 / 3.35e12)
    assert p.bound_seconds == pytest.approx(68.7e6 / 3.35e12) and p.hbm_frac <= 1.0
    assert p.intensity == pytest.approx(1.1e8 / 68.7e6)
    c = roofline.analyze("gemm", 1e-3, 3e10, 1e6, arithmetic="f64", device="NVIDIA H100 80GB HBM3")
    assert c.bound == "compute" and c.peak_frac == pytest.approx(3e13 / 34e12)
    assert set(p.as_dict()) >= {"name", "seconds", "gflops", "gbs", "hbm_frac", "bound"}


def test_roofline_unknown_card_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.device_peaks("Some Other GPU")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            roofline.device_peaks()


# -- checkpoint --------------------------------------------------------------


def test_scalar_roundtrip(tmp_path):
    mesh = create_mesh(4, 4)
    _, V = create_function_spaces(mesh, device="cpu")
    f = Function(V, torch.tensor(np.random.default_rng(0).standard_normal(V.dof_shape)))
    ckpt.save_function(tmp_path / "f", f)
    g = ckpt.load_function(tmp_path / "f", device="cpu")
    assert g.space.mesh == mesh and g.space.device == torch.device("cpu")
    assert torch.equal(g.data, f.data)


def test_mixed_and_vector_roundtrip(tmp_path):
    mesh = create_mesh(3, 5, quadrilateral=False)
    U, V = create_function_spaces(mesh, device="cpu")
    rng = np.random.default_rng(1)
    w = Function(mixed_space(V), tuple(rng.standard_normal(V.dof_shape) for _ in range(2)))
    ckpt.save_function(tmp_path / "w.npz", w)
    w2 = ckpt.load_function(tmp_path / "w.npz", device="cpu")
    assert w2.space.num_sub_spaces() == 2 and w2.space.mesh == mesh
    assert all(torch.equal(a, b) for a, b in zip(w2.data, w.data))
    u = Function(U, rng.standard_normal(U.dof_shape))
    ckpt.save_function(tmp_path / "u.npz", u)
    u2 = ckpt.load_function(tmp_path / "u.npz", device="cpu")
    assert u2.space.value_shape == (2,) and torch.equal(u2.data, u.data)


def test_checkpoint_files_cross_packages(tmp_path):
    """A file either package writes loads in the other, bit for bit."""
    rng = np.random.default_rng(2)
    jm = jmesh(4, 3)
    _, jV = jspaces(jm)
    fields = tuple(rng.standard_normal(jV.dof_shape) for _ in range(2))
    jckpt.save_function(tmp_path / "jax.npz", JFunction(jmixed(jV), fields))
    got = ckpt.load_function(tmp_path / "jax.npz", device="cpu")
    assert got.space.mesh.cells == jm.cells and got.space.mesh.element == jm.element
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(got.data, fields))

    mesh = create_mesh(4, 3)
    _, V = create_function_spaces(mesh, device="cpu")
    ckpt.save_function(tmp_path / "port.npz", Function(mixed_space(V), fields))
    back = jckpt.load_function(tmp_path / "port.npz")
    assert back.space.mesh.cells == mesh.cells
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(back.data, fields))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert json.loads(str(a["__meta__"])) == json.loads(str(b["__meta__"]))
        assert sorted(a.files) == sorted(b.files)


def test_rows_roundtrip_and_default_device(tmp_path):
    rows = [{"N": 4, "it": 10, "e": 1.5}]
    ckpt.save_rows(tmp_path / "rows.json", rows)
    assert ckpt.load_rows(tmp_path / "rows.json") == rows
    assert ckpt.load_rows(tmp_path / "missing.json") == []
    _, V = create_function_spaces(create_mesh(2, 2), device="cpu")
    ckpt.save_function(tmp_path / "f.npz", Function(V))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.load_function(tmp_path / "f.npz")


# -- plotting ----------------------------------------------------------------


def test_plot_scalar_and_vector_fields():
    mesh = create_mesh(4, 4)
    U, V = create_function_spaces(mesh, device="cpu")
    X, Y = mesh.coordinates()
    ax = plot_scalar_field(Function(V, X * Y), title="p")
    assert ax.get_title() == "p"
    u = Function(U, np.stack([Y, -X], axis=-1))
    assert plot_vector_field(u, stride=2) is not None


def test_plot_mesh_quad_and_tri_and_3d_rejected():
    for quad in (True, False):
        ax = plot_2d_mesh(create_mesh(3, 3, quadrilateral=quad), title="mesh")
        assert ax.get_title() == "mesh"
    with pytest.raises(ValueError):
        plot_2d_mesh(create_cube_mesh(2, 2, 2))


# -- independence ------------------------------------------------------------


def test_new_modules_import_no_jax_pandas_or_matplotlib():
    code = (
        "import sys, importlib\n"
        "for m in ('perphil_tpu_torch.experiments.profiling', 'perphil_tpu_torch.experiments.profiling_3d',\n"
        "          'perphil_tpu_torch.experiments.ordering_study', 'perphil_tpu_torch.utils.marginal',\n"
        "          'perphil_tpu_torch.utils.roofline', 'perphil_tpu_torch.utils.checkpoint',\n"
        "          'perphil_tpu_torch.utils.plotting', 'perphil_tpu_torch.ops.ordering'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'perphil_tpu', 'pandas', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
