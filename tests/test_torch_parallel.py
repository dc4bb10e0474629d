"""The port's sharded solves (``perphil_tpu_torch/parallel``) in one world of
four gloo ranks on the CPU, held against the port's single-device solves,
the JAX package's dry-run record and the JAX package's sharded solves on its
virtual devices (``tests/conftest.py``): the six paths of the multichip dry
run on (2, 2) meshes, the 2D cases of ``tests/test_sharding.py`` on a
("y", "x") mesh, the refusals, and the gloo halo matvec on (4,) slabs and
(2, 2) pencils. The world runs once for the module (its ranks are processes
of ``perphil_tpu_torch/tools/dryrun.py``), beside the JAX side in this
process."""

import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
from perphil_tpu.forms import create_function_spaces as jspaces, mixed_space as jmixed
from perphil_tpu.forms.spaces import FunctionSpace as JFunctionSpace
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC, DPPOperator as JOp
from perphil_tpu.parallel.halo import shard_map_stacked_matvec
from perphil_tpu.parallel.sharding import (
    device_mesh as jdevice_mesh,
    sharded_solve_dpp as jsharded,
    sharded_solve_dpp_nonlinear as jsharded_nonlinear,
)
from perphil_tpu.utils import manufactured_solutions as jms

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops.assembly import dpp_stencils
from perphil_tpu_torch.ops.fused_apply import fused_dpp_apply_plain
from perphil_tpu_torch.solvers import solve_dpp
from perphil_tpu_torch.tools.dryrun import TOLERANCES, _manufactured_bcs, _space, spawn_world

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
AXES = [2, 2]
SIX = ["plain-gmres-3d", "gmres-ilu-3d", "fieldsplit-gmres-3d", "direct-fastdiag-3d", "picard-ngs-2d",
       "degree2-fieldsplit-2d"]
FS_Q2 = {"ksp_type": "gmres", "pc_type": "fieldsplit", "ksp_rtol": 1e-8}
SIX_JAX = {  # the JAX dry run's paths: (element, n, degree, options, nonlinear)
    "plain-gmres-3d": ("hex", 7, 1, {**sp.GMRES_PARAMS, **sp.PLAIN_GMRES_PARAMS}, False),
    "gmres-ilu-3d": ("hex", 7, 1, sp.GMRES_ILU_PARAMS, False),
    "fieldsplit-gmres-3d": ("hex", 7, 1, {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}, False),
    "direct-fastdiag-3d": ("hex", 7, 1, sp.LINEAR_SOLVER_PARAMS, False),
    "picard-ngs-2d": ("quad", 7, 1, sp.PICARD_LU_SOLVER_PARAMS, True),
    "degree2-fieldsplit-2d": ("quad", 8, 2, FS_Q2, False),
}
# the 2D cases of tests/test_sharding.py, on a (2, 2) ("y", "x") mesh:
# id -> (element, n, degree, options, tolerance on the fields)
CASES_2D = {
    "plain-gmres-2d": ("quad", 15, 1, sp.PLAIN_GMRES_PARAMS, 1e-6),
    "fieldsplit-lu-2d": ("quad", 15, 1, {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}, 1e-6),
    "degree2-direct": ("quad", 8, 2, {"ksp_type": "preonly", "pc_type": "lu"}, 1e-10),
    "degree2-fieldsplit": ("quad", 8, 2, FS_Q2, 1e-10),
    "p2-jacobi": ("triangle", 8, 2, {"ksp_type": "gmres", "pc_type": "jacobi", "ksp_rtol": 1e-8}, 1e-12),
    "p2-none": ("triangle", 8, 2, {"ksp_type": "gmres", "pc_type": "none", "ksp_rtol": 1e-8}, 1e-12),
    "gmres-ilu-2d": ("quad", 15, 1, sp.GMRES_ILU_PARAMS, 1e-6),
}
# what the sharded entries refuse: id -> (element, n, degree, options,
# nonlinear, error, the substance of the JAX package's message)
REFUSALS = {
    "p2-preonly": ("triangle", 8, 2, {"ksp_type": "preonly", "pc_type": "lu"}, False, "NotImplementedError",
                   "sharded P2 simplex"),
    "picard-not-divisible": ("quad", 8, 1, sp.PICARD_LU_SOLVER_PARAMS, True, "NotImplementedError",
                             "device-divisible"),
    "rcm-padded": ("quad", 8, 1, {**sp.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm"}, False,
                   "ValueError", "not available under sharding padding"),
    "degree2-picard": ("quad", 8, 2, sp.PICARD_LU_SOLVER_PARAMS, True, "NotImplementedError", "degree-1"),
}
# the gloo halo matvec: id -> (element, cells, axes, names)
HALO = {
    "quad-slabs": ("quad", (15, 15), [4], ("y",)),
    "hex-slabs": ("hex", (7, 7, 7), [4], ("z",)),
    "quad-pencils": ("quad", (15, 15), [2, 2], ("y", "x")),
    "hex-pencils": ("hex", (7, 7, 7), [2, 2], ("z", "y")),
    "tet-pencils-padded": ("tet", (5, 6, 4), [2, 2], ("z", "y")),
    "triangle-slabs-padded": ("triangle", (9, 8), [4], ("y",)),
}
JAX_HALO = "quad-pencils"  # the case held to the JAX package's shard_map matvec as well
PARAMS = dict(k1=1.3, beta=0.8, mu=1.1)


def _case(element, n, degree, options, nonlinear=False, axes=AXES, names=("y", "x")):
    return dict(element=element, n=n, degree=degree, options=options, axes=axes, names=names, nonlinear=nonlinear)


def _jax_space(element, n, degree):
    if element in ("quad", "triangle"):
        mesh = jmesh.create_mesh(n, n, quadrilateral=element == "quad")
        exact = jms.exact_expressions
    else:
        mesh = jmesh.create_cube_mesh(n, n, n, hexahedral=element == "hex")
        exact = jms.exact_expressions_3d
    W = jmixed(JFunctionSpace(mesh, degree=degree)) if degree > 1 else jmixed(jspaces(mesh)[1])
    _, p1, _, p2 = exact(W.mesh, JParams())
    return W, [JBC(W.sub(0), p1), JBC(W.sub(1), p2)]


def _jax_sharded(element, n, degree, options, nonlinear, names):
    W, bcs = _jax_space(element, n, degree)
    dm = jdevice_mesh(AXES, axis_names=names)
    sol = (jsharded_nonlinear if nonlinear else jsharded)(W, JParams(), bcs, dm, solver_parameters=options)
    return sol.iteration_number, [np.asarray(d) for d in sol.solution.data]


def _halo_input(element, cells, seed):
    shape = tuple(n + 1 for n in reversed(cells))
    return np.random.default_rng(seed).standard_normal((2,) + shape)


def _jax_halo(key):
    """The JAX package's explicit-halo matvec on the case's input (its
    shard_map program compiles for tens of seconds a case on the CPU: one
    case, two split axes)."""
    element, cells, axes, names = HALO[key]
    op = JOp(jmixed(jspaces(jmesh.StructuredMesh(cells=cells, element=element))[1]), JParams(**PARAMS))
    x = _halo_input(element, cells, list(HALO).index(key))
    return np.asarray(shard_map_stacked_matvec(op, jdevice_mesh(axes, axis_names=names))(jnp.asarray(x)))


@pytest.fixture(scope="module")
def runs():
    """Every rank's results of the world, and the JAX side computed
    meanwhile: the six paths and the 2D cases sharded, the halo matvecs."""
    tasks = [
        ["multichip", {"axes": AXES, "fields": True, "check": False}],
        ["sharded_cases", {"cases": [_case(*c[:4]) for c in CASES_2D.values()]
                           + [_case(*c[:5]) for c in REFUSALS.values()]}],
        ["halo_matvecs", {"cases": [dict(element=e, cells=c, axes=a, names=nm, seed=i, params=PARAMS)
                                    for i, (e, c, a, nm) in enumerate(HALO.values())]}],
    ]
    jobs = {("six", k): (e, n, d, o, nl, ("y", "x") if e == "quad" else ("z", "y"))
            for k, (e, n, d, o, nl) in SIX_JAX.items()}
    jobs.update({("2d", k): (e, n, d, o, False, ("y", "x")) for k, (e, n, d, o, _) in CASES_2D.items()})
    jobs[("halo", JAX_HALO)] = (JAX_HALO,)
    with ThreadPoolExecutor(1) as pool, ThreadPoolExecutor(4) as jax_pool:
        world = pool.submit(spawn_world, WORLD, "batch", {"device": "cpu", "tasks": tasks}, 600.0)
        # the JAX solves are compile-bound: their compiles overlap in threads
        done = dict(zip(jobs, jax_pool.map(
            lambda job: _jax_halo(*job) if len(job) == 1 else _jax_sharded(*job), jobs.values())))
        jax_six = {k: v for (kind, k), v in done.items() if kind == "six"}
        jax_2d = {k: v for (kind, k), v in done.items() if kind == "2d"}
        jax_halo = {JAX_HALO: done[("halo", JAX_HALO)]}
        results = world.result()
    return results, jax_six, jax_2d, jax_halo


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _published_counts():
    tail = json.loads((REPO / "MULTICHIP_r05.json").read_text())["tail"]
    return {k: int(v) for k, v in re.findall(r"dryrun_multichip\[(.*?)\]: its=(\d+)", tail)}


@pytest.mark.parametrize("label", SIX)
def test_dryrun_paths_match_single_device_and_jax(runs, label):
    """Each dry-run path on (2, 2): the count of the port's single-device
    solve, of the JAX dry run's record and of the JAX sharded solve; the
    fields within the JAX dry run's tolerances of the single-device solve
    and of the JAX sharded solve."""
    results, jax_six, _, _ = runs
    rec = {r["label"]: r for r in results[0][0]}[label]
    jits, jfields = jax_six[label]
    assert rec["its"] == rec["single_its"] == _published_counts()[label] == jits
    tol = TOLERANCES.get(label, 1e-9)
    assert rec["rel_diff"] < tol and np.isfinite(rec["residual"])
    for a, b in zip(rec["fields"], jfields):
        assert a.shape == b.shape and _rel(a, b) < tol


def test_ranks_agree_and_halo_equals_gathered(runs):
    """Every rank returns the same counts, residuals and solutions, and
    the halo matvec equals K1 on the gathered vector exactly."""
    results = runs[0]
    for rank in results[1:]:
        for a, b in zip(rank[0][:-1], results[0][0][:-1]):
            assert a["its"] == b["its"] and a["residual"] == b["residual"]
            assert all(np.array_equal(x, y) for x, y in zip(a["fields"], b["fields"]))
    for rank in results:
        assert rank[0][-1]["label"] == "halo" and rank[0][-1]["max_abs_diff"] == 0.0
        assert rank[0][-1]["mesh"] == {"z": 2, "y": 2}


@pytest.mark.parametrize("key", list(CASES_2D))
def test_jax_sharding_cases_2d(runs, key):
    """The 2D cases of the JAX sharding tests: the count of the port's
    single-device solve and of the JAX sharded solve, the fields cropped
    back and within the tests' tolerances."""
    results, _, jax_2d, _ = runs
    element, n, degree, options, tol = CASES_2D[key]
    got = results[0][1][list(CASES_2D).index(key)]
    W = _space(element, n, degree, "cpu")
    single = solve_dpp(W, DPPParameters(), _manufactured_bcs(W), solver_parameters=options)
    jits, jfields = jax_2d[key]
    assert got["its"] == single.iteration_number == jits
    for a, b, c in zip(got["fields"], single.solution.data, jfields):
        assert a.shape == tuple(b.shape) == c.shape
        assert _rel(a, b.numpy()) < tol and _rel(a, c) < max(tol, 1e-9)


@pytest.mark.parametrize("key", list(REFUSALS))
def test_refusals(runs, key):
    """P2 preonly, a non-divisible Picard grid, the ordering-parity ILU
    under padding and a degree-2 Picard solve are refused with the
    substance of the JAX package's messages, on every rank."""
    results = runs[0]
    *_, error, message = REFUSALS[key]
    for rank in results:
        got = rank[1][len(CASES_2D) + list(REFUSALS).index(key)]
        assert got.get("error") == error and message in got["message"], got


@pytest.mark.parametrize("key", list(HALO))
def test_gloo_halo_matvec(runs, key):
    """The gloo halo matvec and lift, gathered, equal K1's twin on the whole
    grid bit for bit (phantom rows: identity), and the matvec equals the
    JAX package's shard_map matvec to 1e-13 relative; one exchange a split
    axis an apply."""
    results, _, _, jax_halo = runs
    element, cells, axes, names = HALO[key]
    i = list(HALO).index(key)
    x = _halo_input(element, cells, i)
    state = from_numpy_state(PARAMS, cells, element, x[0], x[1], device="cpu")
    S = dpp_stencils(state.mesh, state.params)
    crop = (slice(None),) + tuple(slice(0, n) for n in x.shape[1:])
    for rank in results:
        got = rank[2][i]
        assert got["collectives"]["exchange"] == 2 * len(axes)
        for mode in ("matvec", "lift"):
            want = torch.stack(fused_dpp_apply_plain(torch.as_tensor(x[0]), torch.as_tensor(x[1]), *S, mode=mode))
            assert np.array_equal(got[mode][crop], want.numpy())
            if any(got["padding"]):  # phantoms are identity rows on zero data
                full = np.zeros_like(got[mode])
                full[crop] = want.numpy()
                assert np.array_equal(got[mode], full)
    if key in jax_halo:
        assert _rel(results[0][2][i]["matvec"], jax_halo[key]) <= 1e-13
