"""The port's sharded solves (``perphil_tpu_torch/parallel``) in one world of
four gloo ranks on the CPU, held against the port's single-device solves,
the JAX package's dry-run record and the JAX package's sharded solves on its
virtual devices (``tests/conftest.py``): the six paths of the multichip dry
run on (2, 2) meshes, the 2D cases of ``tests/test_sharding.py`` on a
("y", "x") mesh, the refusals, the gloo halo matvec on (4,) slabs and
(2, 2) pencils, the blocked paths (direct, Jacobi, fieldsplit, Picard)
on (2, 2) pencils and (4,) slabs, and a hex Q2 fieldsplit on (2, 2) ("z",
"y") pencils, each with the collectives it issued: one all-gather a solve
where every part keeps its blocks (the degree-p parts too), more where ILU
is gathered. The world runs once for the module (its ranks
are processes of ``perphil_tpu_torch/tools/dryrun.py``), beside the JAX side
in this process."""

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
from perphil_tpu_torch.solvers import solve_dpp, solve_dpp_nonlinear
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
# the 3D degree-p case, on (2, 2) ("z", "y") pencils of the phantom-padded
# 15^3 lattice: id -> (element, n, degree, options, tolerance on the fields)
CASES_3D = {"degree2-fieldsplit-hex": ("hex", 7, 2, FS_Q2, 1e-10)}
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
# the blocked paths: id -> (element, n, options, nonlinear), on each mesh of
# BLOCKED_MESHES (names ("y", "x") / ("y",) in 2D, ("z", "y") / ("z",) in 3D)
BLOCKED = {
    "hex-direct": ("hex", 7, sp.LINEAR_SOLVER_PARAMS, False),
    "hex-direct-fastdiag": ("hex", 7, sp.TPU_DIRECT_PARAMS, False),
    "quad-direct": ("quad", 15, sp.LINEAR_SOLVER_PARAMS, False),
    "tet-direct": ("tet", 7, sp.LINEAR_SOLVER_PARAMS, False),
    "triangle-direct": ("triangle", 15, sp.LINEAR_SOLVER_PARAMS, False),
    "gmres-jacobi": ("quad", 15, sp.GMRES_JACOBI_PARAMS, False),
    "fieldsplit-lu-multiplicative": ("quad", 15, {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}, False),
    "fieldsplit-lu-additive": ("quad", 15, {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS,
                                            "pc_fieldsplit_type": "additive"}, False),
    "picard-ngs-7": ("quad", 7, sp.PICARD_LU_SOLVER_PARAMS, True),
    "picard-ngs-15": ("quad", 15, sp.PICARD_LU_SOLVER_PARAMS, True),
    "picard-block-gs": ("quad", 15, {**sp.PICARD_LU_SOLVER_PARAMS, "snes_type": "block_gs"}, True),
    "picard-nrichardson": ("quad", 15, sp.RICHARDSON_SOLVER_PARAMS, True),
}
BLOCKED_MESHES = {"pencils": [2, 2], "slabs": [4]}
BLOCKED_TOL, PICARD_TOL = 1e-12, 1e-10
# the six paths and the 2D cases whose parts stay gathered: ILU
GATHERED = {"gmres-ilu-3d", "gmres-ilu-2d"}
# blocks thinner than the operator's halo (Q3 on 2 cells: a 7-node lattice,
# padded to 8, on 4 slabs of 2 planes; Q3 reads 3): the degree-p parts run
# gathered, as the JAX package's partitioner runs them
THIN = {
    "q3-slabs-jacobi": ("quad", 2, 3, {"ksp_type": "gmres", "pc_type": "jacobi", "ksp_rtol": 1e-10}),
    "q3-slabs-direct": ("quad", 2, 3, {"ksp_type": "preonly", "pc_type": "lu"}),
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


def _names(element, axes):
    return (("y", "x") if element in ("quad", "triangle") else ("z", "y"))[:len(axes)]


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


def _jax_sharded(element, n, degree, options, nonlinear, names, axes=AXES):
    W, bcs = _jax_space(element, n, degree)
    dm = jdevice_mesh(axes, axis_names=names)
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
        *[["sharded_cases", {"cases": [_case(e, n, 1, o, nl, axes, _names(e, axes))
                                       for e, n, o, nl in BLOCKED.values()]}] for axes in BLOCKED_MESHES.values()],
        ["sharded_cases", {"cases": [_case(*c[:4], names=("z", "y")) for c in CASES_3D.values()]}],
        ["sharded_cases", {"cases": [_case(*c, axes=[WORLD], names=("y",)) for c in THIN.values()]}],
    ]
    jobs = {("six", k): (e, n, d, o, nl, ("y", "x") if e == "quad" else ("z", "y"))
            for k, (e, n, d, o, nl) in SIX_JAX.items()}
    jobs.update({("2d", k): (e, n, d, o, False, ("y", "x")) for k, (e, n, d, o, _) in CASES_2D.items()})
    jobs.update({("3d", k): (e, n, d, o, False, ("z", "y")) for k, (e, n, d, o, _) in CASES_3D.items()})
    jobs.update({(mesh, k): (e, n, 1, o, nl, _names(e, axes), axes) for mesh, axes in BLOCKED_MESHES.items()
                 for k, (e, n, o, nl) in BLOCKED.items()})
    jobs[("halo", JAX_HALO)] = (JAX_HALO,)
    with ThreadPoolExecutor(1) as pool, ThreadPoolExecutor(4) as jax_pool:
        world = pool.submit(spawn_world, WORLD, "batch", {"device": "cpu", "tasks": tasks}, 600.0)
        # the JAX solves are compile-bound: their compiles overlap in threads
        done = dict(zip(jobs, jax_pool.map(
            lambda job: _jax_halo(*job) if len(job) == 1 else _jax_sharded(*job), jobs.values())))
        jax_six = {k: v for (kind, k), v in done.items() if kind == "six"}
        jax_2d = {k: v for (kind, k), v in done.items() if kind in ("2d", "3d")}
        jax_halo = {JAX_HALO: done[("halo", JAX_HALO)]}
        jax_blocked = {(kind, k): v for (kind, k), v in done.items() if kind in BLOCKED_MESHES}
        results = world.result()
    return results, jax_six, jax_2d, jax_halo, jax_blocked


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
    results, jax_six, *_ = runs
    rec = {r["label"]: r for r in results[0][0]}[label]
    jits, jfields = jax_six[label]
    assert rec["its"] == rec["single_its"] == _published_counts()[label] == jits
    gathers = rec["collectives"].get("all_gather", 0)
    assert gathers > 1 if label in GATHERED else gathers == 1, rec["collectives"]
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
    results, _, jax_2d, *_ = runs
    element, n, degree, options, tol = CASES_2D[key]
    got = results[0][1][list(CASES_2D).index(key)]
    gathers = got["collectives"].get("all_gather", 0)
    assert gathers > 1 if key in GATHERED else gathers == 1, got["collectives"]
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
    results, _, _, jax_halo, _ = runs
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


@pytest.mark.parametrize("mesh", list(BLOCKED_MESHES))
@pytest.mark.parametrize("key", list(BLOCKED))
def test_blocked_paths(runs, mesh, key):
    """The parts that keep their blocks, on (2, 2) pencils and (4,) slabs:
    the count of the port's single-device solve and of the JAX package's
    sharded solve, the fields within 1e-12 relative of both (Picard
    1e-10), the same on every rank, and exactly one all-gather a solve (the
    cropped solution's): only planes and transposes cross ranks before it."""
    results, *_, jax_blocked = runs
    element, n, options, nonlinear = BLOCKED[key]
    task = 3 + list(BLOCKED_MESHES).index(mesh)
    got = results[0][task][list(BLOCKED).index(key)]
    W = _space(element, n, 1, "cpu")
    solve = solve_dpp_nonlinear if nonlinear else solve_dpp
    single = solve(W, DPPParameters(), _manufactured_bcs(W), solver_parameters=options)
    jits, jfields = jax_blocked[(mesh, key)]
    assert got["its"] == single.iteration_number == jits
    tol = PICARD_TOL if nonlinear else BLOCKED_TOL
    for a, b, c in zip(got["fields"], single.solution.data, jfields):
        assert a.shape == tuple(b.shape) == c.shape
        assert _rel(a, b.numpy()) <= tol and _rel(a, c) <= tol
    for rank in results[1:]:
        other = rank[task][list(BLOCKED).index(key)]
        assert other["its"] == got["its"] and all(np.array_equal(x, y) for x, y in zip(other["fields"], got["fields"]))
    assert got["collectives"]["all_gather"] == 1, got["collectives"]
    if not nonlinear or options.get("snes_type") != "ngs":
        assert got["collectives"].get("all_to_all", 0) > 0 or options.get("pc_type") == "jacobi"


@pytest.mark.parametrize("key", list(CASES_3D))
def test_degree_p_hex_pencils(runs, key):
    """The hex Q2 fieldsplit on (2, 2) pencils, its operator, fast-diag
    blocks and coupling on each rank's block: the count of the port's
    single-device solve and of the JAX package's sharded solve, the fields
    within 1e-10 relative of both, the same on every rank, and exactly one
    all-gather a solve."""
    results, _, jax_2d, *_ = runs
    element, n, degree, options, tol = CASES_3D[key]
    task = 3 + len(BLOCKED_MESHES)
    got = results[0][task][list(CASES_3D).index(key)]
    assert got["collectives"]["all_gather"] == 1, got["collectives"]
    assert got["collectives"]["all_to_all"] > 0 and got["collectives"]["exchange"] > 0, got["collectives"]
    W = _space(element, n, degree, "cpu")
    single = solve_dpp(W, DPPParameters(), _manufactured_bcs(W), solver_parameters=options)
    jits, jfields = jax_2d[key]
    assert got["its"] == single.iteration_number == jits
    for a, b, c in zip(got["fields"], single.solution.data, jfields):
        assert a.shape == tuple(b.shape) == c.shape
        assert _rel(a, b.numpy()) <= tol and _rel(a, c) <= tol
    for rank in results[1:]:
        other = rank[task][list(CASES_3D).index(key)]
        assert other["its"] == got["its"] and all(np.array_equal(x, y) for x, y in zip(other["fields"], got["fields"]))


@pytest.mark.parametrize("key", list(THIN))
def test_thin_blocks_solve_gathered_on_gloo(runs, key):
    """Q3 on 2 cells on 4 gloo slabs, blocks thinner than the 3 planes the
    operator reads: ``sharded_solve_dpp`` runs the degree-p parts gathered
    (no plane crosses ranks, one all-gather an application and the
    solution's) and lands ``solve_dpp``'s count, the fields within 1e-12,
    the same on every rank."""
    results = runs[0]
    element, n, degree, options = THIN[key]
    task = 4 + len(BLOCKED_MESHES)
    got = results[0][task][list(THIN).index(key)]
    assert "error" not in got, got
    W = _space(element, n, degree, "cpu")
    single = solve_dpp(W, DPPParameters(), _manufactured_bcs(W), solver_parameters=options)
    assert got["its"] == single.iteration_number
    for a, b in zip(got["fields"], single.solution.data):
        assert a.shape == tuple(b.shape) and _rel(a, b.numpy()) <= 1e-12
    assert got["collectives"].get("exchange", 0) == 0 and got["collectives"].get("all_to_all", 0) == 0
    assert got["collectives"]["all_gather"] >= 3, got["collectives"]  # the lift, the solve, the solution
    for rank in results[1:]:
        other = rank[task][list(THIN).index(key)]
        assert other["its"] == got["its"] and all(np.array_equal(x, y) for x, y in zip(other["fields"], got["fields"]))
