"""The port's parallel-prefix trisolves (``ops/partri.py``, ``PartriILU``,
``PartriGS``) on the CPU against the JAX package, on the same seeded numpy
inputs:

- ``AffineChainScan`` (scalar and matrix maps), ``GridTriSolve2D``/``3D`` and
  ``apply_varcoef_stencil`` against sequential numpy recurrences and the JAX
  classes;
- ``PartriILU``/``PartriGS`` (2D/3D, quad/simplex, monolithic/field) against
  the JAX package's partri run in float64 (``PERPHIL_TPU_ILU_DTYPE``, its
  default backend) and against the port's own wavefront sweeps, <= 1e-12
  relative;
- the ``trisolve_backend`` option: left open, ``partri`` and ``wavefront``
  through the host GMRES+ILU loop and the lexicographic Picard (counts equal
  to the JAX package's default path), the solver caches' key, the plan's
  table and the memory guard.

The JAX package's solver caches do not key on the environment it reads,
hence the ``cache_clear``.
"""

import json
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.ops.ilu as jilu
import perphil_tpu.ops.partri as jpartri
import perphil_tpu.solvers.parameters as jsp
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC
from perphil_tpu.solvers import solve_dpp as jsolve_dpp
from perphil_tpu.solvers import solve_dpp_nonlinear as jsolve_nonlinear
from perphil_tpu.solvers import solver as jsolver
from perphil_tpu.utils import manufactured_solutions as jms

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops import ilu, partri
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.ops.krylov import gmres
from perphil_tpu_torch.solvers import solve_dpp_nonlinear, solver
from perphil_tpu_torch.solvers.solver import (
    _build_linear_solver,
    _build_nonlinear_solver,
    _freeze,
    _monolithic_pc,
    _ngs_sweeper,
    _trisolve_backend,
)

TOL = 1e-12  # relative, the same function summed in two orders


def _rel(a, b) -> float:
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture
def jax_f64_ilu(monkeypatch):
    """The JAX package's float64 ILU on its default (partri) backend."""
    monkeypatch.setenv("PERPHIL_TPU_ILU_DTYPE", "float64")
    monkeypatch.delenv("PERPHIL_TPU_TRISOLVE", raising=False)
    jsolver._build_linear_solver.cache_clear()
    jsolver._build_nonlinear_solver.cache_clear()
    yield
    jsolver._build_linear_solver.cache_clear()
    jsolver._build_nonlinear_solver.cache_clear()


# -- the scan trees --------------------------------------------------------------


@pytest.mark.parametrize("scalar", [True, False], ids=["scalar", "matrix"])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17])
def test_affine_chain_scan(n, scalar):
    rng = np.random.default_rng(n)
    if scalar:
        M, g = rng.standard_normal((n, 3)) * 0.5, rng.standard_normal((n, 3))
    else:
        M, g = rng.standard_normal((n, 3, 4, 4)) * 0.3, rng.standard_normal((n, 3, 4))
    x = partri.AffineChainScan(torch.tensor(M), scalar=scalar).apply(torch.tensor(g)).numpy()
    ref = np.zeros_like(g)
    for t in range(n):
        prev = ref[t - 1] if t > 0 else np.zeros_like(g[0])
        step = M[t] * prev if scalar else np.einsum("bij,bj->bi", M[t], prev)
        ref[t] = (step if t > 0 else 0.0) + g[t]
    np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-12)
    jx = np.asarray(jpartri.AffineChainScan(jnp.asarray(M), scalar=scalar).apply(jnp.asarray(g)))
    assert x.shape == jx.shape and _rel(x, jx) <= TOL


def _coefficients_2d(rng, full, scale=0.4):
    wr, bm, b0, bp = (rng.standard_normal(full) * scale for _ in range(4))
    # zero the out-of-range couplings, as the factor arrays guarantee
    wr[..., :, 0] = 0.0
    bm[..., 0, :] = bm[..., :, 0] = 0.0
    b0[..., 0, :] = 0.0
    bp[..., 0, :] = bp[..., :, -1] = 0.0
    return wr, bm, b0, bp


def _brute_2d(c, wr, bm, b0, bp):
    ny, nx = c.shape[-2:]
    x = np.zeros_like(c)
    for y in range(ny):
        for i in range(nx):
            v = c[..., y, i].copy()
            if i > 0:
                v += wr[..., y, i] * x[..., y, i - 1]
            if y > 0:
                if i > 0:
                    v += bm[..., y, i] * x[..., y - 1, i - 1]
                v += b0[..., y, i] * x[..., y - 1, i]
                if i < nx - 1:
                    v += bp[..., y, i] * x[..., y - 1, i + 1]
            x[..., y, i] = v
    return x


@pytest.mark.parametrize("batch", [(), (3,)], ids=["unbatched", "batch3"])
@pytest.mark.parametrize("shape", [(1, 1), (3, 4), (9, 7)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_grid_tri_solve_2d(shape, batch):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    full = batch + shape
    coeffs = _coefficients_2d(rng, full)
    c = rng.standard_normal(full)
    x = partri.GridTriSolve2D(*(torch.tensor(a) for a in coeffs)).apply(torch.tensor(c)).numpy()
    np.testing.assert_allclose(x, _brute_2d(c, *coeffs), rtol=1e-9, atol=1e-11)
    jx = np.asarray(jpartri.GridTriSolve2D(*(jnp.asarray(a) for a in coeffs)).apply(jnp.asarray(c)))
    assert _rel(x, jx) <= TOL


def test_grid_tri_solve_3d():
    shape = nz, ny, nx = (3, 3, 3)
    rng = np.random.default_rng(7)
    coeffs = _coefficients_2d(rng, shape, 0.3)
    bz = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            w = rng.standard_normal(shape) * 0.3
            if dy:  # zero where the offset leaves the plane
                w[:, 0 if dy < 0 else -1, :] = 0.0
            if dx:
                w[:, :, 0 if dx < 0 else -1] = 0.0
            w[0] = 0.0  # plane 0 has no predecessor
            bz[(dx, dy)] = w
    c = rng.standard_normal(shape)
    plane = partri.GridTriSolve2D(*(torch.tensor(a) for a in coeffs))
    x = partri.GridTriSolve3D(plane, {k: torch.tensor(v) for k, v in bz.items()}).apply(torch.tensor(c)).numpy()
    ref = np.zeros(shape)  # sequential over planes, a sequential 2D solve in each
    for z in range(nz):
        cz = c[z].copy()
        if z > 0:
            for (dx, dy), w in bz.items():
                shifted = np.zeros((ny, nx))
                shifted[max(-dy, 0) : ny + min(-dy, 0), max(-dx, 0) : nx + min(-dx, 0)] = ref[z - 1][
                    max(dy, 0) : ny + min(dy, 0), max(dx, 0) : nx + min(dx, 0)
                ]
                cz += w[z] * shifted
        ref[z] = _brute_2d(cz, *(a[z] for a in coeffs))
    np.testing.assert_allclose(x, ref, rtol=1e-8, atol=1e-10)
    jplane = jpartri.GridTriSolve2D(*(jnp.asarray(a) for a in coeffs))
    jx = np.asarray(jpartri.GridTriSolve3D(jplane, {k: jnp.asarray(v) for k, v in bz.items()}).apply(jnp.asarray(c)))
    assert _rel(x, jx) <= TOL


@pytest.mark.parametrize("shape", [(5, 6), (3, 4, 5)], ids=["2d", "3d"])
def test_apply_varcoef_stencil(shape):
    rng = np.random.default_rng(3)
    d = len(shape)
    x = rng.standard_normal(shape)
    offsets = [tuple(o) for o in np.ndindex(*((3,) * d))]
    coeffs = {tuple(int(v) - 1 for v in o): rng.standard_normal(shape) for o in offsets}
    for off, w in coeffs.items():  # zero where the offset leaves the grid
        for ax, o in enumerate(reversed(off)):
            idx = [slice(None)] * d
            if o:
                idx[ax] = 0 if o < 0 else -1
                w[tuple(idx)] = 0.0
    y = partri.apply_varcoef_stencil(torch.tensor(x), {k: torch.tensor(v) for k, v in coeffs.items()}).numpy()
    ref = np.zeros(shape)
    xp = np.pad(x, 1)
    for off, w in coeffs.items():
        rev = tuple(reversed(off))
        ref += w * xp[tuple(slice(1 + o, 1 + o + s) for o, s in zip(rev, shape))]
    np.testing.assert_allclose(y, ref, rtol=1e-14, atol=1e-14)
    jy = np.asarray(jpartri.apply_varcoef_stencil(jnp.asarray(x), {k: jnp.asarray(v) for k, v in coeffs.items()}))
    assert np.array_equal(y, jy)


# -- PartriILU / PartriGS against the JAX package's partri ------------------------

CASES = [("quad", (6, 6)), ("triangle", (6, 6)), ("hex", (3, 3, 3)), ("tet", (3, 3, 3))]
PARAMS = {"k1": 1.2, "beta": 0.9}


def _systems(element, cells, kind):
    jm, m = jmesh.StructuredMesh(cells=cells, element=element), StructuredMesh(cells=cells, element=element)
    jp, p = JParams(**PARAMS), DPPParameters(**PARAMS)
    if kind == "monolithic":
        return jilu.build_monolithic_system(jm, jp), ilu.build_monolithic_system(m, p)
    return (jilu.build_field_system(jm, jp.k2, jp.beta, jp.mu), ilu.build_field_system(m, p.k2, p.beta, p.mu))


@pytest.mark.parametrize("kind", ["monolithic", "field"])
@pytest.mark.parametrize("element,cells", CASES, ids=[e for e, _ in CASES])
def test_partri_ilu_matches_jax_and_wavefront(jax_f64_ilu, element, cells, kind):
    jsys, sys = _systems(element, cells, kind)
    jref = jilu.StructuredILU0._from_system(jsys)
    assert jref.partri is not None  # the JAX package's default backend
    got = ilu.PartriILU.for_system(sys, "cpu")
    wave = ilu.StructuredILU0(sys, "cpu")
    assert (got.trisolve_backend, wave.trisolve_backend) == ("partri", "wavefront")
    r = np.random.default_rng(11).standard_normal(sys.nrows)
    z = got.apply_flat(torch.tensor(r)).numpy()
    assert _rel(z, np.asarray(jref.apply_flat(jnp.asarray(r)))) <= TOL
    assert _rel(z, wave.apply_flat(torch.tensor(r)).numpy()) <= TOL
    shape = (sys.nfields, *sys.mesh.node_shape)
    assert np.array_equal(got.apply_grid(torch.tensor(r).reshape(shape)).reshape(-1).numpy(), z)


@pytest.mark.parametrize("kind", ["monolithic", "field"])
@pytest.mark.parametrize("element,cells", CASES, ids=[e for e, _ in CASES])
def test_partri_gs_matches_jax_and_wavefront(monkeypatch, element, cells, kind):
    monkeypatch.delenv("PERPHIL_TPU_TRISOLVE", raising=False)
    jsys, sys = _systems(element, cells, kind)
    if kind == "monolithic":
        jswp = jilu.GaussSeidelSweeper.for_monolithic(jsys.mesh, JParams(**PARAMS))
        assert jswp.partri is not None  # the JAX package's default backend
        jsweep = jswp.sweep
    else:
        jsweep = jilu.build_partri_gs(jsys, jsys.vals, jnp.float64).sweep_flat
    got = ilu.PartriGS.for_system(sys, "cpu")
    wave = ilu.GaussSeidelSweeper(sys, "cpu")
    assert (got.trisolve_backend, wave.trisolve_backend) == ("partri", "wavefront")
    x, b = np.random.default_rng(12).standard_normal((2, sys.nrows))
    z = got.sweep(torch.tensor(x), torch.tensor(b)).numpy()
    assert _rel(z, np.asarray(jsweep(jnp.asarray(x), jnp.asarray(b)))) <= TOL
    assert _rel(z, wave.sweep(torch.tensor(x), torch.tensor(b)).numpy()) <= TOL


def test_partri_rejects_what_it_does_not_take():
    _, sys = _systems("quad", (4, 4), "monolithic")
    with pytest.raises(ValueError, match="trisolve_backend"):
        solver._trisolve_option({"trisolve_backend": "scan"})
    assert ilu.TRISOLVE_BACKENDS == tuple(ilu.GS_BACKENDS) == ("partri", "wavefront")
    pc = ilu.PartriILU.for_system(sys, "cpu")
    with pytest.raises(ValueError, match="built for"):
        pc.apply_flat(torch.zeros(pc.nrows, device="meta"))
    swp = ilu.PartriGS.for_system(sys, "cpu")
    with pytest.raises(ValueError, match="built for"):
        swp.sweep(torch.zeros(swp.nrows, device="meta"), torch.zeros(swp.nrows, device="meta"))


# -- the trisolve_backend option ---------------------------------------------------


def _manufactured(element, cells):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    ex = jms.exact_expressions if mesh.dim == 2 else jms.exact_expressions_3d
    _, p1, _, p2 = ex(mesh, JParams())
    coords = [jnp.asarray(c) for c in mesh.coordinates()]
    return np.asarray(p1(*coords)), np.asarray(p2(*coords))


def _jax_bcs(element, cells, g1, g2):
    _, jV = jspaces_of(jmesh.StructuredMesh(cells=cells, element=element))
    W = jmixed(jV)
    return W, [JBC(W.sub(0), jnp.asarray(g1)), JBC(W.sub(1), jnp.asarray(g2))]


OPTIONS = [{}, {"trisolve_backend": "partri"}, {"trisolve_backend": "wavefront"}]
OPTION_IDS = ["open", "partri", "wavefront"]


@lru_cache(maxsize=None)
def _jax_default_solve(element, cells, nonlinear: bool):
    """The JAX package's solve on the manufactured data on its default path
    (the partri trisolves; ILU in float64), once a module: (count, fields)."""
    g1, g2 = _manufactured(element, cells)
    jW, jbcs = _jax_bcs(element, cells, g1, g2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PERPHIL_TPU_ILU_DTYPE", "float64")
        mp.delenv("PERPHIL_TPU_TRISOLVE", raising=False)
        jsolver._build_linear_solver.cache_clear()
        jsolver._build_nonlinear_solver.cache_clear()
        if nonlinear:
            ref = jsolve_nonlinear(jW, JParams(), jbcs, solver_parameters=jsp.PICARD_LU_SOLVER_PARAMS)
        else:
            ref = jsolve_dpp(jW, JParams(), jbcs, solver_parameters=jsp.GMRES_ILU_PARAMS)
        jsolver._build_linear_solver.cache_clear()
        jsolver._build_nonlinear_solver.cache_clear()
    return int(ref.iteration_number), tuple(np.asarray(d) for d in ref.solution.data)


@pytest.mark.parametrize("option", OPTIONS, ids=OPTION_IDS)
@pytest.mark.parametrize("element,cells,count", [("quad", (8, 8), 7), ("tet", (4, 4, 4), 4)], ids=["quad8", "tet4"])
def test_host_gmres_ilu_matches_jax_default(element, cells, count, option):
    """The host GMRES loop (``krylov.gmres`` + K1's twin + ``_monolithic_pc``)
    on the Newton-step system, against the JAX package's solve on its default
    partri ILU: the same count, fields within 1e-10."""
    g1, g2 = _manufactured(element, cells)
    ref_its, ref_fields = _jax_default_solve(element, cells, False)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    op = DPPOperator(state.W, state.params)
    flat = dict(_freeze({**sp.GMRES_ILU_PARAMS, **option}))
    pc = _monolithic_pc(op, flat)
    assert pc.__self__.trisolve_backend == option.get("trisolve_backend", "partri")
    bdry = op._mask_arrays[0]
    x0 = [torch.where(bdry, g, 0.0) for g in state.grids]
    r = torch.stack(op.residual(*x0, *op.lifted_rhs(*state.grids)))
    kw = {k: sp.GMRES_ILU_PARAMS[f"ksp_{k}"] for k in ("rtol", "atol", "max_it")}
    res = gmres(op.stacked_matvec(), r, M_inv=pc, **kw)
    assert res.iterations == ref_its == count
    for a, d, b in zip(x0, res.x, ref_fields):
        assert _rel((a + d).numpy(), b) <= 1e-10


@pytest.mark.parametrize("option", OPTIONS, ids=OPTION_IDS)
@pytest.mark.parametrize("element,cells", [("triangle", (4, 4)), ("tet", (3, 3, 3))], ids=["tri4", "tet3"])
def test_lexicographic_picard_matches_jax_default(element, cells, option):
    """``solve_dpp_nonlinear`` with ``PICARD_LU_SOLVER_PARAMS`` (the
    lexicographic GS on tri/tet) on each backend, against the JAX package's
    default path (partri): the same count, fields within 1e-10."""
    g1, g2 = _manufactured(element, cells)
    ref_its, ref_fields = _jax_default_solve(element, cells, True)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    got = solve_dpp_nonlinear(state.W, state.params, state.bcs, {**sp.PICARD_LU_SOLVER_PARAMS, **option})
    assert got.iteration_number == ref_its
    for a, b in zip(got.solution.data, ref_fields):
        assert _rel(a.numpy(), b) <= 1e-10
    swp = _ngs_sweeper(state.mesh, state.params, state.W.device, option.get("trisolve_backend", ""))
    assert swp.trisolve_backend == option.get("trisolve_backend", "partri")


def test_solver_caches_are_keyed_on_the_backend():
    state = from_numpy_state({}, (4, 4), "triangle", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    W, p = state.W, state.params
    built = {}
    for name, build, preset in (("linear", _build_linear_solver, sp.GMRES_ILU_PARAMS),
                                ("nonlinear", _build_nonlinear_solver, sp.PICARD_LU_SOLVER_PARAMS)):
        solvers = [build(W, p, _freeze({**preset, **o})) for o in OPTIONS]
        assert solvers[0] is build(W, p, _freeze(preset))
        assert len({id(s) for s in solvers}) == 3, name
        built[name] = solvers
    with pytest.raises(ValueError, match="trisolve_backend"):
        _build_nonlinear_solver(W, p, _freeze({**sp.PICARD_LU_SOLVER_PARAMS, "trisolve_backend": "scan"}))


# worked by hand from the JAX package's _partri_fits: per directional solve
# 2 ny nx^2 (2D) or 2 nz (ny nx)^2 (3D) f64 values, two a field
PLAN_TABLE = [
    ((257, 257), 2, 4 * 2 * 257**3 * 8),  # 2D N=256 monolithic: 1,086,373,952 B
    ((513, 513), 2, 4 * 2 * 513**3 * 8),  # 2D N=512 monolithic: 8,640,364,608 B
    ((257, 257), 1, 2 * 2 * 257**3 * 8),  # one 2D N=256 field
    ((41, 41, 41), 2, 4 * 2 * 41 * 41**4 * 8),  # tet nx=40 monolithic: 7,414,796,864 B
]


@pytest.mark.parametrize("shape,nfields,nbytes", PLAN_TABLE, ids=["2d256", "2d512", "field256", "3d40"])
def test_partri_plan_table(monkeypatch, shape, nfields, nbytes):
    assert ilu.partri_plan(shape, nfields) == nbytes
    assert ilu.partri_plan(shape, nfields, 4) == nbytes // 2
    # the JAX package's gate flips at exactly the plan's bytes
    cells = tuple(n - 1 for n in reversed(shape))
    element = "quad" if len(shape) == 2 else "tet"

    class Sys:  # what _partri_fits reads
        mesh = jmesh.StructuredMesh(cells=cells, element=element)

    Sys.nfields = nfields
    monkeypatch.setattr(jilu, "_PARTRI_MAX_BYTES", nbytes)
    assert jilu._partri_fits(Sys, 8)
    monkeypatch.setattr(jilu, "_PARTRI_MAX_BYTES", nbytes - 1)
    assert not jilu._partri_fits(Sys, 8)


FREE = 8 * 2**30  # a fixed free-memory figure: 8 GiB
CARD = torch.device("cuda")  # only its type is read: the free memory is stubbed
ROUTES = [  # 2D N, option, backend (None: MemoryError)
    (256, "", "wavefront"), (256, "partri", "partri"), (256, "wavefront", "wavefront"),
    (512, "", "wavefront"), (512, "partri", None), (512, "wavefront", "wavefront"),
]


@pytest.mark.parametrize("N,option,backend", ROUTES, ids=[f"{n}-{o or 'open'}" for n, o, _ in ROUTES])
def test_routes_under_a_fixed_free_memory(monkeypatch, N, option, backend):
    """On the card the open option takes the wavefront (partri measured
    slower); asked for, partri is gated by the card's free memory (stubbed),
    not the JAX package's 6 GiB: 2D N=256's build peak (1.83 GB) fits in 8
    GiB, N=512's (14.3 GB) does not; asking for partri there raises, naming
    the bytes and the way out."""
    monkeypatch.setattr(solver, "_free_device_bytes", lambda device: FREE)
    shape = (N + 1, N + 1)
    if backend is None:
        with pytest.raises(MemoryError, match=f"need {ilu.partri_peak(shape, 2)} bytes.*trisolve_backend=wavefront"):
            _trisolve_backend(option, shape, 2, CARD)
    else:
        assert _trisolve_backend(option, shape, 2, CARD) == backend


# worked by hand: the maps plus 5 (2D) or 7 (3D) map sets of one directional
# solve, plus 64 values a row
PEAK_TABLE = [
    ((257, 257), 2, 4 * 2 * 257**3 * 8 + 5 * 257**3 * 8 + 64 * 2 * 257**2 * 8),  # 1,832,991,848 B
    ((513, 513), 2, 4 * 2 * 513**3 * 8 + 5 * 513**3 * 8 + 64 * 2 * 513**2 * 8),  # 14,310,077,544 B
    ((41, 41, 41), 2, 4 * 2 * 41**5 * 8 + 7 * 41**5 * 8 + 64 * 2 * 41**3 * 8),  # 13,973,319,224 B
]


@pytest.mark.parametrize("shape,nfields,nbytes", PEAK_TABLE, ids=["2d256", "2d512", "3d40"])
def test_partri_peak_table(shape, nfields, nbytes):
    assert ilu.partri_peak(shape, nfields) == nbytes
    assert ilu.partri_peak(shape, nfields) > ilu.partri_plan(shape, nfields)


@pytest.mark.parametrize("element,cells,kind", [("quad", (16, 16), "monolithic"), ("quad", (16, 16), "field"),
                                                ("tet", (5, 5, 5), "monolithic")], ids=["2d", "field", "tet"])
def test_partri_peak_bounds_a_build(tmp_path, element, cells, kind):
    """A build and an apply on the CPU, their allocations followed by the
    profiler's memory timeline: the peak above the start lies within
    ``partri_peak`` and above the maps it keeps."""
    from torch.profiler import ProfilerActivity, profile

    _, sys = _systems(element, cells, kind)
    fac = ilu.ilu0_factorize(sys)
    r = torch.tensor(np.random.default_rng(3).standard_normal(sys.nrows))
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True, record_shapes=True, with_stack=True) as prof:
        ilu.PartriILU(sys, fac, "cpu").apply_flat(r)
    prof.export_memory_timeline(str(tmp_path / "memory.json"), device="cpu")
    _, sizes = json.loads((tmp_path / "memory.json").read_text())
    totals = [sum(s) for s in sizes]
    peak = max(totals) - totals[0]
    shape = sys.mesh.node_shape
    assert ilu.partri_plan(shape, sys.nfields) < peak <= ilu.partri_peak(shape, sys.nfields)


def test_card_gate_counts_the_build_peak(monkeypatch):
    """Free memory between the maps (``partri_plan``) and the build's peak
    (``partri_peak``): asking for partri raises, the open option takes the
    wavefront; with the peak free, partri is built."""
    shape = (257, 257)
    plan, peak = ilu.partri_plan(shape, 2), ilu.partri_peak(shape, 2)
    monkeypatch.setattr(solver, "_free_device_bytes", lambda device: plan + 1)
    assert _trisolve_backend("", shape, 2, CARD) == "wavefront"
    with pytest.raises(MemoryError, match=f"need {peak} bytes.*has {plan + 1} free.*trisolve_backend=wavefront"):
        _trisolve_backend("partri", shape, 2, CARD)
    monkeypatch.setattr(solver, "_free_device_bytes", lambda device: peak)
    assert _trisolve_backend("partri", shape, 2, CARD) == "partri"


def test_cpu_budget_and_memory_guard(monkeypatch):
    """On the CPU the JAX package's cap stands (2D N=464 fits, N=465 not);
    with a tiny budget an open option takes the wavefront and ``partri``
    raises ``MemoryError`` before anything is built, end to end."""
    cpu = torch.device("cpu")
    assert ilu.CPU_PARTRI_MAX_BYTES == jilu._PARTRI_MAX_BYTES
    assert _trisolve_backend("", (465, 465), 2, cpu) == "partri"
    assert _trisolve_backend("", (466, 466), 2, cpu) == "wavefront"
    monkeypatch.setattr(solver, "CPU_PARTRI_MAX_BYTES", 16)

    def no_build(*args, **kwargs):
        raise AssertionError("maps built before the memory check")

    monkeypatch.setitem(ilu.GS_BACKENDS, "partri", no_build)
    state = from_numpy_state({"k2": 3.0}, (4, 4), "triangle", *_manufactured("triangle", (4, 4)), device="cpu")
    with pytest.raises(MemoryError, match=f"need {ilu.partri_plan((5, 5), 2)} bytes.*trisolve_backend=wavefront"):
        solve_dpp_nonlinear(state.W, state.params, state.bcs, {**sp.PICARD_LU_SOLVER_PARAMS, "trisolve_backend": "partri"})
    sol = solve_dpp_nonlinear(state.W, state.params, state.bcs, sp.PICARD_LU_SOLVER_PARAMS)
    assert sol.iteration_number >= 1
    swp = _ngs_sweeper(state.mesh, state.params, cpu)
    assert swp.trisolve_backend == "wavefront"
