"""The lexicographic Picard solve in one launch (``ops/fused_gs.py``,
``csrc/fused_gs.cu``) on the CPU: its twin against the JAX package's
lexicographic ngs (its wavefront sweep, ``PERPHIL_TPU_TRISOLVE=wavefront``;
the JAX package's solver caches do not key on the environment, hence the
``cache_clear``), the kernel's plan, tables and entries against
hand-worked numbers and the system they come from, and the kernel's
algorithm (slabs, levels, pushed halo, residual order) run in numpy through
its own tables, bit for bit with the twin. The kernel itself is held to the
twin on the card in ``tests/test_torch_kernels.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.solvers.parameters as jsp
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC
from perphil_tpu.solvers import solve_dpp_nonlinear as jsolve_nonlinear
from perphil_tpu.solvers import solver as jsolver
from perphil_tpu.utils import manufactured_solutions as jms

from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops import fused_gs as fg
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.ops.fused_gs import (
    MAX_TAPS,
    FusedGSSolver,
    GsPlan,
    fused_gs_plan,
    gs_host_loop,
    gs_tables,
    gs_taps,
    interior_levels,
)
from perphil_tpu_torch.ops.fused_ngs import slab_rows
from perphil_tpu_torch.ops.ilu import GaussSeidelSweeper, PartriGS, build_monolithic_system
from perphil_tpu_torch.ops.krylov import tree_sum
from perphil_tpu_torch.solvers import solve_dpp_nonlinear
from perphil_tpu_torch.solvers.solver import _build_nonlinear_solver, _ngs_sweeper

# A final norm is that of a residual ~rtol times the first one: b - A x
# cancels all but ~eps / rtol (1e-8) of its bits, which two packages
# summing in other orders do not share.
_NORM_TOL = 1e-6
MESHES = [("triangle", (4, 4)), ("triangle", (8, 8)), ("hex", (3, 3, 3)), ("tet", (3, 3, 3)), ("tet", (4, 4, 4))]
PICARD = jsp.PICARD_LU_SOLVER_PARAMS
SNES_KW = dict(rtol=PICARD["snes_rtol"], atol=PICARD["snes_atol"], max_it=PICARD["snes_max_it"])


@pytest.fixture
def jax_wavefront(monkeypatch):
    """The JAX package's lexicographic Gauss-Seidel on its wavefront sweep."""
    monkeypatch.setenv("PERPHIL_TPU_TRISOLVE", "wavefront")
    jsolver._build_nonlinear_solver.cache_clear()
    yield
    jsolver._build_nonlinear_solver.cache_clear()


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _manufactured(element, cells):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    ex = jms.exact_expressions if mesh.dim == 2 else jms.exact_expressions_3d
    _, p1, _, p2 = ex(mesh, JParams())
    coords = [jnp.asarray(c) for c in mesh.coordinates()]
    return np.asarray(p1(*coords)), np.asarray(p2(*coords))


def _state(element, cells):
    g1, g2 = _manufactured(element, cells)
    return from_numpy_state({}, cells, element, g1, g2, device="cpu")


def _problem(element, cells, **solver_kw):
    """(operator, solver, b, x0) of the manufactured Picard problem on the CPU."""
    state = _state(element, cells)
    op = DPPOperator(state.W, state.params)
    b = torch.stack(op.lifted_rhs(*state.grids))
    bdry = op._mask_arrays[0]
    x0 = torch.stack([torch.where(bdry, g, 0.0) for g in state.grids])
    return op, FusedGSSolver(op, **solver_kw), b, x0


# -- the twin against the JAX package and the host loop ----------------------


@pytest.mark.parametrize("element,cells", MESHES, ids=[f"{m[0]}{m[1][0]}" for m in MESHES])
def test_twin_matches_jax(jax_wavefront, element, cells):
    """PICARD_LU_SOLVER_PARAMS on the manufactured solution: the twin (the
    route's CPU solve with trisolve_backend=wavefront, no kernel launched)
    lands the JAX package's count; fields <= 1e-10 relative (the same
    sweeps; the norms sum in other orders), final norms <= 1e-6 relative
    (_NORM_TOL)."""
    g1, g2 = _manufactured(element, cells)
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    _, jV = jspaces_of(mesh)
    jW = jmixed(jV)
    jbcs = [JBC(jW.sub(0), jnp.asarray(g1)), JBC(jW.sub(1), jnp.asarray(g2))]
    ref = jsolve_nonlinear(jW, JParams(), jbcs, solver_parameters=PICARD)
    state = _state(element, cells)
    before = dict(_cuda.KERNEL_LAUNCHES)
    got = solve_dpp_nonlinear(state.W, state.params, state.bcs,
                              solver_parameters={**PICARD, "trisolve_backend": "wavefront"})
    assert dict(_cuda.KERNEL_LAUNCHES) == before
    assert got.iteration_number == ref.iteration_number > 0
    for a, b in zip(got.solution.data, ref.solution.data):
        assert a.device.type == "cpu" and _rel(a.numpy(), b) <= 1e-10
    assert abs(got.residual_error - ref.residual_error) <= _NORM_TOL * abs(ref.residual_error)


@pytest.mark.parametrize("element,cells", MESHES, ids=[f"{m[0]}{m[1][0]}" for m in MESHES])
def test_host_loop_lands_the_twin_count(element, cells):
    """The route beyond the plan (a sweep and a K1 residual an iteration;
    their plain twins here) lands the twin's count with x bit for bit: the
    sweeps are the same, the norms sum in another order."""
    op, solver, b, x0 = _problem(element, cells, **SNES_KW)
    twin = solver.plain(b, x0)
    loop = gs_host_loop(op, solver.sweeper, b, x0, solver.rtol, solver.atol, solver.max_it)
    assert loop.iterations == twin.iterations > 0
    assert torch.equal(loop.x, twin.x)
    assert abs(loop.residual_norm - twin.residual_norm) <= _NORM_TOL * twin.residual_norm


@pytest.mark.parametrize("element,cells", [("triangle", (8, 8)), ("hex", (4, 4, 4)), ("tet", (5, 5, 5))])
def test_residual_is_the_operator(element, cells):
    """The twin's residual (the kernel's order) is b - A x of the assembled
    system, <= 1e-13 relative to K1's on a random iterate."""
    op, solver, _, _ = _problem(element, cells)
    rng = np.random.default_rng(5)
    x, b = (torch.tensor(rng.standard_normal(solver.sweeper.nrows)) for _ in range(2))
    ref = b - op.flat_matvec()(x)
    assert _rel(solver.residual(x, b).numpy(), ref.numpy()) <= 1e-13


# -- the plan, the levels, the tables and the entries ------------------------

# (element, node shape, blocks asked for or None): the launcher's plan,
# worked by hand from gs_place: rows = ceil(interior planes / blocks);
# leaves = the power of two with 512 blocks leaves >= 2 n; nloc = 4 (L //
# 4 nb) + min(L % 4 nb, 4); width = 2 rows (interior nodes a plane);
# bytes = 16 (rows + 2) plane + 16 rows plane + (one block: 2048 staging;
# a cluster: 8 nloc) + 2 width + 4 (levels + 1) + (cluster: 8 levels),
# each rounded up to 16. The edges: the last tri and tet meshes on one block
# (N=78, nx=17), the first past it, tri N=128 and tet nx=24 (the rule: the
# most blocks that place a mesh past one block; 4 blocks asked for), the
# largest tet (nx=34).
PLAN_TABLE = [
    # tri N=16: 16*17*17 + 16*15*17 + 2048 + 2*450 -> 912 + 4*48 = 4624 + 4080 + 2048 + 912 + 192
    ("triangle", (17, 17), None, GsPlan(1, 15, 2, 578, 450, 47, 11856)),
    # tri N=78: 16*79*79 + 16*77*79 + 2048 + (2*11858 -> 23728) + (4*234 -> 944)
    ("triangle", (79, 79), None, GsPlan(1, 77, 32, 12482, 11858, 233, 99856 + 97328 + 2048 + 23728 + 944)),
    # tri N=79: one block would take 102,400 + 99,840 + 2,048 + 24,336 + 960 = 229,584 > 228,352:
    # 16 blocks of ceil(78 / 16) = 5 rows, 2 leaves, nloc 4 * 200, (2*780 -> 1568), (4*237 -> 960)
    ("triangle", (80, 80), None, GsPlan(16, 5, 2, 800, 780, 236, 8960 + 6400 + 6400 + 1568 + 960 + 1888)),
    ("triangle", (80, 80), 2, GsPlan(2, 39, 16, 6400, 6084, 236, 52480 + 49920 + 51200 + 12176 + 960 + 1888)),
    ("triangle", (129, 129), None, GsPlan(16, 8, 8, 2082, 2032, 383, 20640 + 16512 + 16656 + 4064 + 1536 + 3072)),
    ("triangle", (129, 129), 4, GsPlan(4, 32, 32, 8322, 8128, 383, 70176 + 66048 + 66576 + 16256 + 1536 + 3072)),
    # tet nx=4: 16*3*25 + ... with plane 25, interior a plane 9
    ("tet", (5, 5, 5), None, GsPlan(1, 3, 1, 250, 54, 23, 2000 + 1200 + 2048 + 112 + 96)),
    ("tet", (18, 18, 18), None, GsPlan(1, 16, 32, 11664, 8192, 114, 93312 + 82944 + 2048 + 16384 + 464)),
    # tet nx=18: 16 blocks of ceil(17 / 16) = 2 planes of 361 nodes (289 interior), nloc 4 * 214 + 4
    ("tet", (19, 19, 19), None, GsPlan(16, 2, 2, 860, 1156, 121, 23104 + 11552 + 6880 + 2320 + 496 + 976)),
    ("tet", (19, 19, 19), 2, GsPlan(2, 9, 16, 6860, 5202, 121, 63536 + 51984 + 54880 + 10416 + 496 + 976)),
    ("tet", (25, 25, 25), None, GsPlan(16, 2, 4, 1956, 2116, 163, 40000 + 20000 + 15648 + 4240 + 656 + 1312)),
    ("tet", (25, 25, 25), 4, GsPlan(4, 6, 16, 7814, 6348, 163, 80000 + 60000 + 62512 + 12704 + 656 + 1312)),
    ("tet", (35, 35, 35), None, GsPlan(16, 3, 16, 5360, 6534, 233, 98000 + 58800 + 42880 + 13072 + 944 + 1872)),
    ("hex", (9, 9, 9), None, GsPlan(1, 7, 4, 1458, 686, 51, 11664 + 9072 + 2048 + 1376 + 208)),
]


@pytest.mark.parametrize("element,shape,blocks,plan", PLAN_TABLE,
                         ids=[f"{p[0]}{p[1][0]}-{p[2] or 'rule'}" for p in PLAN_TABLE])
def test_plan_table(element, shape, blocks, plan):
    assert fused_gs_plan(shape, element, blocks=blocks) == plan


def test_plan_refuses_what_the_launcher_refuses():
    """Quad meshes (fused_ngs's), a shape of the wrong dimension, block
    counts that are no power of two, above 16, above the interior planes or
    the tree's threads, and the first meshes past the budget: tri N=2n with
    more than 262,144 values a tree (N=361 is the last), tet nx=35."""
    assert fused_gs_plan((17, 17), "quad") is None
    assert fused_gs_plan((5, 5, 5), "triangle") is None and fused_gs_plan((17, 17), "tet") is None
    assert fused_gs_plan((65, 65), "triangle", blocks=3) is None
    assert fused_gs_plan((65, 65), "triangle", blocks=32) is None
    assert fused_gs_plan((5, 5, 5), "tet", blocks=4) is None  # three interior planes
    assert fused_gs_plan((17, 17), "triangle", blocks=4) is None  # 578 values: two blocks' threads at most
    assert fused_gs_plan((36, 36, 36), "tet") is None
    last = max(N for N in range(200, 400) if fused_gs_plan((N + 1, N + 1), "triangle") is not None)
    assert fused_gs_plan((last + 2, last + 2), "triangle") is None and last < 361


def _gs_levels(dim, nz, ny, nx):
    """The launcher's gs_levels, line for line: a difference array over the
    level keys of each interior (field, z, y) run of x."""
    shift, z0, z1 = (4, 0, 1) if dim == 2 else (8, 1, nz - 1)
    top = (nx - 2) + 2 * (ny - 2) + 4 * (z1 - 1) + shift + 2
    marks = [0] * (top + 1)
    for f in (0, 1):
        for z in range(z0, z1):
            for y in range(1, ny - 1):
                lo = 1 + 2 * y + 4 * z + f * shift
                marks[lo] += 1
                marks[lo + nx - 2] -= 1
    levels = run = 0
    for k in range(top + 1):
        run += marks[k]
        levels += run > 0
    return levels


@pytest.mark.parametrize("element,cells", [("triangle", (1, 1)), ("triangle", (2, 5)), ("triangle", (16, 16)),
                                           ("triangle", (7, 3)), ("tet", (2, 2, 2)), ("tet", (4, 3, 5)),
                                           ("hex", (6, 6, 6)), ("tet", (1, 4, 2))])
def test_levels_are_the_schedule_of_the_interior_rows(element, cells):
    """The kernel's levels are the level schedule's levels that hold an
    interior row, in order, and the launcher's count of them."""
    mesh = StructuredMesh(cells=cells, element=element)
    shape = tuple(mesh.node_shape)
    sys = build_monolithic_system(mesh, DPPParameters())
    interior = np.tile(~mesh.boundary_mask().ravel(), 2)
    held = [lv[interior[lv]] for lv in sys.levels]
    levels = interior_levels(shape)
    assert levels.size == sum(h.size > 0 for h in held)
    nz, ny, nx = (1,) * (3 - len(shape)) + shape
    assert levels.size == _gs_levels(len(shape), nz, ny, nx)
    keys = dict(zip(levels.tolist(), range(levels.size)))
    lam = np.array([1, 2, 4][: mesh.dim])
    pos = np.stack(np.unravel_index(np.arange(mesh.num_vertices), shape)[::-1], axis=1)  # x, y[, z]
    shift = 4 if mesh.dim == 2 else 8
    for k, rows in enumerate(h for h in held if h.size):
        f = rows // mesh.num_vertices
        assert {keys[int(v)] for v in pos[rows % mesh.num_vertices] @ lam + f * shift} == {k}


TABLE_CASES = [("triangle", (17, 17), 1), ("triangle", (17, 17), 2), ("triangle", (49, 49), 16),
               ("triangle", (80, 80), 4), ("tet", (9, 9, 9), 1), ("tet", (13, 13, 13), 4), ("hex", (9, 9, 9), 2)]


@pytest.mark.parametrize("element,shape,blocks", TABLE_CASES, ids=[f"{c[0]}{c[1][0]}-{c[2]}" for c in TABLE_CASES])
def test_tables_hold_each_interior_row_once_at_its_level(element, shape, blocks):
    """Each block's list holds its slab's interior rows, each once, sorted
    by level (field 0's first within a level), the bounds its level counts,
    every code and every entry it reads within the slab (16 bits), and the
    pushes a level the rows on the slab's first and last plane."""
    plan = fused_gs_plan(shape, element, blocks=blocks)
    lists, cptr, sends = gs_tables(shape, plan)
    outer, plane, inner = fg._planes(shape)
    fs = (plan.rows + 2) * plane
    levels = interior_levels(shape)
    mesh = StructuredMesh(cells=tuple(m - 1 for m in reversed(shape)), element=element)
    w, d, nc = gs_taps(mesh, DPPParameters(), plan)
    n = int(np.prod(shape))
    seen = []
    for k, (r0, rows) in enumerate(slab_rows(outer, plan.blocks)):
        code = lists[k, : cptr[k, -1]].astype(np.int64)
        assert code.size == 2 * rows * inner and np.all(lists[k, code.size :] == 0)
        f = code // fs
        local = code - f * fs
        assert np.all((local >= plane) & (local < (rows + 1) * plane))
        node = local + (r0 - 1) * plane
        seen.append(f * n + node)
        lev = np.repeat(np.arange(levels.size), np.diff(cptr[k]))
        key = sum(lam * c for lam, c in zip((1, 2, 4), np.unravel_index(node, shape)[::-1]))
        key = key + f * (4 if len(shape) == 2 else 8)
        assert np.array_equal(levels[lev], key)
        assert np.all(np.diff(lev * 2 * fs + code) > 0)  # level, then code
        for ff in (0, 1):
            reach = code[f == ff][:, None] + d[ff, : nc[ff]][None, :]
            assert reach.min() >= 0 and reach.max() < 2 * fs <= 65536
        first, last = local < 2 * plane, local >= rows * plane
        none = np.zeros(levels.size, np.int32)
        assert np.array_equal(sends[k, :, 0], np.bincount(lev[first], minlength=levels.size) if k > 0 else none)
        assert np.array_equal(sends[k, :, 1], np.bincount(lev[last], minlength=levels.size) if k < plan.blocks - 1 else none)
    seen = np.sort(np.concatenate(seen))
    assert np.array_equal(seen, np.flatnonzero(np.tile(~mesh.boundary_mask().ravel(), 2)))


@pytest.mark.parametrize("element,cells,live",
                         [("triangle", (6, 5), 14), ("tet", (3, 4, 5), 30), ("hex", (4, 3, 3), 54)])
def test_taps_are_the_systems_entries(element, cells, live):
    """gs_taps: per field the system's nonzero entries of an interior row in
    stored order, the diagonal at its place (on one block the slab is the
    grid, so an entry's offset is its column delta); at every interior row
    the system's entries towards interior columns are these, every other
    entry is 0."""
    mesh = StructuredMesh(cells=cells, element=element)
    plan = fused_gs_plan(tuple(mesh.node_shape), element, blocks=1)
    w, d, nc = gs_taps(mesh, DPPParameters(), plan)
    assert tuple(nc[:2]) == (live, live) and live <= MAX_TAPS
    assert np.all(w[:, live:] == 0) and np.all(d[:, live:] == 0)
    sys = build_monolithic_system(mesh, DPPParameters())
    n, bdry = mesh.num_vertices, mesh.boundary_mask().ravel()
    stored = {int(t): k for k, t in enumerate(sys.deltas)}
    for f in (0, 1):
        taps = dict(zip(d[f, :live].tolist(), w[f, :live].tolist()))
        assert d[f, nc[2 + f]] == 0
        assert [stored[t] for t in d[f, :live]] == sorted(stored[t] for t in d[f, :live])  # stored order
        for row in f * n + np.flatnonzero(~bdry):
            cols = row + sys.deltas
            inner = (cols >= 0) & (cols < 2 * n)
            inner[inner] = ~bdry[cols[inner] % n]
            assert np.all(sys.vals[row][~inner] == 0)
            for t in np.flatnonzero(inner):
                assert sys.vals[row, t] == taps.get(int(sys.deltas[t]), 0.0)


# -- the kernel's algorithm through its tables --------------------------------


def _kernel_lists(solver):
    """The launcher's lists from gs_taps, unpadded: per field the residual's
    (every entry) and the sweep's (all but the diagonal), and the diagonals."""
    w, d, nc = gs_taps(solver.mesh, solver.params, solver.plan)
    res = [(w[f, : nc[f]], d[f, : nc[f]]) for f in (0, 1)]
    swp = [(np.delete(w[f, : nc[f]], nc[2 + f]), np.delete(d[f, : nc[f]], nc[2 + f])) for f in (0, 1)]
    return res, swp, [w[f, nc[2 + f]] for f in (0, 1)]


def _emulate_kernel(solver, b, x0, sweeps=None):
    """The kernel's algorithm in numpy, through its tables: per block a slab
    of x with its halo planes (boundary nodes 0.0) and b's slab; a level's
    rows of every block, each row's chain in the lists' order, then the
    level's pushes into the neighbours' halos (counted against ``sends``);
    the residual of every own row in the same order and the norm the halving
    tree over the squares (a boundary row: b - x0 before the first sweep, 0
    after; its square root correctly rounded). ``sweeps`` replaces the stop
    test with a fixed count. Returns
    (x, iterations, fn, f0)."""
    plan, shape = solver.plan, solver.node_shape
    outer, plane, _ = fg._planes(shape)
    n, nb, R = outer * plane, plan.blocks, plan.rows
    fs = (R + 2) * plane
    lists, cptr, sends = gs_tables(shape, plan)
    res, swp, diag = _kernel_lists(solver)
    slabs = slab_rows(outer, nb)
    bdry = solver.mesh.boundary_mask().ravel()
    bf, xf = b.numpy().reshape(2, n), x0.numpy().reshape(2, n)
    xs, bs = np.zeros((nb, 2 * fs)), np.zeros((nb, 2 * R * plane))
    for k, (r0, rows) in enumerate(slabs):
        nodes = np.arange((r0 - 1) * plane, (r0 + rows + 1) * plane)
        for f in (0, 1):
            xs[k, f * fs : f * fs + nodes.size] = np.where(bdry[nodes], 0.0, xf[f, nodes])
            bs[k, f * R * plane : f * R * plane + rows * plane] = bf[f, r0 * plane : (r0 + rows) * plane]

    def chains(k, code, lists_of):
        """acc = b; acc - w * x over a list, rows of both fields."""
        f = (code >= fs).astype(np.int64)
        out = np.empty(code.size)
        for ff in (0, 1):
            at = code[f == ff]
            acc = bs[k, at - plane - 2 * plane * ff]
            for wt, dt in zip(*lists_of[ff]):
                acc = acc - wt * xs[k, at + dt]
            out[f == ff] = acc
        return out, f

    def norm(its):
        r = np.where(np.tile(bdry, 2), (bf - xf).ravel() if its == 0 else 0.0, 0.0)
        for k, (r0, rows) in enumerate(slabs):
            code = lists[k, : cptr[k, -1]].astype(np.int64)
            v, f = chains(k, code, res)
            r[code - f * fs + f * n + (r0 - 1) * plane] = v
        return math.sqrt(float(tree_sum(torch.tensor(r * r))))  # the kernel's __dsqrt_rn

    f0 = fn = norm(0)
    tol = max(solver.rtol * f0, solver.atol)
    its = 0
    while (fn > tol and its < solver.max_it) if sweeps is None else its < sweeps:
        for lv in range(plan.levels):
            pushes = []
            for k, (r0, rows) in enumerate(slabs):
                code = lists[k, cptr[k, lv] : cptr[k, lv + 1]].astype(np.int64)
                acc, f = chains(k, code, swp)
                v = acc / np.asarray(diag)[f]
                xs[k, code] = v
                t = code - f * fs
                down, up = (t < 2 * plane) & (k > 0), (t >= rows * plane) & (k < nb - 1)
                assert (down.sum(), up.sum()) == tuple(sends[k, lv])
                if k > 0:
                    pushes.append((k - 1, code[down] + slabs[k - 1][1] * plane, v[down]))
                if k < nb - 1:
                    pushes.append((k + 1, code[up] - rows * plane, v[up]))
            for k, at, v in pushes:
                xs[k, at] = v
        its += 1
        fn = norm(its)
    x = (bf if its > 0 else xf).copy()
    for k, (r0, rows) in enumerate(slabs):
        nodes = np.arange(r0 * plane, (r0 + rows) * plane)
        keep = ~bdry[nodes]
        for f in (0, 1):
            x[f, nodes[keep]] = xs[k, f * fs + plane : f * fs + (rows + 1) * plane][keep]
    return x.reshape((2,) + shape), its, fn, f0


# (element, cells, blocks, max_it): full solves on one block and two, the
# clusters of 4 and 16 blocks capped (the twin's count then the cap)
EMULATED = [("triangle", (8, 8), 1, 50), ("tet", (4, 4, 4), 1, 50), ("triangle", (16, 16), 2, 50000),
            ("triangle", (32, 32), 4, 30), ("tet", (12, 12, 12), 4, 5), ("hex", (8, 8, 8), 2, 8),
            ("triangle", (48, 48), 16, 4)]


@pytest.mark.parametrize("element,cells,blocks,max_it", EMULATED, ids=[f"{c[0]}{c[1][0]}-{c[2]}" for c in EMULATED])
def test_kernel_algorithm_equals_the_twin_bit_for_bit(element, cells, blocks, max_it):
    """The slab algorithm, run through the kernel's own tables in numpy,
    equals FusedGSSolver.plain bit for bit: x, the iteration count and both
    norms, on the manufactured Picard problem."""
    _, solver, b, x0 = _problem(element, cells, rtol=1e-8, atol=1e-50, max_it=max_it, blocks=blocks)
    assert solver.plan.blocks == blocks
    twin = solver.plain(b, x0)
    x, its, fn, f0 = _emulate_kernel(solver, b, x0)
    assert its == twin.iterations > 0
    assert (fn, f0) == (twin.residual_norm, twin.initial_norm)
    assert np.array_equal(x, twin.x.numpy())


@pytest.mark.parametrize("element,cells", [("triangle", (9, 7)), ("hex", (4, 4, 4)), ("tet", (5, 4, 6))])
def test_kernel_sweep_is_the_sweepers_bit_for_bit(element, cells):
    """One sweep of the kernel's rows from a random iterate (its lists: the
    system's nonzero entries less the diagonal, x 0.0 at boundary nodes)
    equals GaussSeidelSweeper.plain, boundary rows (b / 1.0) included."""
    mesh = StructuredMesh(cells=cells, element=element)
    params = DPPParameters(k1=1.2, beta=0.9)
    rng = np.random.default_rng(2)
    state = from_numpy_state({"k1": 1.2, "beta": 0.9}, cells, element, *(rng.standard_normal(mesh.node_shape)
                                                                         for _ in range(2)), device="cpu")
    solver = FusedGSSolver(DPPOperator(state.W, state.params))
    x, b = (torch.tensor(rng.standard_normal((2,) + tuple(mesh.node_shape))) for _ in range(2))
    got, its, _, _ = _emulate_kernel(solver, b, x, sweeps=1)
    assert its == 1 and params == state.params
    assert torch.equal(torch.tensor(got).reshape(-1), solver.sweeper.plain(x.reshape(-1), b.reshape(-1)))


# -- the route --------------------------------------------------------------------


def test_cpu_route_takes_the_twin_and_launches_nothing(monkeypatch):
    """trisolve_backend=wavefront on the CPU: the solve is FusedGSSolver's
    twin (called once), no kernel launched, the count and x its own."""
    calls = []
    plain = FusedGSSolver.plain
    monkeypatch.setattr(FusedGSSolver, "plain", lambda self, b, x0, *tols: calls.append(1) or plain(self, b, x0, *tols))
    _build_nonlinear_solver.cache_clear()
    state = _state("tet", (4, 4, 4))
    before = dict(_cuda.KERNEL_LAUNCHES)
    try:
        sol = solve_dpp_nonlinear(state.W, state.params, state.bcs, {**PICARD, "trisolve_backend": "wavefront"})
    finally:
        _build_nonlinear_solver.cache_clear()
    assert calls == [1] and dict(_cuda.KERNEL_LAUNCHES) == before
    _, solver, b, x0 = _problem("tet", (4, 4, 4), **SNES_KW)
    twin = solver.plain(b, x0)
    assert sol.iteration_number == twin.iterations
    assert all(torch.equal(a, t) for a, t in zip(sol.solution.data, twin.x))


def test_partri_keeps_its_host_loop(monkeypatch):
    """trisolve_backend=partri: the host loop with PartriGS sweeps (the
    twin is not called), its result gs_host_loop's bit for bit."""
    monkeypatch.setattr(FusedGSSolver, "plain", lambda self, b, x0, *tols: pytest.fail("the twin ran for partri"))
    _build_nonlinear_solver.cache_clear()
    state = _state("triangle", (4, 4))
    try:
        sol = solve_dpp_nonlinear(state.W, state.params, state.bcs, {**PICARD, "trisolve_backend": "partri"})
    finally:
        _build_nonlinear_solver.cache_clear()
    op = DPPOperator(state.W, state.params)
    b = torch.stack(op.lifted_rhs(*state.grids))
    x0 = torch.stack([torch.where(op._mask_arrays[0], g, 0.0) for g in state.grids])
    sweeper = PartriGS.for_monolithic(state.mesh, state.params, "cpu")
    loop = gs_host_loop(op, sweeper, b, x0, **{k: v for k, v in SNES_KW.items()})
    assert sol.iteration_number == loop.iterations > 0
    assert all(torch.equal(a, t) for a, t in zip(sol.solution.data, loop.x))


def test_the_sweeper_is_built_only_where_it_sweeps(monkeypatch):
    """The route builds no GaussSeidelSweeper for the wavefront (a launch
    within the plan needs none); FusedGSSolver builds its own once, at its
    twin's first sweep, and sweeps with a sweeper given to it."""
    built = []
    build = GaussSeidelSweeper.for_monolithic.__func__
    monkeypatch.setattr(GaussSeidelSweeper, "for_monolithic",
                        classmethod(lambda cls, *a, **kw: built.append(1) or build(cls, *a, **kw)))
    state = _state("tet", (4, 4, 4))
    assert _ngs_sweeper(state.mesh, state.params, "cpu", "wavefront", build_wavefront=False) is None
    op, solver, b, x0 = _problem("tet", (4, 4, 4), **SNES_KW)
    assert solver.plan is not None and built == []
    first, second = solver.plain(b, x0), solver.plain(b, x0)
    assert built == [1] and torch.equal(first.x, second.x)
    given = build(GaussSeidelSweeper, state.mesh, state.params, "cpu")
    assert FusedGSSolver(op, given).sweeper is given and built == [1]


def test_validation_errors():
    """A quad mesh (fused_ngs's), a sweeper of another mesh, a tensor on
    another device than the solver's, and a launch on CPU tensors raise."""
    state = _state("quad", (4, 4))
    with pytest.raises(ValueError, match="tri/hex/tet"):
        FusedGSSolver(DPPOperator(state.W, state.params))
    op, solver, b, x0 = _problem("triangle", (4, 4))
    other = GaussSeidelSweeper.for_monolithic(StructuredMesh(cells=(5, 5), element="triangle"), DPPParameters(), "cpu")
    with pytest.raises(ValueError, match="another mesh"):
        FusedGSSolver(op, other)
    with pytest.raises(ValueError, match="kernels take CUDA tensors"):
        solver.launch(b, x0)
    with pytest.raises(ValueError, match="tensor on meta"):
        solver(b.to("meta"), x0)
