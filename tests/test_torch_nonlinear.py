"""Slice 5, the Picard solve: the port's ``solve_dpp_nonlinear`` and its
parts against the JAX package's on the CPU, in float64, on the same inputs
(the manufactured boundary data, or numpy draws from a seed).

The lexicographic Gauss-Seidel sweep is compared on both trisolve backends:
the JAX package's default, the parallel-prefix partri scan, against the
port's ``trisolve_backend`` left open (partri on the CPU), and its wavefront
path (``PERPHIL_TPU_TRISOLVE=wavefront``) against the port's
``trisolve_backend=wavefront``. The JAX package's solver caches do not key
on the environment it reads, hence the ``cache_clear``. The kernels themselves are held to their twins on the
card in ``tests/test_torch_kernels.py`` (the machine with the card has no
JAX)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.forms.dpp as jdpp
import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.solvers.parameters as jsp
from perphil_tpu.forms import Function as JFunction
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops import ilu as jilu
from perphil_tpu.ops.assembly import DirichletBC as JBC
from perphil_tpu.ops.ordering import ngs_parity_coloring as jcoloring
from perphil_tpu.solvers import solve_dpp_nonlinear as jsolve_nonlinear
from perphil_tpu.solvers import solver as jsolver
from perphil_tpu.utils import manufactured_solutions as jms

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.forms import (
    DPPResidualForm,
    FieldLinearForm,
    Function,
    dpp_delayed_form,
    dpp_form,
    dpp_splitted_form,
)
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.ops.fused_ngs import (
    BANKS,
    FusedNGSSolver,
    _deal,
    NgsPlan,
    fused_ngs_plan,
    ngs_host_loop,
    ngs_tables,
    slab_rows,
    tree_slots,
)
from perphil_tpu_torch.ops.ilu import GS_BACKENDS, ColoredNGSSweeper, GaussSeidelSweeper
from perphil_tpu_torch.ops.krylov import tree_sum, tree_sum_cluster
from perphil_tpu_torch.ops.ordering import colored_ngs_sweeps, ngs_parity_coloring
from perphil_tpu_torch.solvers import solve_dpp_nonlinear
from perphil_tpu_torch.solvers.solver import _build_nonlinear_solver, _freeze

# the reference's published Picard column (petsc_perf_breakdown-with-picard.csv,
# "Scaling-Splitting Picard with MUMPS"), as tests/test_parity_regression.py pins it
PICARD_COUNTS = {4: 16, 8: 63, 16: 194, 32: 635}


@pytest.fixture
def trisolve(request, monkeypatch):
    """The JAX package's lexicographic Gauss-Seidel on one backend (the
    parameter): its default partri scan, or its wavefront sweep; the port's
    ``trisolve_backend`` option for the same backend (partri: left open)."""
    if request.param == "wavefront":
        monkeypatch.setenv("PERPHIL_TPU_TRISOLVE", "wavefront")
    else:
        monkeypatch.delenv("PERPHIL_TPU_TRISOLVE", raising=False)
    jsolver._build_nonlinear_solver.cache_clear()
    yield request.param
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


def _both(element, cells, preset, port_options=None):
    """The same Picard solve through both packages on the manufactured
    boundary data, the port's with ``port_options`` on top: (JAX Solution,
    port Solution)."""
    g1, g2 = _manufactured(element, cells)
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    _, jV = jspaces_of(mesh)
    jW = jmixed(jV)
    jbcs = [JBC(jW.sub(0), jnp.asarray(g1)), JBC(jW.sub(1), jnp.asarray(g2))]
    ref = jsolve_nonlinear(jW, JParams(), jbcs, solver_parameters=preset)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    got = solve_dpp_nonlinear(state.W, state.params, state.bcs, solver_parameters={**preset, **(port_options or {})})
    return ref, got


# A final norm is that of a residual ~rtol times the first one: b - A x
# cancels all but ~eps / rtol (1e-8) of its bits, which two packages
# summing in other orders do not share.
_NORM_TOL = 1e-6


def _check_fields(ref, got, tol):
    for a, b in zip(got.solution.data, ref.solution.data):
        assert a.device.type == "cpu" and a.dtype == torch.float64
        assert _rel(a.numpy(), b) <= tol


# -- the colouring and the sweepers ------------------------------------------


@pytest.mark.parametrize("N,ncolors", [(4, 11), (8, 11), (16, 13), (32, 14)])
def test_coloring_equals_jax(N, ncolors):
    colors = ngs_parity_coloring(StructuredMesh(cells=(N, N), element="quad"))
    ref = jcoloring(jmesh.StructuredMesh(cells=(N, N), element="quad"))
    assert colors.dtype == np.int32 and colors.shape == ((N + 1) ** 2 * 2,)
    np.testing.assert_array_equal(colors, ref)
    assert int(colors.max()) + 1 == ncolors


def test_coloring_is_distance_one_and_lands_the_published_count():
    """No DoF shares a colour with a DoF it couples to, and the scipy
    yardstick sweeps the published count at N=8 with it."""
    from perphil_tpu.ops.ordering import to_csr

    mesh = jmesh.StructuredMesh(cells=(8, 8), element="quad")
    colors = ngs_parity_coloring(StructuredMesh(cells=(8, 8), element="quad"))
    A = to_csr(jilu.build_monolithic_system(mesh, JParams())).tocoo()
    off = A.row != A.col
    assert not np.any(colors[A.row[off]] == colors[A.col[off]])
    g1, g2 = _manufactured("quad", (8, 8))
    state = from_numpy_state({}, (8, 8), "quad", g1, g2, device="cpu")
    op = DPPOperator(state.W, state.params)
    b = torch.cat([t.reshape(-1) for t in op.lifted_rhs(*state.grids)]).numpy()
    bdry = state.mesh.boundary_mask()
    x0 = np.concatenate([np.where(bdry, g, 0.0).ravel() for g in (g1, g2)])
    assert colored_ngs_sweeps(A.tocsr(), b, x0, colors) == PICARD_COUNTS[8]


def test_colored_sweep_matches_jax():
    """One sweep from a random iterate, boundary rows included: <= 1e-13
    relative (the two sum the same terms; XLA may fuse a product into its
    sum)."""
    rng = np.random.default_rng(0)
    params = {"k1": 1.2, "beta": 0.9}
    jswp = jilu.ColoredNGSSweeper.for_monolithic(jmesh.StructuredMesh(cells=(8, 8), element="quad"), JParams(**params))
    swp = ColoredNGSSweeper(StructuredMesh(cells=(8, 8), element="quad"), DPPParameters(**params), device="cpu")
    x, b = rng.standard_normal(2 * 81), rng.standard_normal(2 * 81)
    ref = np.asarray(jswp.sweep(jnp.asarray(x), jnp.asarray(b)))
    got = swp.sweep(torch.tensor(x), torch.tensor(b))
    assert got.shape == (162,) and _rel(got.numpy(), ref) <= 1e-13


GS_MESHES = [("triangle", (4, 4)), ("hex", (3, 3, 3)), ("tet", (3, 3, 3))]


@pytest.mark.parametrize("trisolve", ["wavefront", "partri"], indirect=True)
@pytest.mark.parametrize("element,cells", GS_MESHES, ids=[m[0] for m in GS_MESHES])
def test_gauss_seidel_sweep_matches_jax(trisolve, element, cells):
    """One forward sweep from a random iterate on one backend: <= 1e-13
    relative (the wavefront: the same terms in the same order; partri: the
    same maps, composed by other matmuls)."""
    rng = np.random.default_rng(1)
    params = {"k1": 1.2, "beta": 0.9}
    jswp = jilu.GaussSeidelSweeper.for_monolithic(jmesh.StructuredMesh(cells=cells, element=element), JParams(**params))
    assert (jswp.partri is not None) == (trisolve == "partri")
    mesh = StructuredMesh(cells=cells, element=element)
    swp = GS_BACKENDS[trisolve].for_monolithic(mesh, DPPParameters(**params), "cpu")
    n = 2 * mesh.num_vertices
    x, b = rng.standard_normal(n), rng.standard_normal(n)
    ref = np.asarray(jswp.sweep(jnp.asarray(x), jnp.asarray(b)))
    got = swp.sweep(torch.tensor(x), torch.tensor(b))
    assert _rel(got.numpy(), ref) <= 1e-13


# -- solve_dpp_nonlinear against the JAX package -----------------------------


@pytest.mark.parametrize("N", sorted(PICARD_COUNTS))
def test_picard_ngs_lands_the_published_column(N):
    """PICARD_LU_SOLVER_PARAMS at 2D N=4/8/16/32: 16/63/194/635, equal to the
    JAX package's; fields <= 1e-10 relative (the same trajectory; the norms
    sum in other orders); final norms <= 1e-6 relative (_NORM_TOL)."""
    ref, got = _both("quad", (N, N), jsp.PICARD_LU_SOLVER_PARAMS)
    assert got.iteration_number == ref.iteration_number == PICARD_COUNTS[N]
    _check_fields(ref, got, 1e-10)
    assert abs(got.residual_error - ref.residual_error) <= _NORM_TOL * abs(ref.residual_error)


SNES_CASES = [
    ("quad", (4, 4), "block_gs", "wavefront"), ("quad", (8, 8), "block_gs", "wavefront"),
    ("quad", (4, 4), "RICHARDSON_SOLVER_PARAMS", "wavefront"), ("quad", (8, 8), "RICHARDSON_SOLVER_PARAMS", "wavefront"),
    ("quad", (4, 4), "KSP_PREONLY_PARAMS", "wavefront"), ("quad", (8, 8), "KSP_PREONLY_PARAMS", "wavefront"),
    ("triangle", (4, 4), "PICARD_LU_SOLVER_PARAMS", "wavefront"), ("tet", (3, 3, 3), "PICARD_LU_SOLVER_PARAMS", "wavefront"),
    # the lexicographic GS on the JAX package's default path, the port's option left open
    ("triangle", (4, 4), "PICARD_LU_SOLVER_PARAMS", "partri"), ("tet", (3, 3, 3), "PICARD_LU_SOLVER_PARAMS", "partri"),
]


@pytest.mark.parametrize(
    "element,cells,preset,trisolve", SNES_CASES, ids=[f"{c[0]}{c[1][0]}-{c[2]}-{c[3]}" for c in SNES_CASES],
    indirect=["trisolve"],
)
def test_snes_types_match_jax(trisolve, element, cells, preset):
    """block_gs (exact field solves), nrichardson (fieldsplit-preconditioned,
    damping 0.5), ksponly (one GMRES + fieldsplit solve; iteration 1) and the
    lexicographic ngs on tri/tet on both trisolve backends: counts equal to
    the JAX package's, fields <= 1e-10 relative, final norms <= 1e-6
    relative (_NORM_TOL)."""
    options = (
        {**jsp.PICARD_LU_SOLVER_PARAMS, "snes_type": "block_gs"} if preset == "block_gs" else getattr(jsp, preset)
    )
    ref, got = _both(element, cells, options, {"trisolve_backend": "wavefront"} if trisolve == "wavefront" else {})
    assert got.iteration_number == ref.iteration_number
    if preset == "KSP_PREONLY_PARAMS":
        assert got.iteration_number == 1
    _check_fields(ref, got, 1e-10)
    assert abs(got.residual_error - ref.residual_error) <= _NORM_TOL * abs(ref.residual_error)


def test_cpu_picard_launches_no_kernel_and_caches():
    g1, g2 = _manufactured("quad", (4, 4))
    state = from_numpy_state({}, (4, 4), "quad", g1, g2, device="cpu")
    before = dict(_cuda.KERNEL_LAUNCHES)
    first = solve_dpp_nonlinear(state.W, state.params, state.bcs, sp.PICARD_LU_SOLVER_PARAMS)
    again = solve_dpp_nonlinear(state.W, state.params, state.bcs, sp.PICARD_LU_SOLVER_PARAMS)
    assert dict(_cuda.KERNEL_LAUNCHES) == before
    assert first.iteration_number == again.iteration_number == 16
    info = _build_nonlinear_solver.cache_info()
    assert info.hits >= 1


def test_host_loop_lands_the_kernel_count():
    """The route beyond the kernel's plan (K1 residuals; its plain twin
    here) lands the same count as the kernel's twin, x within 1e-10
    relative (K1 sums in another order)."""
    g1, g2 = _manufactured("quad", (8, 8))
    state = from_numpy_state({}, (8, 8), "quad", g1, g2, device="cpu")
    op = DPPOperator(state.W, state.params)
    solver = FusedNGSSolver(op, rtol=1e-8, atol=1e-12, max_it=50000)
    b = torch.stack(op.lifted_rhs(*state.grids))
    bdry = op._mask_arrays[0]
    x0 = torch.stack([torch.where(bdry, g, 0.0) for g in state.grids])
    twin = solver(b, x0)
    loop = ngs_host_loop(op, solver.sweeper, b, x0, 1e-8, 1e-12, 50000)
    assert twin.iterations == loop.iterations == PICARD_COUNTS[8]
    assert _rel(loop.x.numpy(), twin.x.numpy()) <= 1e-10
    assert twin.residual_norm <= max(1e-8 * twin.initial_norm, 1e-12)


# -- the forms ----------------------------------------------------------------


def test_forms_match_jax():
    """FieldLinearForm.assemble (the field mass apply of the lagged
    pressure) and the DPPResidualForm residual, on numpy draws: <= 1e-14
    relative (apply_stencil's order in both)."""
    rng = np.random.default_rng(2)
    cells = (6, 5)
    mesh = jmesh.StructuredMesh(cells=cells, element="quad")
    _, jV = jspaces_of(mesh)
    jW = jmixed(jV)
    state = from_numpy_state({"k1": 1.2, "beta": 0.9}, cells, "quad", np.zeros(mesh.node_shape), np.zeros(mesh.node_shape), device="cpu")
    jparams = JParams(k1=1.2, beta=0.9)
    p1, p2, b1, b2 = (rng.standard_normal(mesh.node_shape) for _ in range(4))
    (ja, jL), (jb, jM) = jdpp.dpp_delayed_form(jV, jV, jparams, JFunction(jV, jnp.asarray(p1)), JFunction(jV, jnp.asarray(p2)))
    V = state.W.sub(0)
    (a, L), (bf, M) = dpp_delayed_form(V, V, state.params, Function(V, torch.tensor(p1)), Function(V, torch.tensor(p2)))
    assert isinstance(L, FieldLinearForm) and a.k == ja.k and bf.k == jb.k
    assert _rel(L.assemble().numpy(), np.asarray(jL.assemble())) <= 1e-14
    assert _rel(M.assemble().numpy(), np.asarray(jM.assemble())) <= 1e-14
    jF, _ = jdpp.dpp_splitted_form(jW, jparams)
    F, fields = dpp_splitted_form(state.W, state.params)
    assert isinstance(F, DPPResidualForm) and all(float(d.abs().max()) == 0.0 for d in fields.data)
    args = (p1, p2, b1, b2)
    for got, ref in zip(F(*(torch.tensor(v) for v in args)), jF(*(jnp.asarray(v) for v in args))):
        assert _rel(got.numpy(), np.asarray(ref)) <= 1e-14
    form, zero = dpp_form(state.W, state.params)
    assert form.operator() == DPPOperator(state.W, state.params) and zero.W is state.W


# -- validation ---------------------------------------------------------------


def test_validation_errors():
    state = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    with pytest.raises(TypeError, match="atol_abs"):  # the continuation's five-argument solve
        solve_dpp_nonlinear(state.W, state.params, state.bcs, {**sp.PICARD_LU_SOLVER_PARAMS, "_x0_continuation": True})
    with pytest.raises(ValueError, match="Unsupported snes_type"):
        solve_dpp_nonlinear(state.W, state.params, state.bcs, {"snes_type": "newtonls"})
    with pytest.raises(ValueError, match="2-field"):
        solve_dpp_nonlinear(state.W.sub(0), state.params, state.bcs, sp.PICARD_LU_SOLVER_PARAMS)
    with pytest.raises(ValueError, match="2-field"):
        dpp_form(state.W.sub(0), state.params)
    tri = StructuredMesh(cells=(4, 4), element="triangle")
    with pytest.raises(ValueError, match="quad"):
        ngs_parity_coloring(tri)
    with pytest.raises(ValueError, match="quad"):
        ColoredNGSSweeper(tri, state.params, device="cpu")
    tstate = from_numpy_state({}, (4, 4), "triangle", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    with pytest.raises(ValueError, match="quad"):
        FusedNGSSolver(DPPOperator(tstate.W, tstate.params))
    solver = FusedNGSSolver(DPPOperator(state.W, state.params))
    x = torch.zeros((2, 5, 5), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        solver.launch(x, x)
    with pytest.raises(ValueError, match="built for"):
        solver(x.to("meta"), x)
    swp = GaussSeidelSweeper.for_monolithic(tri, state.params, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        swp.launch(torch.zeros(50, dtype=torch.float64), torch.zeros(50, dtype=torch.float64))


def test_nonlinear_solver_cache_is_keyed_on_options():
    state = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    a = _build_nonlinear_solver(state.W, state.params, _freeze(sp.PICARD_LU_SOLVER_PARAMS))
    b = _build_nonlinear_solver(state.W, state.params, _freeze(sp.PICARD_GMRES_SOLVER_PARAMS))
    assert a is _build_nonlinear_solver(state.W, state.params, _freeze(sp.PICARD_LU_SOLVER_PARAMS))
    assert a is not b


# -- the kernel's plan and tables (host mirrors) --------------------------------

# worked by hand from csrc/fused_ngs.cu::ngs_geometry: L = 2 (N+1)^2 values;
# blocks = the most of 16, 8, 4, 2, 1 that place the grid: at most the
# N - 1 interior rows and Lt / 512 (Lt: the power of two at least 512 and
# L), the tree at most 32 leaves a thread (leaves = the least power of two
# with 512 blocks leaves >= L), and bytes within 230,400; rows = ceil((N - 1)
# / blocks); nloc = 4 (L // 4b) + min(L % 4b, 4); width = 2 rows (N - 1);
# bytes = 16 (rows + 2)(N + 1) [x and its halo] + 16 rows (N + 1) [b] +
# 8 nloc [the tree's slice] + 2 width [the list], each rounded up to 16
PLAN_TABLE = [
    (4, NgsPlan(1, 3, 1, 50, 18, 1088)),  # 400 + 240 + 400 + 48
    (8, NgsPlan(1, 7, 1, 162, 98, 3808)),  # 1296 + 1008 + 1296 + 208
    (16, NgsPlan(2, 8, 1, 290, 240, 7696)),  # 2720 + 2176 + 2320 + 480; Lt = 1024: 2 blocks at most
    (32, NgsPlan(8, 4, 1, 274, 248, 7968)),  # 3168 + 2112 + 2192 + 496; Lt = 4096
    (64, NgsPlan(16, 4, 2, 530, 504, 15648)),  # 6240 + 4160 + 4240 + 1008
    (128, NgsPlan(16, 8, 8, 2082, 2032, 57872)),  # 20640 + 16512 + 16656 + 4064
    (255, NgsPlan(16, 16, 16, 8192, 8128, 221056)),  # 73728 + 65536 + 65536 + 16256
    (257, NgsPlan(16, 16, 32, 8324, 8192, 223328)),  # the last 2D mesh in: 74304 + 66048 + 66592 + 16384
    (258, None),  # rows 17: 78736 + 70448 + 67080 + 17476 = 233,740 B on 16 blocks
]


@pytest.mark.parametrize("N,plan", PLAN_TABLE, ids=[str(p[0]) for p in PLAN_TABLE])
def test_plan_mirror_table(N, plan):
    assert fused_ngs_plan((N + 1, N + 1), 14) == plan


def test_plan_refuses_what_the_launcher_refuses():
    assert fused_ngs_plan((9, 9), 32) is not None
    assert fused_ngs_plan((9, 9), 33) is None
    assert fused_ngs_plan((9, 9), 0) is None
    assert fused_ngs_plan((5, 5, 5), 14) is None
    # an explicit block count: a power of two, at most the interior rows, Lt / 512 and 16
    assert fused_ngs_plan((129, 129), 14, blocks=4) == NgsPlan(4, 32, 32, 8322, 8128, 219056)
    assert fused_ngs_plan((129, 129), 14, blocks=2) is None  # 64 leaves a thread
    assert fused_ngs_plan((129, 129), 14, blocks=12) is None
    assert fused_ngs_plan((17, 17), 14, blocks=4) is None  # Lt = 1024: 2 blocks at most
    assert fused_ngs_plan((5, 5), 14, blocks=2) is None  # Lt = 512: 1 block
    assert fused_ngs_plan((256, 256), 14, blocks=8) is None  # 32 rows: 270,464 B


def _tables(N, blocks=None):
    mesh = StructuredMesh(cells=(N, N), element="quad")
    colors = ngs_parity_coloring(mesh)
    plan = fused_ngs_plan(mesh.node_shape, int(colors.max()) + 1, blocks)
    return mesh, colors, plan, ngs_tables(mesh.node_shape, colors, plan)


def _decode(code, plan, nx, r0):
    """(field, node row, column) of a list entry on the block whose slab
    starts at node row r0."""
    fs = (plan.rows + 2) * nx
    f = code // fs
    row, i = np.divmod(code - f * fs, nx)
    return f, r0 - 1 + row, i


TABLE_SIZES = [4, 16, 32, 128]


@pytest.mark.parametrize("N", TABLE_SIZES)
def test_lists_hold_each_interior_row_once_in_its_colour_run(N):
    """Every interior row lies on exactly one block, inside that block's
    slab, in its colour's run, once; the padding is 0."""
    mesh, colors, plan, (lists, cptr, sends) = _tables(N)
    ny, nx = mesh.node_shape
    ncolors = int(colors.max()) + 1
    assert lists.dtype == np.uint16 and lists.shape == (plan.blocks, plan.width)
    assert cptr.shape == (plan.blocks, ncolors + 1) and sends.shape == (plan.blocks, ncolors, 2)
    seen = []
    for b, (r0, rows) in enumerate(slab_rows(ny, plan.blocks)):
        assert rows <= plan.rows and np.all(lists[b, cptr[b, -1]:] == 0)
        for c in range(ncolors):
            run = lists[b, cptr[b, c] : cptr[b, c + 1]].astype(np.int64)
            f, j, i = _decode(run, plan, nx, r0)
            assert np.all((j >= r0) & (j < r0 + rows)) and np.all((i > 0) & (i < nx - 1))
            e = f * ny * nx + j * nx + i
            assert np.all(colors[e] == c) and np.unique(run).size == run.size
            seen.append(e)
    interior = np.tile(~mesh.boundary_mask().ravel(), 2)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.flatnonzero(interior))


def test_deal_takes_every_bank_in_turn():
    """Rows of banks 0, 0, 0, 1, 1, 2 (offset order) go out one bank at a
    time, the fullest first: 0, 1, 2, then 0, 1, then 0."""
    np.testing.assert_array_equal(_deal(np.arange(6), np.array([0, 0, 0, 1, 1, 2])), [0, 3, 5, 1, 4, 2])


@pytest.mark.parametrize("N", [128, 255])
def test_colour_runs_are_dealt_by_bank(N):
    """A warp's 32 rows of a colour meet fewer rows on their busiest bank
    than the same runs in offset order (a tap's bank is the row's offset in
    the field modulo 16 plus the tap's constant), where a block's colour
    holds more than a warp's rows."""
    mesh, colors, plan, (lists, cptr, _) = _tables(N)
    fs = (plan.rows + 2) * mesh.node_shape[1]

    def busiest(run):
        within = run.astype(np.int64) % fs
        return [np.bincount(within[g : g + 32] % BANKS, minlength=BANKS).max() for g in range(0, run.size, 32)]

    dealt, in_order = [], []
    for b in range(plan.blocks):
        for c in range(cptr.shape[1] - 1):
            run = lists[b, cptr[b, c] : cptr[b, c + 1]]
            dealt += busiest(run)
            in_order += busiest(np.sort(run))
    assert np.mean(dealt) < 0.8 * np.mean(in_order)


@pytest.mark.parametrize("N", TABLE_SIZES)
def test_every_tap_is_owned_or_in_the_halo(N):
    """A row's 18 taps land on an interior node of the block's own slab or
    of its halo rows, or on a boundary node, which the slab holds as 0.0;
    every offset stays within the block's x (2 (rows + 2) nx values)."""
    mesh, colors, plan, (lists, cptr, _) = _tables(N)
    ny, nx = mesh.node_shape
    fs = (plan.rows + 2) * nx
    for b, (r0, rows) in enumerate(slab_rows(ny, plan.blocks)):
        run = lists[b, : cptr[b, -1]].astype(np.int64)
        f, j, i = _decode(run, plan, nx, r0)
        for t in range(18):
            dy, dx = (t % 9) // 3 - 1, t % 3 - 1
            jj, ii = j + dy, i + dx
            assert np.all((jj >= r0 - 1) & (jj <= r0 + rows))  # own rows or a halo row
            tap = (t // 9) * fs + run - f * fs + dy * nx + dx
            assert np.all((tap >= 0) & (tap < 2 * fs))
            np.testing.assert_array_equal(_decode(tap, plan, nx, r0), ((t // 9) + 0 * tap, jj, ii))


@pytest.mark.parametrize("N", TABLE_SIZES)
def test_every_halo_value_is_sent_by_its_owner_in_its_colour(N):
    """Each interior value of a halo row is pushed by the block that owns
    its row, in the phase of its colour, and nothing else is: the counts in
    ``sends`` are the values of each colour on a block's first row (to the
    block below) and last row (to the block above)."""
    mesh, colors, plan, (lists, cptr, sends) = _tables(N)
    ny, nx = mesh.node_shape
    ncolors = int(colors.max()) + 1
    slabs = slab_rows(ny, plan.blocks)
    received = [dict() for _ in slabs]  # block -> {value e: colour of the phase that sent it}
    for b, (r0, rows) in enumerate(slabs):
        for c in range(ncolors):
            run = lists[b, cptr[b, c] : cptr[b, c + 1]].astype(np.int64)
            f, j, i = _decode(run, plan, nx, r0)
            e = f * ny * nx + j * nx + i
            down, up = (j == r0) & (b > 0), (j == r0 + rows - 1) & (b < plan.blocks - 1)
            assert sends[b, c, 0] == down.sum() and sends[b, c, 1] == up.sum()
            received[b - 1].update(dict.fromkeys(e[down].tolist(), c)) if b > 0 else None
            received[b + 1].update(dict.fromkeys(e[up].tolist(), c)) if b < plan.blocks - 1 else None
    for b, (r0, rows) in enumerate(slabs):
        halo = [r for r in (r0 - 1, r0 + rows) if 0 < r < ny - 1]
        want = {f * ny * nx + r * nx + i for f in (0, 1) for r in halo for i in range(1, nx - 1)}
        assert set(received[b]) == want
        assert all(colors[e] == c for e, c in received[b].items())


@pytest.mark.parametrize("N", TABLE_SIZES)
def test_tree_slots_place_the_squares_for_the_cluster_tree(N):
    """The norm's map from a value to its tree owner's slot is a bijection
    onto the blocks' first ``nloc`` slots, [0, L) in all, and the cluster
    tree over the squares so placed equals tree_sum bit for bit."""
    mesh, colors, plan, _ = _tables(N)
    L = colors.size
    owner, slot = tree_slots(L, plan.blocks)
    flat = owner * plan.nloc + slot
    assert slot.max() < plan.nloc and np.unique(flat).size == L
    assert np.all(np.bincount(owner, minlength=plan.blocks) <= plan.nloc)
    rng = np.random.default_rng(N)
    r = rng.standard_normal(L) * np.tile(~mesh.boundary_mask().ravel(), 2)
    held = np.zeros((plan.blocks, plan.nloc))
    held[owner, slot] = r
    # the kernel's leaves: thread tau of block b holds slot s * 512 + lam, value e = ((slot >> 2) nb + b) 4 + (slot & 3)
    back = held[owner, slot]
    sq = torch.tensor(back * back)
    assert torch.equal(tree_sum_cluster(sq, plan.blocks), tree_sum(torch.tensor(r * r)))


def _emulate_kernel(solver, b, x0):
    """The kernel's algorithm in numpy, through its tables: per block a slab
    of x with its halo rows (boundary nodes 0.0), b's slab, the residuals in
    their tree slots; a colour's pushes reach the neighbours' halos before
    the next phase, and each block's pushes in a colour are counted against
    ``sends``. Returns (x, iterations, fn, f0)."""
    plan, sw = solver.plan, solver.sweeper
    ny, nx = solver.node_shape
    n, L, nb, R = ny * nx, 2 * ny * nx, plan.blocks, plan.rows
    fs = (R + 2) * nx
    lists, cptr, sends = ngs_tables(solver.node_shape, sw.colors, plan)
    slabs = slab_rows(ny, nb)
    owner, slot = tree_slots(L, nb)
    inner = np.zeros((ny, nx), bool)
    inner[1:-1, 1:-1] = True
    bf, xf = b.numpy().reshape(2, ny, nx), x0.numpy().reshape(2, ny, nx)
    xs, bs = np.zeros((nb, 2 * fs)), np.zeros((nb, 2 * R * nx))
    for k, (r0, rows) in enumerate(slabs):
        for l in range(rows + 2):
            xs[k, [l * nx, fs + l * nx] + np.arange(nx)[:, None]] = np.where(
                inner[r0 - 1 + l], xf[:, r0 - 1 + l], 0.0).T
        for f in (0, 1):
            bs[k, f * R * nx : f * R * nx + rows * nx] = bf[f, r0 : r0 + rows].ravel()
    rt = np.zeros((nb, plan.nloc))
    w, diag = sw.weights, np.asarray(sw.diag)

    def rows_of(k, lo, hi):
        code = lists[k, lo:hi].astype(np.int64)
        f = (code >= fs).astype(np.int64)
        return code, f, code - f * fs + f * n + (slabs[k][0] - 1) * nx

    def residual(k, code, f):
        acc = np.zeros(code.size)
        for t in range(18):
            dy, dx = (t % 9) // 3 - 1, t % 3 - 1
            acc = acc + w[f, t] * xs[k, (t // 9) * fs + code - f * fs + dy * nx + dx]
        return bs[k, code - nx - 2 * nx * f] - acc

    def norm():
        for k in range(nb):
            code, f, e = rows_of(k, 0, cptr[k, -1])
            rt[owner[e], slot[e]] = residual(k, code, f)
        v = torch.tensor(rt[owner, slot])
        return math.sqrt(float(tree_sum_cluster(v * v, nb)))  # the kernel's __dsqrt_rn

    f0 = fn = norm()
    tol = max(solver.rtol * f0, solver.atol)
    its = 0
    while fn > tol and its < solver.max_it:
        for c in range(sw.ncolors):
            pushes = []
            for k, (r0, rows) in enumerate(slabs):
                code, f, e = rows_of(k, cptr[k, c], cptr[k, c + 1])
                r = rt[owner[e], slot[e]] if c == 0 else residual(k, code, f)
                v = xs[k, code] + r / diag[f]
                xs[k, code] = v
                t = code - f * fs
                down, up = (t < 2 * nx) & (k > 0), (t >= rows * nx) & (k < nb - 1)
                assert (down.sum(), up.sum()) == tuple(sends[k, c])
                if k > 0:
                    pushes.append((k - 1, code[down] + slabs[k - 1][1] * nx, v[down]))
                if k < nb - 1:
                    pushes.append((k + 1, code[up] - rows * nx, v[up]))
            for k, at, v in pushes:
                xs[k, at] = v
        fn = norm()
        its += 1
    x = xf.copy()
    for k, (r0, rows) in enumerate(slabs):
        for f in (0, 1):
            x[f, r0 : r0 + rows, 1:-1] = xs[k, f * fs + nx : f * fs + (rows + 1) * nx].reshape(rows, nx)[:, 1:-1]
    return x, its, fn, f0


@pytest.mark.parametrize("N,blocks,max_it", [(4, 1, 50000), (8, 1, 50000), (16, 2, 50000), (16, 1, 50000),
                                               (32, 8, 40), (32, 4, 40), (64, 16, 6)])
def test_kernel_algorithm_equals_the_twin_bit_for_bit(N, blocks, max_it):
    """The slab algorithm, run through the kernel's own tables in numpy,
    equals FusedNGSSolver.plain bit for bit: x, the iteration count and both
    norms, on the manufactured Picard problem (the published count where the
    solve runs to convergence)."""
    g1, g2 = _manufactured("quad", (N, N))
    state = from_numpy_state({}, (N, N), "quad", g1, g2, device="cpu")
    op = DPPOperator(state.W, state.params)
    solver = FusedNGSSolver(op, rtol=1e-8, atol=1e-50, max_it=max_it, blocks=blocks)
    assert solver.plan.blocks == blocks
    b = torch.stack(op.lifted_rhs(*state.grids))
    bdry = op._mask_arrays[0]
    x0 = torch.stack([torch.where(bdry, g, 0.0) for g in state.grids])
    twin = solver.plain(b, x0)
    x, its, fn, f0 = _emulate_kernel(solver, b, x0)
    assert its == twin.iterations == (PICARD_COUNTS[N] if max_it == 50000 else max_it)
    assert (fn, f0) == (twin.residual_norm, twin.initial_norm)
    assert np.array_equal(x, twin.x.numpy())
