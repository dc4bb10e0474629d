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
    FusedNGSSolver,
    NgsPlan,
    fused_ngs_plan,
    ngs_host_loop,
    owner_lists,
)
from perphil_tpu_torch.ops.ilu import GS_BACKENDS, ColoredNGSSweeper, GaussSeidelSweeper
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
    with pytest.raises(NotImplementedError, match="slice 10"):
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


# -- the kernel's plan and lists (host mirrors) ---------------------------------

# worked by hand from csrc/fused_ngs.cu::ngs_geometry: L = 2 (N+1)^2 values,
# padded to Lt (a power of two, at least 512); blocks = min(16, Lt / 512);
# leaves = Lt / (512 blocks); a block owns nloc = 4 (L // 4b) + min(L % 4b, 4);
# bytes = 28 nloc rounded up to 16, at most 230,400
PLAN_TABLE = [
    (4, NgsPlan(1, 1, 50, 1408)),
    (8, NgsPlan(1, 1, 162, 4544)),
    (16, NgsPlan(2, 1, 290, 8128)),
    (32, NgsPlan(8, 1, 274, 7680)),
    (64, NgsPlan(16, 2, 530, 14848)),
    (128, NgsPlan(16, 8, 2082, 58304)),
    (255, NgsPlan(16, 16, 8192, 229376)),  # the last 2D mesh in
    (256, None),  # 32 leaves a thread: 8258 values a block, 231,224 B
]


@pytest.mark.parametrize("N,plan", PLAN_TABLE, ids=[str(p[0]) for p in PLAN_TABLE])
def test_plan_mirror_table(N, plan):
    assert fused_ngs_plan((N + 1, N + 1), 14) == plan


def test_plan_refuses_what_the_launcher_refuses():
    assert fused_ngs_plan((9, 9), 32) is not None
    assert fused_ngs_plan((9, 9), 33) is None
    assert fused_ngs_plan((9, 9), 0) is None
    assert fused_ngs_plan((5, 5, 5), 14) is None


@pytest.mark.parametrize("N", [4, 16, 32])
def test_owner_lists_cover_each_interior_row_once(N):
    """Every interior row appears once, on its owner, in its colour's run
    (the kernel's ownership: value e on block (e >> 2) mod nb, slot
    ((e >> 2) // nb) * 4 + e mod 4)."""
    mesh = StructuredMesh(cells=(N, N), element="quad")
    colors = ngs_parity_coloring(mesh)
    plan = fused_ngs_plan(mesh.node_shape, int(colors.max()) + 1)
    lists, cptr = owner_lists(mesh.node_shape, colors, plan.blocks, plan.nloc)
    assert lists.shape == (plan.blocks, plan.nloc) and cptr.shape == (plan.blocks, int(colors.max()) + 2)
    seen = []
    for b in range(plan.blocks):
        for c in range(cptr.shape[1] - 1):
            slots = lists[b, cptr[b, c] : cptr[b, c + 1]]
            e = ((slots >> 2) * plan.blocks + b) * 4 + (slots & 3)
            assert np.all(colors[e] == c) and np.all(np.diff(slots) > 0)
            seen.append(e)
    interior = np.tile(~mesh.boundary_mask().ravel(), 2)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), np.flatnonzero(interior))
