"""The port's ordering-parity ILU (``pc_factor_mat_ordering_type=rcm``) on the
CPU against the JAX package, on the same seeded inputs:

- the orderings (``cell_rcm_parity``, ``cell_rcm``, ``blocked``), array for
  array; the CSR system in the reference's pattern; the ILU(0) factors (the
  port's numpy and C++ paths against the JAX package's C++ one);
- the dense-band pieces: ``tri_apply_plain`` against scipy's triangular
  solve, the coupling stencils against the SpMV, ``BandParityILU.apply``
  against the JAX package's sequential ``host_ilu_apply``;
- ``solve_dpp`` on both engines against the JAX package's solve (the
  published 6/8 at tet nx=4/8), the preonly routing quirk, the engine
  choice, its cache key, the memory guard and ``band_plan``'s table.

``band_trisolve`` is held to its twin on the card in
``tests/test_torch_kernels.py`` (marker ``cuda``, no JAX there).

The JAX package runs on the CPU in float64 with its own C++ host library, as
its tests run it.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.ops.ilu as jilu
import perphil_tpu.ops.ordering as jod
import perphil_tpu.solvers.parameters as jsp
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops import bandsolve as jbs
from perphil_tpu.ops.assembly import DirichletBC as JBC
from perphil_tpu.solvers import solve_dpp as jsolve_dpp
from perphil_tpu.utils import manufactured_solutions as jms

import perphil_tpu_torch.solvers.parameters as sp_
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops import _cuda, _native
from perphil_tpu_torch.ops import bandsolve as bs
from perphil_tpu_torch.ops import ilu
from perphil_tpu_torch.ops import ordering as od
from perphil_tpu_torch.solvers import solve_dpp
from perphil_tpu_torch.solvers import solver
from perphil_tpu_torch.solvers.solver import _build_linear_solver, _check_band_memory, _freeze, _parity_engine

PARAMS = {"k1": 1.2, "beta": 0.9}
RCM = {**sp_.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm"}
PREONLY_RCM = {"ksp_type": "preonly", "pc_type": "ilu", "pc_factor_mat_ordering_type": "rcm"}


def _rel(a, b) -> float:
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.abs(a - b).max() / np.abs(b).max())


def _meshes(element, cells):
    return jmesh.StructuredMesh(cells=cells, element=element), StructuredMesh(cells=cells, element=element)


@lru_cache(maxsize=None)
def _systems(element, cells):
    """(JAX Ap, perm), (port A, perm, Ap) for the parity system."""
    jm, tm = _meshes(element, cells)
    jsys = jilu.build_monolithic_system(jm, JParams(**PARAMS))
    jA = jod.to_csr(jsys)
    if jm.is_tensor_product:
        jperm = np.arange(2 * jm.num_vertices)
    else:
        jA = jod.tighten_pattern(jA, jsys, jm, JParams(**PARAMS))
        jperm = jod.blocked(jod.cell_rcm_parity(jm))
    jAp = jA[jperm][:, jperm].tocsr()
    jAp.sort_indices()
    return (jA, jperm, jAp), od.parity_system(tm, DPPParameters(**PARAMS))


ORDER_MESHES = [("tet", (3, 3, 3)), ("tet", (4, 4, 4)), ("tet", (8, 8, 8)), ("triangle", (8, 8))]
ORDER_IDS = [f"{e}{c[0]}" for e, c in ORDER_MESHES]


@pytest.mark.parametrize("element,cells", ORDER_MESHES, ids=ORDER_IDS)
def test_cell_rcm_parity_and_blocked_match_jax(element, cells):
    jm, tm = _meshes(element, cells)
    perm = od.cell_rcm_parity(tm)
    assert perm.dtype == np.int64 and np.array_equal(perm, jod.cell_rcm_parity(jm))
    assert np.array_equal(np.sort(perm), np.arange(tm.num_vertices))
    assert np.array_equal(od.blocked(perm), jod.blocked(jod.cell_rcm_parity(jm)))


@pytest.mark.parametrize("element,cells", ORDER_MESHES, ids=ORDER_IDS)
def test_simplex_cells_and_cell_rcm_match_jax(element, cells):
    jm, tm = _meshes(element, cells)
    assert np.array_equal(od._simplex_cells(tm), jod._simplex_cells(jm))
    assert np.array_equal(od.cell_rcm(tm), jod.cell_rcm(jm))


def test_cm_traversal_matches_the_queue_and_vertex_rcm_matches_jax():
    """The level-at-a-time traversal against the one-node-at-a-time queue
    of the JAX package, rooted anywhere, both directions, on a graph of two
    components; and vertex_rcm on a random symmetric pattern."""
    jm, tm = _meshes("tet", (3, 2, 2))
    G = jod._cell_dual_graph(jod._simplex_cells(jm), 3)
    assert (od._cell_dual_graph(od._simplex_cells(tm), 3) != G).nnz == 0
    two = sp.block_diag([G, G]).tocsr()
    for root in (0, 5, G.shape[0] + 3):
        for reverse in (False, True):
            assert np.array_equal(od._cm_from_root(two, root, reverse), jod._cm_from_root(two, root, reverse))
    A = sp.random(60, 60, density=0.08, random_state=3)
    assert np.array_equal(od.vertex_rcm(A), jod.vertex_rcm(A))


CSR_MESHES = [("tet", (4, 4, 4)), ("triangle", (8, 8)), ("quad", (4, 4)), ("hex", (3, 3, 3))]
CSR_IDS = [f"{e}{c[0]}" for e, c in CSR_MESHES]


@pytest.mark.parametrize("element,cells", CSR_MESHES, ids=CSR_IDS)
def test_csr_pattern_and_values_match_jax(element, cells):
    jm, tm = _meshes(element, cells)
    jsys = jilu.build_monolithic_system(jm, JParams(**PARAMS))
    tsys = ilu.build_monolithic_system(tm, DPPParameters(**PARAMS))
    pairs = [(od.to_csr(tsys), jod.to_csr(jsys))]
    pairs.append((od.tighten_pattern(pairs[0][0], tsys, tm, DPPParameters(**PARAMS)),
                  jod.tighten_pattern(pairs[0][1], jsys, jm, JParams(**PARAMS))))
    (jA, jperm, jAp), (A, perm, Ap) = _systems(element, cells)
    pairs.append((Ap, jAp))
    assert np.array_equal(perm, jperm)
    for got, ref in pairs:
        got.sort_indices()
        ref.sort_indices()
        assert np.array_equal(got.indptr, ref.indptr) and np.array_equal(got.indices, ref.indices)
        assert np.abs(got.data - ref.data).max() <= 1e-15 * np.abs(ref.data).max()
    if not tm.is_tensor_product:  # the tight pattern drops the never-coupled offsets
        assert pairs[1][0].nnz < pairs[0][0].nnz


@pytest.mark.parametrize("element,cells", [("tet", (4, 4, 4)), ("triangle", (8, 8))], ids=["tet4", "tri8"])
def test_ilu0_factors_match_jax_native(element, cells):
    (_, _, jAp), (_, _, Ap) = _systems(element, cells)
    jF, jdiag = jod.native_ilu0(jAp)
    scale = np.abs(jF.data).max()
    for F, diag in (od.host_ilu0(Ap), _native.native_ilu0(Ap)):
        assert np.array_equal(F.indptr, jF.indptr) and np.array_equal(F.indices, jF.indices)
        assert np.array_equal(diag, jdiag)
        assert np.abs(F.data - jF.data).max() <= 1e-14 * scale


def test_native_solver_matches_host_twins():
    """The C++ GMRES + ILU(0) against the numpy twins, on the parity system
    at tet nx=4: the same count, the same solution."""
    (_, _, _), (A, perm, Ap) = _systems("tet", (4, 4, 4))
    b = np.random.default_rng(11).standard_normal(Ap.shape[0])
    F, diag = od.host_ilu0(Ap)
    its, x, rnorm = _native.native_ilu_gmres_solver(Ap, rtol=1e-8, atol=1e-12)(b)
    its_t, x_t, rnorm_t = od.host_gmres(lambda v: Ap @ v, b, lambda v: od.host_ilu_apply(F, diag, v),
                                        rtol=1e-8, atol=1e-12, return_solution=True)
    assert its == its_t == jod.host_gmres(lambda v: Ap @ v, b, lambda v: jod.host_ilu_apply(F, diag, v))
    assert _rel(x, x_t) <= 1e-10
    assert abs(rnorm - rnorm_t) <= 1e-6 * rnorm_t
    z = od.host_ilu_apply(F, diag, b)
    assert np.array_equal(z, jod.host_ilu_apply(F, diag, b))


def _random_banded(n, bw, seed, lower):
    rng = np.random.default_rng(seed)
    i, j = np.tril_indices(n, -1)
    keep = (i - j <= bw) & (rng.random(i.size) < 0.3)
    M = sp.csr_matrix((rng.standard_normal(int(keep.sum())) * 0.1, (i[keep], j[keep])), shape=(n, n))
    if lower:
        return M
    return (M.T + sp.diags(1.0 + rng.random(n))).tocsr()


@pytest.mark.parametrize("lower", [True, False], ids=["forward", "backward"])
@pytest.mark.parametrize("n,bw", [(600, 90), (500, 70), (64, 31)], ids=["600", "500", "64"])
def test_tri_apply_plain_matches_scipy(n, bw, lower):
    M = _random_banded(n, bw, 0 if lower else 3, lower)
    B = bs.band_block_size(bw)
    assert B % 32 == 0 and B >= bw + 1 and B - 32 < bw + 1
    P = bs.build_blocks(M, B, lower, "cpu")
    assert P.dtype == torch.float64 and P.shape == (-(-n // B), B, B)
    r = np.random.default_rng(1).standard_normal(n)
    rp = np.zeros(P.shape[0] * B)
    rp[:n] = r
    y = bs.tri_apply_plain(P, torch.from_numpy(rp), lower, B - bw).numpy()
    ref = spsolve_triangular((M + sp.eye(n)).tocsr() if lower else M, r, lower=lower, unit_diagonal=lower)
    assert _rel(y[:n], ref) <= 1e-13
    assert not y[n:].any()  # padded tail rows stay zero


@pytest.mark.parametrize("lower", [True, False], ids=["forward", "backward"])
@pytest.mark.parametrize("n,bw", [(600, 90), (125, 34), (64, 31), (15625, 797)], ids=["600", "125", "64", "15625"])
def test_tri_apply_traffic_counts_the_masked_entries(n, bw, lower):
    """The bound's bytes: the twin's masks counted entry by entry over the
    real rows and columns, the first step's coupling left out."""
    B = bs.band_block_size(bw)
    nb = -(-n // B)
    xmask, cmask = (m.numpy() for m in bs._masks(B, B - bw, lower, "cpu"))
    real = [min(B, n - k * B) for k in range(nb)]
    entries = 0
    for k in range(nb):
        entries += int(xmask[: real[k], : real[k]].sum())
        nbr = k - 1 if lower else k + 1
        if 0 <= nbr < nb:
            entries += int(cmask[: real[k], : real[nbr]].sum())
    assert bs.tri_apply_traffic(n, B, B - bw, lower) == (8 * (entries + 2 * n), 2 * entries)


def test_tri_apply_on_the_cpu_is_the_twin_and_launches_nothing():
    M = _random_banded(200, 40, 5, True)
    P = bs.build_blocks(M, 64, True, "cpu")
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(P.shape[0] * 64))
    before = dict(_cuda.KERNEL_LAUNCHES)
    y = bs.tri_apply(P, r, True, 64 - 40)
    assert dict(_cuda.KERNEL_LAUNCHES) == before
    assert torch.equal(y, bs.tri_apply_plain(P, r, True, 64 - 40))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bs.tri_apply(P, r.to("meta"), True, 24)
    with pytest.raises(ValueError, match="expected"):
        bs.tri_apply(P, r[:-1], True, 24)
    with pytest.raises(ValueError, match="bandwidth exceeds"):
        bs.build_blocks(M, 32, True, "cpu")


@pytest.mark.parametrize("element,cells", [("tet", (4, 4, 4)), ("triangle", (8, 8))], ids=["tet4", "tri8"])
def test_split_and_coupling_stencils_match_jax_and_the_spmv(element, cells):
    (_, _, jAp), (_, perm, Ap) = _systems(element, cells)
    _, tm = _meshes(element, cells)
    nv, shape = tm.num_vertices, tm.node_shape
    F, _ = _native.native_ilu0(Ap)
    parts = bs.split_monolithic_factor(F, nv)
    jparts = jbs.split_monolithic_factor(F, nv)
    assert all((a != b).nnz == 0 for a, b in zip(parts, jparts))
    vperm = perm[:nv]
    u = np.random.default_rng(4).standard_normal(shape)
    for M in (parts[1], parts[4]):  # L21, U12
        vals = bs.coupling_stencil_vals(M, vperm, shape)
        assert vals.dtype == np.float64
        assert np.array_equal(vals, jbs.coupling_stencil_vals_f64(M, vperm, shape))
        y = bs.apply_varying_stencil(torch.from_numpy(u), torch.from_numpy(vals)).numpy()
        ref = M @ u.ravel()[vperm]
        assert np.abs(y.ravel()[vperm] - ref).max() <= 1e-14 * np.abs(ref).max()


@pytest.mark.parametrize("element,cells", [("tet", (4, 4, 4)), ("tet", (8, 8, 8)), ("triangle", (8, 8)),
                                           ("quad", (4, 4))], ids=["tet4", "tet8", "tri8", "quad4"])
def test_band_apply_matches_jax_host_ilu_apply(element, cells):
    (_, jperm, jAp), (_, perm, Ap) = _systems(element, cells)
    _, tm = _meshes(element, cells)
    nv = tm.num_vertices
    jF, jdiag = jod.native_ilu0(jAp)
    F, _ = _native.native_ilu0(Ap)
    band = bs.build_band_parity_ilu(F, perm, nv, tm.node_shape, "cpu")
    assert band.B == bs.band_block_size(bs.factor_bandwidth(F, nv)) and band.pad >= 1
    r = np.random.default_rng(9).standard_normal((2,) + tm.node_shape)
    z = band.apply(torch.from_numpy(r)).numpy().ravel()
    iperm = np.empty_like(jperm)
    iperm[jperm] = np.arange(jperm.size)
    ref = jod.host_ilu_apply(jF, jdiag, r.ravel()[jperm])[iperm]
    assert _rel(z, ref) <= 1e-13


def _manufactured(element, cells):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    ex = jms.exact_expressions if mesh.dim == 2 else jms.exact_expressions_3d
    _, p1, _, p2 = ex(mesh, JParams())
    coords = [jnp.asarray(c) for c in mesh.coordinates()]
    return np.asarray(p1(*coords)), np.asarray(p2(*coords))


@lru_cache(maxsize=None)
def _jax_solve(element, cells, frozen):
    g1, g2 = _manufactured(element, cells)
    _, jV = jspaces_of(jmesh.StructuredMesh(cells=cells, element=element))
    W = jmixed(jV)
    bcs = [JBC(W.sub(0), jnp.asarray(g1)), JBC(W.sub(1), jnp.asarray(g2))]
    sol = jsolve_dpp(W, JParams(), bcs, solver_parameters=dict(frozen))
    return sol.iteration_number, [np.asarray(f.dat) for f in sol.solution.split()]


def _port_solve(element, cells, params):
    g1, g2 = _manufactured(element, cells)
    state = from_numpy_state({}, cells, element, g1, g2, device="cpu")
    return solve_dpp(state.W, state.params, state.bcs, solver_parameters=params)


SOLVES = [("tet", (4, 4, 4), 6), ("tet", (8, 8, 8), 8), ("quad", (4, 4), 5), ("hex", (4, 4, 4), 4)]


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("element,cells,count", SOLVES, ids=[f"{e}{c[0]}" for e, c, _ in SOLVES])
def test_solve_dpp_rcm_matches_jax(element, cells, count, engine):
    """The published 6/8 at tet nx=4/8 (``petsc_perf_breakdown_3d.csv``) on
    both engines, equal to the JAX package's counts and fields."""
    params = {**RCM, "pc_band_execution": engine}
    its, ref = _jax_solve(element, cells, tuple(sorted(RCM.items())))
    sol = _port_solve(element, cells, params)
    assert sol.iteration_number == its == count
    for a, b in zip(sol.solution.data, ref):
        assert a.dtype == torch.float64 and a.device.type == "cpu"
        assert _rel(a.numpy(), b) <= 1e-10


@pytest.mark.parametrize("element,cells", [("tet", (4, 4, 4)), ("quad", (4, 4))], ids=["tet4", "quad4"])
def test_preonly_ilu_rcm_runs_gmres_as_jax_does(element, cells):
    """The JAX package routes pc_type=ilu + rcm before ksp_type: preonly
    runs GMRES at the default ksp_rtol (1e-5)."""
    its, ref = _jax_solve(element, cells, tuple(sorted(PREONLY_RCM.items())))
    sol = _port_solve(element, cells, PREONLY_RCM)
    assert sol.iteration_number == its == 3
    for a, b in zip(sol.solution.data, ref):
        assert _rel(a.numpy(), b) <= 1e-10


def test_defect_correct_option_changes_nothing():
    base = _port_solve("tet", (3, 3, 3), {**RCM, "pc_band_execution": "device"})
    for flag in (True, False):
        got = _port_solve("tet", (3, 3, 3), {**RCM, "pc_band_execution": "device", "pc_band_defect_correct": flag})
        assert got.iteration_number == base.iteration_number
        assert all(torch.equal(a, b) for a, b in zip(got.solution.data, base.solution.data))


def test_engine_is_keyed_on_the_option_and_reads_no_environment(monkeypatch):
    for name in ("PERPHIL_TPU_BAND_ILU", "PERPHIL_TPU_BAND_ILU_DF"):
        monkeypatch.setenv(name, "1")
    zero = np.zeros((4, 4, 4))
    state = from_numpy_state({"k1": 3.0}, (3, 3, 3), "tet", zero, zero, device="cpu")
    built = {}
    for option in (None, "device", "host"):
        params = RCM if option is None else {**RCM, "pc_band_execution": option}
        built[option] = _build_linear_solver(state.W, state.params, _freeze(params))
        assert built[option] is _build_linear_solver(state.W, state.params, _freeze(params))
    assert built[None].engine == built["host"].engine == "host"  # the CPU's default
    assert built["device"].engine == "device"
    assert built["device"] is not built["host"]
    with pytest.raises(ValueError, match="pc_band_execution"):
        _build_linear_solver(state.W, state.params, _freeze({**RCM, "pc_band_execution": "tpu"}))


def test_engine_choice_and_memory_guard(monkeypatch):
    assert _parity_engine(True, "") == "device"
    assert _parity_engine(False, "") == "host"
    assert _parity_engine(True, "host") == "host"
    assert _parity_engine(False, "device") == "device"
    _check_band_memory(10**12, None)  # the CPU twin: no card memory
    _check_band_memory(5 * 2**30, 6 * 2**30)
    # an oversized plan raises, whether the choice was left open or not: the
    # solve never moves to the host engine unasked
    with pytest.raises(MemoryError, match=f"needs {6 * 2**30} bytes.*pc_band_execution=host"):
        _check_band_memory(6 * 2**30, 5 * 2**30)
    # end to end, with the card's free memory stubbed: the plan is checked
    # before any block is built
    monkeypatch.setattr(solver, "_free_device_bytes", lambda device: 1000)

    def no_build(*args, **kwargs):
        raise AssertionError("blocks built before the memory check")

    monkeypatch.setattr(solver, "build_band_parity_ilu", no_build)
    zero = np.zeros((5, 5, 5))
    state = from_numpy_state({"k2": 3.0}, (4, 4, 4), "tet", zero, zero, device="cpu")
    plan = bs.band_plan(125, 34)
    with pytest.raises(MemoryError, match=f"needs {plan.total_bytes} bytes"):
        solve_dpp(state.W, state.params, state.bcs, solver_parameters={**RCM, "pc_band_execution": "device"})


# band_plan worked by hand: B the smallest multiple of 32 above the
# bandwidth, nb = ceil((nx+1)^3 / B), four packed factors of nb B^2 f64.
# The bandwidths are the factors' (tet, cell-RCM parity draw); nx=64's,
# 5317, from its factor (tools/profile_kernels.py --only band prints it).
PLAN_TABLE = [  # nx, bandwidth, B, nb, packed bytes
    (4, 34, 64, 2, 262_144),
    (8, 108, 128, 6, 3_145_728),
    (16, 373, 384, 13, 61_341_696),
    (24, 797, 800, 20, 409_600_000),
    (40, 2125, 2144, 33, 4_854_153_216),
    (64, 5317, 5344, 52, 47_521_071_104),
]


@pytest.mark.parametrize("nx,bw,B,nb,packed", PLAN_TABLE, ids=[f"nx{r[0]}" for r in PLAN_TABLE])
def test_band_plan_table(nx, bw, B, nb, packed):
    plan = bs.band_plan((nx + 1) ** 3, bw)
    assert (plan.bandwidth, plan.B, plan.nb, plan.packed_bytes) == (bw, B, nb, packed)
    assert 0 < plan.workspace_bytes < plan.packed_bytes or nx == 4
    assert plan.total_bytes == plan.packed_bytes + plan.workspace_bytes
    if nx <= 16:  # the bandwidth is the factor's
        (_, _, _), (_, _, Ap) = _systems("tet", (nx,) * 3)
        assert bs.factor_bandwidth(_native.native_ilu0(Ap)[0], (nx + 1) ** 3) == bw
