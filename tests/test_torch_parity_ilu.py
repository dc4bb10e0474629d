"""The port's ordering-parity ILU (``pc_factor_mat_ordering_type=rcm``) on the
CPU against the JAX package, on the same seeded inputs:

- the orderings (``cell_rcm_parity``, ``cell_rcm``, ``blocked``), array for
  array; the CSR system in the reference's pattern; the ILU(0) factors (the
  port's numpy and C++ paths against the JAX package's C++ one);
- the level schedule of the band engine (every dependency in an earlier
  level, every row once), its twin ``level_apply_plain`` bit for bit
  against the port's and the JAX package's sequential ``host_ilu_apply``
  on the same factor, ``BandParityILU.apply`` against the JAX package's
  apply;
- the first port's dense-band pieces, which ``tools/band_dense.py`` keeps
  for measurements: ``tri_apply_plain`` against scipy's triangular solve,
  the coupling stencils against the SpMV;
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
from perphil_tpu_torch.tools import band_dense as bd

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
    B = bd.band_block_size(bw)
    assert B % 32 == 0 and B >= bw + 1 and B - 32 < bw + 1
    P = bd.build_blocks(M, B, lower, "cpu")
    assert P.dtype == torch.float64 and P.shape == (-(-n // B), B, B)
    r = np.random.default_rng(1).standard_normal(n)
    rp = np.zeros(P.shape[0] * B)
    rp[:n] = r
    y = bd.tri_apply_plain(P, torch.from_numpy(rp), lower, B - bw).numpy()
    ref = spsolve_triangular((M + sp.eye(n)).tocsr() if lower else M, r, lower=lower, unit_diagonal=lower)
    assert _rel(y[:n], ref) <= 1e-13
    assert not y[n:].any()  # padded tail rows stay zero


@pytest.mark.parametrize("lower", [True, False], ids=["forward", "backward"])
@pytest.mark.parametrize("n,bw", [(600, 90), (125, 34), (64, 31), (15625, 797)], ids=["600", "125", "64", "15625"])
def test_tri_apply_traffic_counts_the_masked_entries(n, bw, lower):
    """The bound's bytes: the twin's masks counted entry by entry over the
    real rows and columns, the first step's coupling left out."""
    B = bd.band_block_size(bw)
    nb = -(-n // B)
    xmask, cmask = (m.numpy() for m in bd._masks(B, B - bw, lower, "cpu"))
    real = [min(B, n - k * B) for k in range(nb)]
    entries = 0
    for k in range(nb):
        entries += int(xmask[: real[k], : real[k]].sum())
        nbr = k - 1 if lower else k + 1
        if 0 <= nbr < nb:
            entries += int(cmask[: real[k], : real[nbr]].sum())
    assert bd.tri_apply_traffic(n, B, B - bw, lower) == (8 * (entries + 2 * n), 2 * entries)


def test_tri_apply_on_the_cpu_is_the_twin_and_launches_nothing():
    M = _random_banded(200, 40, 5, True)
    P = bd.build_blocks(M, 64, True, "cpu")
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(P.shape[0] * 64))
    before = dict(_cuda.KERNEL_LAUNCHES)
    y = bd.tri_apply(P, r, True, 64 - 40)
    assert dict(_cuda.KERNEL_LAUNCHES) == before
    assert torch.equal(y, bd.tri_apply_plain(P, r, True, 64 - 40))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bd.tri_apply(P, r.to("meta"), True, 24)
    with pytest.raises(ValueError, match="expected"):
        bd.tri_apply(P, r[:-1], True, 24)
    with pytest.raises(ValueError, match="bandwidth exceeds"):
        bd.build_blocks(M, 32, True, "cpu")


@pytest.mark.parametrize("element,cells", [("tet", (4, 4, 4)), ("triangle", (8, 8))], ids=["tet4", "tri8"])
def test_split_and_coupling_stencils_match_jax_and_the_spmv(element, cells):
    (_, _, jAp), (_, perm, Ap) = _systems(element, cells)
    _, tm = _meshes(element, cells)
    nv, shape = tm.num_vertices, tm.node_shape
    F, _ = _native.native_ilu0(Ap)
    parts = bd.split_monolithic_factor(F, nv)
    jparts = jbs.split_monolithic_factor(F, nv)
    assert all((a != b).nnz == 0 for a, b in zip(parts, jparts))
    vperm = perm[:nv]
    u = np.random.default_rng(4).standard_normal(shape)
    for M in (parts[1], parts[4]):  # L21, U12
        vals = bd.coupling_stencil_vals(M, vperm, shape)
        assert vals.dtype == np.float64
        assert np.array_equal(vals, jbs.coupling_stencil_vals_f64(M, vperm, shape))
        y = bd.apply_varying_stencil(torch.from_numpy(u), torch.from_numpy(vals)).numpy()
        ref = M @ u.ravel()[vperm]
        assert np.abs(y.ravel()[vperm] - ref).max() <= 1e-14 * np.abs(ref).max()


LEVEL_MESHES = [("tet", (4, 4, 4)), ("tet", (8, 8, 8)), ("triangle", (8, 8)), ("quad", (4, 4))]
LEVEL_IDS = ["tet4", "tet8", "tri8", "quad4"]


def _factor(element, cells):
    (_, _, _), (_, perm, Ap) = _systems(element, cells)
    F, diag = _native.native_ilu0(Ap)
    return F, diag, perm


@pytest.mark.parametrize("lower", [True, False], ids=["forward", "backward"])
@pytest.mark.parametrize("element,cells", LEVEL_MESHES, ids=LEVEL_IDS)
def test_sweep_levels_are_a_valid_schedule(element, cells, lower):
    """Every row a sweep reads lies in an earlier level, and each row's
    level is the least such (1 + its dependencies' largest, 0 without any);
    the layout holds every row exactly once in its sweep, in level order,
    and each row's entries in its CSR order."""
    F, diag, perm = _factor(element, cells)
    n = F.shape[0]
    level = bs.sweep_levels(F, lower)
    for i in range(n):
        lo, hi = (F.indptr[i], diag[i]) if lower else (diag[i] + 1, F.indptr[i + 1])
        deps = F.indices[lo:hi]
        assert level[i] == (level[deps].max() + 1 if deps.size else 0)
    sched = bs.level_schedule(F, perm, 2)  # rows dealt to two blocks by parity
    blob = torch.from_numpy(sched.blob)
    nl, nu = sched.nlev
    assert (nl if lower else nu) == level.max() + 1
    levels = range(nl) if lower else range(nl, nl + nu)
    mask = (1 << bs.ROW_BITS) - 1
    seen = []
    for lev in levels:
        for b, desc in enumerate(sched.desc[lev]):
            vals, dg, cols, words = (t.numpy() for t in bs.segment_arrays(blob, desc))
            m, w = vals.shape[:2]
            assert (words[:-1] >= 0).all()  # padding lanes only in a segment's last slice
            for (j, t), word in np.ndenumerate(words):
                if word < 0:
                    continue
                i, count = word & mask, word >> bs.ROW_BITS
                assert level[i] == lev - (0 if lower else nl) and i % 2 == b
                lo, hi = (F.indptr[i], diag[i]) if lower else (diag[i] + 1, F.indptr[i + 1])
                assert count == hi - lo <= w
                assert np.array_equal(cols[j, :count, t], F.indices[lo:hi])
                assert np.array_equal(vals[j, :count, t], F.data[lo:hi])
                assert (cols[j, count:, t] == n).all() and not vals[j, count:, t].any()
                assert dg[j, t] == F.data[diag[i]]
                seen.append(i)
    assert sorted(seen) == list(range(n))


LEVEL_APPLIES = [("tet", (4, 4, 4), None, None), ("tet", (8, 8, 8), None, None), ("triangle", (8, 8), None, None),
                 ("tet", (4, 4, 4), 4, True), ("tet", (8, 8, 8), 16, False), ("triangle", (8, 8), 2, False)]


@pytest.mark.parametrize("element,cells,blocks,shared", LEVEL_APPLIES,
                         ids=[f"{e}{c[0]}-{b or 'plan'}" for e, c, b, _ in LEVEL_APPLIES])
def test_level_twin_is_bit_equal_to_host_ilu_apply(element, cells, blocks, shared):
    """The kernel's twin on the plan's placement and on clusters (the
    vector spread over their shared memory, or in device memory), bit for
    bit (np.array_equal) against the port's and the JAX package's
    sequential ``host_ilu_apply`` on the same factor."""
    F, diag, perm = _factor(element, cells)
    sched = bs.level_schedule(F, perm, blocks, shared)
    assert sched.blocks == (blocks or 1) and sched.shared_vector == (shared is not False)
    band = bs.build_band_parity_ilu(sched, "cpu")
    r = np.random.default_rng(7).standard_normal(F.shape[0])
    z = bs.level_apply_plain(band, torch.from_numpy(r)).numpy()
    for host_ilu_apply in (od.host_ilu_apply, jod.host_ilu_apply):
        ref = np.empty_like(r)
        ref[perm] = host_ilu_apply(F, diag, r[perm])
        assert np.array_equal(z, ref)


@pytest.mark.parametrize("element,cells", LEVEL_MESHES, ids=LEVEL_IDS)
def test_band_apply_matches_jax_host_ilu_apply(element, cells):
    """``BandParityILU.apply`` on stacked natural fields: the JAX package's
    sequential apply of the same factor at its bits, and of its own C++
    factor (a rounding away, ``-march=native``) to 1e-13."""
    (_, jperm, jAp), (_, perm, Ap) = _systems(element, cells)
    _, tm = _meshes(element, cells)
    F, diag = _native.native_ilu0(Ap)
    band = bs.build_band_parity_ilu(bs.level_schedule(F, perm), "cpu")
    r = np.random.default_rng(9).standard_normal((2,) + tm.node_shape)
    z = band.apply(torch.from_numpy(r)).numpy().ravel()
    iperm = np.empty_like(jperm)
    iperm[jperm] = np.arange(jperm.size)
    assert np.array_equal(z, jod.host_ilu_apply(F, diag, r.ravel()[jperm])[iperm])
    jF, jdiag = jod.native_ilu0(jAp)
    assert _rel(z, jod.host_ilu_apply(jF, jdiag, r.ravel()[jperm])[iperm]) <= 1e-13


def test_level_apply_on_the_cpu_is_the_twin_and_launches_nothing():
    F, _, perm = _factor("tet", (4, 4, 4))
    band = bs.build_band_parity_ilu(bs.level_schedule(F, perm), "cpu")
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(F.shape[0]))
    before = dict(_cuda.KERNEL_LAUNCHES)
    z = bs.level_apply(band, r)
    assert dict(_cuda.KERNEL_LAUNCHES) == before
    assert torch.equal(z, bs.level_apply_plain(band, r))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bs.level_apply(band, r.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        bs.level_apply(band, r[:-1])


def test_level_schedule_placement_and_ring():
    """The plan's placement: the vector in shared memory on the fewest
    blocks whose share of it and a two-stage ring fit ``kLevelSmemBudget``,
    else the rule's cluster with the vector in device memory; the ring as
    deep as the budget allows, as the launcher computes it (worked by
    hand)."""
    F, _, perm = _factor("tet", (8, 8, 8))
    sched = bs.level_schedule(F, perm)
    assert (sched.blocks, sched.shared_vector, sched.nlev) == (1, True, (87, 87))
    assert sched.stages == bs.ring_stages(F.shape[0], 174, sched.stage_bytes, True, 1) == 4
    # mbarriers 64 B, 174 descriptors of 16 B (2,848 B, aligned to 2,944), the
    # ring, the vector's 1,458 doubles (729 a block on two)
    assert bs.smem_bytes(1458, 174, 4, 9600, True, 1) == 2944 + 38_400 + 11_664
    assert bs.smem_bytes(1458, 174, 4, 9600, True, 2) == 2944 + 38_400 + 5_832
    assert bs.smem_bytes(1458, 174, 4, 9600, False, 16) == 2944 + 38_400
    assert bs.ring_stages(1458, 174, 60_000, True, 1) == 3  # 2944 + 180,000 + 11,664 = 194,608
    assert bs.ring_stages(1458, 174, 80_000, True, 1) == 2
    assert bs.ring_stages(1458, 174, 120_000, True, 1) == 0
    assert bs.ring_stages(1458, 174, 114_000, False, 16) == 2  # 2944 + 228,000 = 230,944 <= 232,448
    # a vector of 31,250 doubles (tet nx=24) takes two blocks' shared memory
    assert bs.smem_bytes(31_250, 494, 4, 9600, True, 2) == 8064 + 38_400 + 125_000
    cluster = bs.level_schedule(F, perm, 16, False)
    assert (cluster.blocks, cluster.shared_vector) == (16, False)
    assert cluster.desc.shape == (174, 16, 4) and cluster.stage_bytes < sched.stage_bytes
    assert bs.level_schedule(F, perm, 4).shared_vector
    with pytest.raises(ValueError, match="blocks"):
        bs.level_schedule(F, perm, 3)


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
        raise AssertionError("the factor built before the memory check")

    monkeypatch.setattr(solver, "build_band_parity_ilu", no_build)
    zero = np.zeros((5, 5, 5))
    state = from_numpy_state({"k2": 3.0}, (4, 4, 4), "tet", zero, zero, device="cpu")
    _, perm, Ap = od.parity_system(state.W.mesh, state.params)
    plan = bs.plan_of(bs.level_schedule(_native.native_ilu0(Ap)[0], perm))
    assert plan.total_bytes > 1000
    with pytest.raises(MemoryError, match=f"needs {plan.total_bytes} bytes"):
        solve_dpp(state.W, state.params, state.bcs, solver_parameters={**RCM, "pc_band_execution": "device"})


# band_plan worked by hand: the level-ordered factor is 12 B a padded entry
# (f64 value, int32 column), 12 B a lane (row word, f64 diagonal) at 32
# lanes a slice, 16 B a descriptor (levels x blocks) and 4 B a row of the
# permutation; the workspace the vector's n doubles and 2 MiB for each of
# the four buffers that the caching allocator may add. nx <= 16: the counts are the real
# factor's (checked below); nx=24/40/64 the plan's schedule of the factor
# (tools/profile_kernels.py --only band prints them).
PLAN_TABLE = [  # nx, rows, padded entries, slices, levels, blocks, factor bytes, workspace bytes
    (4, 250, 44_288, 94, 94, 1, 570_056, 8_390_608),
    (8, 1_458, 115_008, 192, 174, 1, 1_462_440, 8_400_272),
    (16, 9_826, 546_816, 797, 334, 1, 6_912_488, 8_467_216),
    (24, 31_250, 4_276_864, 6_636, 494, 16, 54_122_056, 8_638_608),
    (40, 137_842, 10_607_008, 15_561, 814, 16, 134_019_272, 9_491_344),
    (64, 549_250, 31_465_600, 44_840, 1_294, 16, 397_334_024, 12_782_608),
]


@pytest.mark.parametrize("nx,n,slots,slices,levels,blocks,factor,workspace", PLAN_TABLE,
                         ids=[f"nx{r[0]}" for r in PLAN_TABLE])
def test_band_plan_table(nx, n, slots, slices, levels, blocks, factor, workspace):
    plan = bs.band_plan(n, slots, slices, levels, blocks)
    assert (plan.levels, plan.blocks, plan.factor_bytes, plan.workspace_bytes) == (levels, blocks, factor, workspace)
    assert plan.total_bytes == factor + workspace
    assert n == 2 * (nx + 1) ** 3
    if nx <= 16:  # the counts are the factor's
        F, _, perm = _factor("tet", (nx,) * 3)
        sched = bs.level_schedule(F, perm)
        assert (sched.n, sched.slots, sched.slices, sum(sched.nlev), sched.blocks) == (n, slots, slices, levels, blocks)
        assert bs.plan_of(sched) == plan
