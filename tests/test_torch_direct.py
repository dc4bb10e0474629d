"""Parity of the port's direct solvers with the JAX package: fast-diag
(f64), the mixed-precision solver and K2's plain twin against JAX's f64
``FastDiagDPPSolver``, K3's plain twin and ``cg`` against JAX's XLA ``cg``
route, and the fused envelope (the launchers' plan) beside the JAX gate."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.ops.direct as jdirect
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DPPOperator as JOp
from perphil_tpu.ops.krylov import cg as jcg
from perphil_tpu.ops.pallas_direct import fused_direct_supported as jax_fused_direct_supported
from perphil_tpu.ops.pallas_direct import (
    fused_simplicial_direct_supported as jax_fused_simplicial_supported,
)
from perphil_tpu.solvers.solver import _monolithic_direct as jax_monolithic_direct

import perphil_tpu_torch.ops.direct as tdirect
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.ops.direct import LumpedDPPPreconditioner
from perphil_tpu_torch.ops.fused_direct import (
    DirectPlan,
    FusedDirectSolver,
    fused_direct_solve,
    fused_direct_supported,
    fused_simplicial_direct_solve,
    fused_simplicial_direct_supported,
    mesh_plan,
)
from perphil_tpu_torch.ops.krylov import cg
from perphil_tpu_torch.ops.mixed import MixedPrecisionDPPDirect

PARAMS = dict(k1=1.0, beta=1.0, mu=1.0)
TENSOR = [("quad", (16, 16)), ("hex", (6, 6, 6))]
SIMPLEX = [("triangle", (8, 8)), ("tet", (4, 4, 4))]


def _systems(element, cells, seed=0):
    """Port state, JAX op, and a random RHS (b1, b2) as numpy."""
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    rng = np.random.default_rng(seed)
    b1, b2 = (rng.standard_normal(mesh.node_shape) for _ in range(2))
    state = from_numpy_state(PARAMS, cells, element, b1, b2, device="cpu")
    _, jV = jspaces_of(mesh)
    return state, JOp(jmixed(jV), JParams(**PARAMS)), b1, b2


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_interior_eig_equal():
    for n, h, lumped in ((7, 1 / 7, False), (9, 0.1, True), (2, 0.5, False)):
        for a, b in zip(tdirect._interior_eig_1d(n, h, lumped), jdirect._interior_eig_1d(n, h, lumped)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("element,cells", TENSOR, ids=["quad16", "hex6"])
def test_fastdiag_solvers_match_f64(element, cells):
    state, jop, b1, b2 = _systems(element, cells)
    t = tdirect.FastDiagDPPSolver(state.mesh, state.params, device="cpu")
    j = jdirect.FastDiagDPPSolver(jop.mesh, jop.params)
    for a, b in zip(t.solve(torch.as_tensor(b1), torch.as_tensor(b2)), j.solve(jnp.asarray(b1), jnp.asarray(b2))):
        assert _rel(a, b) <= 1e-12
    for lumped in (False, True):
        tf = tdirect.FastDiagFieldSolver(state.mesh, 1.0, 0.5, 1.0, lumped=lumped, device="cpu")
        jf = jdirect.FastDiagFieldSolver(jop.mesh, 1.0, 0.5, 1.0, lumped=lumped)
        assert _rel(tf.solve(torch.as_tensor(b1)), jf.solve(jnp.asarray(b1))) <= 1e-12
    assert {n for n, _ in t.named_buffers()} >= {"S0", "S1", "a11", "a22", "det"}


# hex nx=16: a mesh the plan joined (the JAX gate left it out)
@pytest.mark.parametrize("element,cells", TENSOR + [("hex", (16, 16, 16))], ids=["quad16", "hex6", "hex16"])
def test_mixed_and_k2_twin_match_jax_f64(element, cells):
    state, jop, b1, b2 = _systems(element, cells, seed=1)
    ref = jdirect.FastDiagDPPSolver(jop.mesh, jop.params).solve(jnp.asarray(b1), jnp.asarray(b2))
    tb = (torch.as_tensor(b1), torch.as_tensor(b2))
    op = DPPOperator(state.W, state.params)
    assert fused_direct_supported(op)
    mixed = MixedPrecisionDPPDirect(state.mesh, state.params, device="cpu")
    k2 = fused_direct_solve(op)
    assert isinstance(k2, FusedDirectSolver) and k2.fast32.S0.dtype == torch.float32
    for solver in (mixed.solve, k2):
        for a, b in zip(solver(*tb), ref):
            assert a.dtype == torch.float64
            assert _rel(a, b) <= 1e-10


def test_mixed_assemble_and_solve_matches_jax():
    state, jop, g1, g2 = _systems("quad", (16, 16), seed=2)
    jb = jop.lifted_rhs(jnp.asarray(g1), jnp.asarray(g2))
    ref = jdirect.FastDiagDPPSolver(jop.mesh, jop.params).solve(*jb)
    out = MixedPrecisionDPPDirect(state.mesh, state.params, device="cpu").assemble_and_solve(*state.grids)
    for a, b in zip(out, ref):
        assert _rel(a, b) <= 1e-10


# tet nx=16: a mesh the plan joined (on 2 blocks; the JAX gate left it out)
@pytest.mark.parametrize("element,cells", SIMPLEX + [("tet", (16, 16, 16))], ids=["tri8", "tet4", "tet16"])
def test_k3_twin_matches_jax_cg_route(element, cells):
    state, jop, b1, b2 = _systems(element, cells, seed=3)
    ref = jax_monolithic_direct(jop)(jnp.asarray(b1), jnp.asarray(b2))
    op = DPPOperator(state.W, state.params)
    assert fused_simplicial_direct_supported(op)
    k3 = fused_simplicial_direct_solve(op)
    for a, b in zip(k3(torch.as_tensor(b1), torch.as_tensor(b2)), ref):
        assert _rel(a, b) <= 1e-10
    x, its = k3.plain(torch.stack([torch.as_tensor(b1), torch.as_tensor(b2)]))
    assert 0 < its < 2000 and tuple(k3.sc.shape) == (2, int(np.prod([n - 1 for n in cells])))


@pytest.mark.parametrize("element,cells", SIMPLEX, ids=["tri8", "tet4"])
def test_cg_matches_jax_cg(element, cells):
    """The port's cg on the K1 operator with the lumped preconditioner, vs
    the JAX cg on the same system: same iterations (+-1) and solution."""
    state, jop, b1, b2 = _systems(element, cells, seed=4)
    p = jop.params
    jpc = [jdirect.FastDiagFieldSolver(jop.mesh, k, p.beta, p.mu, lumped=True) for k in (p.k1, p.k2)]
    jb = jnp.stack([jnp.asarray(b1), jnp.asarray(b2)])
    jx, jits, _ = jcg(
        jop.stacked_matvec(), jb, rtol=1e-10, atol=0.0, max_it=500,
        M_inv=lambda r: jnp.stack([jpc[0].solve(r[0]), jpc[1].solve(r[1])]),
    )
    op = DPPOperator(state.W, state.params)
    x, its, rnorm = cg(
        op.stacked_matvec(), torch.as_tensor(np.array(jb)), rtol=1e-10, atol=0.0, max_it=500,
        M_inv=LumpedDPPPreconditioner(state.mesh, state.params, device="cpu"),
    )
    assert abs(its - int(jits)) <= 1
    assert _rel(x, jx) <= 1e-10 and np.isfinite(rnorm)


def test_cg_stops_on_non_finite():
    calls = []

    def A(v):  # the first application (to x0 = 0) is finite, the rest are not
        calls.append(1)
        return v if len(calls) == 1 else v * float("nan")

    x, its, rnorm = cg(A, torch.ones(5, dtype=torch.float64), rtol=1e-12, max_it=50)
    assert its == 1 and not np.isfinite(rnorm)


# The launchers' plan (csrc/direct_smem.cuh), worked by hand, and the
# solve route's gate. One block: threads the smallest of 64..512 with
# threads >= 2 nint (else 512), per the smallest power of two with threads *
# per >= nint (<= 8); shared memory K2 16 n + 28 nint + 4 (cells - 1)^2, K3
# 16 n + 64 nint + 8 (cells - 1)^2 or, on 64 threads (dense), 16 n + 32 nint
# + 16 nint^2, within 231,424 B (one eigenbasis for the cube's axes). Else
# the fewest of 2, 4, 8, 16 blocks of 512 threads whose per (<= 8) covers
# nint and whose chunks fit: K2 8 pc + 8 ic, K3 8 pc + 24 ic, pc = ceil(2n /
# blocks), ic = ceil(2 nint / blocks); e.g. quad N=66: n = 4,489, nint =
# 4,225, 2 blocks, per 8, 8 * 4,489 + 8 * 4,225 = 69,712 B. The gate takes
# up to the largest mesh measured faster than the former route, with every
# mesh measured below it faster too (quad N=120, hex nx=33, tri N=150, every
# tet mesh placed). Beside each, the JAX gate's
# verdict (_geometry(op).Rp <= 512, the TPU's packed VMEM layout), read with
# the JAX package, where building its operator takes no long.
ENVELOPE = [  # element, cells, JAX gate (None: not read), (threads, per, bytes, blocks) or None, gate
    ("quad", (16, 16), True, (512, 1, 11824, 1), True),
    ("quad", (64, 64), True, (512, 8, 194608, 1), True),
    ("quad", (65, 65), True, (512, 8, 200768, 1), True),
    ("quad", (66, 66), True, (512, 8, 69712, 2), True),
    ("quad", (96, 96), True, (512, 8, 73744, 4), True),
    ("quad", (97, 97), True, (512, 8, 75280, 4), True),
    ("quad", (120, 120), None, (512, 8, 115216, 4), True),
    ("quad", (121, 121), None, (512, 8, 117136, 4), False),
    ("quad", (128, 128), False, (512, 8, 131088, 4), False),
    ("quad", (258, 258), None, None, False),
    ("hex", (8, 8, 8), True, (512, 1, 21464, 1), True),
    ("hex", (16, 16, 16), False, (512, 8, 174008, 1), True),
    ("hex", (17, 17, 17), False, (512, 8, 209024, 1), True),
    ("hex", (18, 18, 18), False, (512, 8, 94176, 2), True),
    ("hex", (33, 33, 33), None, (512, 8, 144144, 8), True),
    ("hex", (34, 34, 34), None, (512, 8, 78824, 16), False),
    ("hex", (41, 41, 41), None, (512, 8, 138088, 16), False),
    ("hex", (42, 42, 42), None, None, False),
    ("tet", (4, 4, 4), True, (64, 1, 14528, 1), True),  # dense
    ("tet", (8, 8, 8), True, (512, 1, 34008, 1), True),
    ("tet", (14, 14, 14), True, (512, 8, 195960, 1), True),
    ("tet", (15, 15, 15), False, (512, 4, 98624, 2), True),
    ("tet", (16, 16, 16), False, (512, 4, 120304, 2), True),
    ("tet", (39, 39, 39), None, (512, 8, 228616, 16), True),
    ("tet", (40, 40, 40), None, None, False),
    ("triangle", (51, 51), True, (512, 8, 223264, 1), True),
    ("triangle", (52, 52), True, (512, 4, 84896, 2), True),
    ("triangle", (150, 150), None, (512, 8, 178832, 8), True),
    ("triangle", (151, 151), None, (512, 8, 181208, 8), False),
    ("triangle", (170, 170), None, (512, 8, 229872, 8), False),
    ("triangle", (171, 171), None, (512, 4, 116296, 16), False),
    ("triangle", (242, 242), None, None, False),
]


@pytest.mark.parametrize(
    "element,cells,jax_inside,plan,gate", ENVELOPE, ids=[f"{e}{c[0]}" for e, c, _, _, _ in ENVELOPE]
)
def test_envelope_agrees_with_jax_gate(monkeypatch, element, cells, jax_inside, plan, gate):
    """The port's plan and gate, held to the hand-worked table; the JAX
    gate's verdict on the same mesh stands beside them."""
    monkeypatch.setenv("PERPHIL_TPU_FUSED_DIRECT", "force")  # judge the gate off-TPU
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    if jax_inside is not None:
        _, jV = jspaces_of(mesh)
        jop = JOp(jmixed(jV), JParams())
        assert (jax_fused_direct_supported(jop) or jax_fused_simplicial_supported(jop)) == jax_inside
    zero = np.zeros(mesh.node_shape)
    state = from_numpy_state({}, cells, element, zero, zero, device="cpu")
    op = DPPOperator(state.W, state.params)
    assert (fused_direct_supported(op) or fused_simplicial_direct_supported(op)) == gate
    assert mesh_plan(op) == (None if plan is None else DirectPlan(*plan))


def test_fused_solvers_reject_what_they_do_not_take():
    # 2D N=300: beyond a 16-block cluster's shared memory
    big = from_numpy_state({}, (300, 300), "quad", np.zeros((301, 301)), np.zeros((301, 301)), device="cpu")
    with pytest.raises(ValueError, match="envelope"):
        FusedDirectSolver(DPPOperator(big.W, big.params))
    small = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    k2 = FusedDirectSolver(DPPOperator(small.W, small.params))
    with pytest.raises(ValueError):
        k2(small.grids[0].float(), small.grids[1].float())
    with pytest.raises(ValueError):
        fused_simplicial_direct_solve(DPPOperator(small.W, small.params))


@pytest.mark.parametrize("element,cells,ntensors", [("quad", (4, 4), 6), ("tet", (3, 3, 3), 5)], ids=["k2", "k3"])
def test_launch_reads_the_buffers_anew(element, cells, ntensors):
    """The launch arguments are read when a launch runs: a copy of a solver
    points its launcher at its own buffers, and a cast refuses (the kernels
    read fixed element types)."""
    zero = np.zeros(tuple(c + 1 for c in cells))
    state = from_numpy_state({}, cells, element, zero, zero, device="cpu")
    op = DPPOperator(state.W, state.params)
    solver = (fused_direct_solve if element == "quad" else fused_simplicial_direct_solve)(op)
    twin = copy.deepcopy(solver)
    for s in (solver, twin):
        args = s.launch_args()
        assert set(args[:ntensors]) - {None} <= {t.data_ptr() for t in s.buffers()}
        assert s._weights.ctypes.data in args and s._placement.ctypes.data in args
    assert not set(twin.launch_args()[:ntensors]) & {t.data_ptr() for t in solver.buffers()}
    with pytest.raises(TypeError, match="dtypes"):
        solver.half()
