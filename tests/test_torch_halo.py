"""Phantom padding and K1's halo form, held against the JAX package on the
CPU: the padded operators (``DPPOperator``, ``FieldOperator``,
``TensorDPPOperator`` / ``TensorFastDiagDPP``, ``P2SimplexDPPOperator``) and
the padded solver builders against theirs, K1's halo twin over loopback
blocks against the whole-grid twin bit for bit, the planes entry (the owned
block and the received planes, read through the kernel's regions) against
the extended-box twin bit for bit, the launch plan's writes, the geometry it
refuses, a world of one rank with no process group, and
``benchmark_vs_gathered`` and the sharded apply against the JAX package's
stacked matvec in a world of two gloo ranks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.solvers.solver as jsolver
from perphil_tpu.forms import create_function_spaces as jspaces, mixed_space as jmixed
from perphil_tpu.forms.spaces import FunctionSpace as JFunctionSpace
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops import simplexfem as jsf, tensorfem as jtf
from perphil_tpu.ops.assembly import DirichletBC as JBC, DPPOperator as JOp, FieldOperator as JField
from perphil_tpu.ops.assembly import bc_values_per_field as jbcv
from perphil_tpu.utils import manufactured_solutions as jms

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.forms import mixed_space
from perphil_tpu_torch.forms.spaces import FunctionSpace
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.mesh import create_mesh
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops import simplexfem as sf, tensorfem as tf
from perphil_tpu_torch.ops.assembly import DPPOperator, FieldOperator, bc_values_per_field, dpp_stencils
from perphil_tpu_torch.ops.fused_apply import (
    DEFAULT_WAVE,
    fill_chunk,
    fused_dpp_apply_halo,
    fused_dpp_apply_halo_planes,
    fused_dpp_apply_halo_plain,
    fused_dpp_apply_plain,
    halo_geometry,
    halo_plan,
    plan_writes,
)
from perphil_tpu_torch.ops.mixed import MixedPrecisionDPPDirect
from perphil_tpu_torch.parallel.halo import (
    block_geometry,
    halo_box,
    join_blocks,
    loopback_apply,
    loopback_planes,
    send_plane,
    split_blocks,
)
from perphil_tpu_torch.parallel.sharding import (
    device_mesh,
    field_spec,
    mesh_padding,
    shard_grid,
    shard_stacked,
    sharded_solve_dpp,
    sharded_solve_dpp_nonlinear,
)
from perphil_tpu_torch.solvers import solve_dpp, solve_dpp_nonlinear
from perphil_tpu_torch.solvers.solver import (
    _build_linear_solver,
    _build_simplex_p2_linear_solver,
    _build_tensor_linear_solver,
    _freeze,
)
from perphil_tpu_torch.tools.dryrun import _manufactured_bcs, _space, spawn_world

PARAMS = dict(k1=1.3, beta=0.8, mu=1.1)
PADDED = [("quad", (8, 8), (3, 1)), ("triangle", (7, 9), (1, 2)), ("hex", (4, 5, 3), (2, 0, 1)),
          ("tet", (4, 4, 4), (1, 3, 2))]
PADDED_IDS = [c[0] for c in PADDED]


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300), np.abs(a - b).max() / np.abs(b).max()


def _padded_random(shape, padding, seed, n=4):
    """``n`` random grids of ``shape``, zero-padded by ``padding`` (phantoms
    carry zero data)."""
    rng = np.random.default_rng(seed)
    return [np.pad(rng.standard_normal(shape), [(0, p) for p in padding]) for _ in range(n)]


@pytest.mark.parametrize("element,cells,padding", PADDED, ids=PADDED_IDS)
def test_padded_dpp_operator_matches_jax(element, cells, padding):
    """The padded monolithic operator (K1's halo form) equals the JAX
    package's padded operator to 1e-13 relative (matvec, residual, lift,
    stacked and flat views, diagonal), is the identity on phantom rows, and
    equals the unpadded operator on the physical grid."""
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    z1, z2, b1, b2 = _padded_random(mesh.node_shape, padding, 0)
    state = from_numpy_state(PARAMS, cells, element, np.zeros(mesh.node_shape), np.zeros(mesh.node_shape),
                             device="cpu")
    op = DPPOperator(state.W, state.params, padding)
    jop = JOp(jmixed(jspaces(mesh)[1]), JParams(**PARAMS), padding)
    t = [torch.as_tensor(a) for a in (z1, z2, b1, b2)]
    j = [jnp.asarray(a) for a in (z1, z2, b1, b2)]
    for a, b in zip(op.matvec(t[0], t[1]), jop.matvec(j[0], j[1])):
        _close(a, b, 1e-13)
    for a, b in zip(op.residual(*t), jop.residual(*j)):
        _close(a, b, 1e-13)
    for a, b in zip(op.lifted_rhs(t[0], t[1]), jop.lifted_rhs(j[0], j[1])):
        _close(a, b, 1e-13)
    st = np.stack([z1, z2])
    _close(op.stacked_matvec()(torch.as_tensor(st)), jop.stacked_matvec()(jnp.asarray(st)), 1e-13)
    _close(op.flat_matvec()(torch.as_tensor(st.reshape(-1))), jop.flat_matvec()(jnp.asarray(st.reshape(-1))), 1e-13)
    assert np.array_equal(op.diagonal().numpy(), np.asarray(jop.diagonal()))
    assert np.array_equal(op._mask_arrays[0].numpy(), np.asarray(jop._mask_arrays[0]))
    # phantom rows are the identity; the physical block is the unpadded operator's
    phantom = torch.as_tensor(np.pad(np.zeros(mesh.node_shape, bool), [(0, p) for p in padding],
                                     constant_values=True))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((2,) + op.grid_shape))
    y = op.stacked_matvec()(x)
    assert torch.equal(y[:, phantom], x[:, phantom])
    crop = (slice(None),) + tuple(slice(0, n) for n in mesh.node_shape)
    base = DPPOperator(state.W, state.params)
    xz = torch.where(phantom, 0.0, x)
    assert torch.equal(op.stacked_matvec()(xz)[crop], base.stacked_matvec()(xz[crop].contiguous()))


@pytest.mark.parametrize("element,cells,padding", [PADDED[0], PADDED[2]], ids=["quad", "hex"])
def test_padded_field_operator_matches_jax(element, cells, padding):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    z, g = (torch.as_tensor(a) for a in _padded_random(mesh.node_shape, padding, 2, 2))
    state = from_numpy_state(PARAMS, cells, element, np.zeros(mesh.node_shape), np.zeros(mesh.node_shape),
                             device="cpu")
    fop = FieldOperator(state.W.sub(0), 1.3, 0.8, 1.1, padding)
    jfop = JField(jmixed(jspaces(mesh)[1]).sub(0), 1.3, 0.8, 1.1, padding)
    _close(fop.matvec(z), jfop.matvec(jnp.asarray(z.numpy())), 1e-13)
    _close(fop.lifted_rhs(g), jfop.lifted_rhs(jnp.asarray(g.numpy())), 1e-13)
    assert fop.padding == padding and np.array_equal(fop._mask_arrays[0].numpy(), np.asarray(jfop._mask_arrays[0]))


@pytest.mark.parametrize("cells,padding", [((4, 4), (3, 1)), ((3, 2, 2), (1, 2, 0))], ids=["q2-2d", "q2-3d"])
def test_padded_tensor_operators_match_jax(cells, padding):
    """The padded degree-2 operator (identity blocks in the 1D factors) and
    fast-diag solve equal the JAX package's to 1e-13; zero phantom data stays
    zero (inert rows), the solve passes phantoms through."""
    d = len(cells)
    mesh = StructuredMesh(cells=cells, element="quad" if d == 2 else "hex")
    jm = jmesh.StructuredMesh(cells=cells, element="quad" if d == 2 else "hex")
    p, jp = DPPParameters(**PARAMS), JParams(**PARAMS)
    op = tf.TensorDPPOperator(mesh, p, 2, padding, device="cpu")
    jop = jtf.TensorDPPOperator(jm, jp, 2, padding)
    assert op.dof_shape == jop.dof_shape
    z1, z2 = _padded_random(op.phys_shape, padding, 3, 2)
    t, j = (torch.as_tensor(z1), torch.as_tensor(z2)), (jnp.asarray(z1), jnp.asarray(z2))
    for a, b in zip(op.matvec(*t), jop.matvec(*j)):
        _close(a, b, 1e-13)
        assert not a.numpy()[np.pad(np.zeros(op.phys_shape, bool), [(0, q) for q in padding],
                                    constant_values=True)].any()
    for a, b in zip(op.lifted_rhs(*t), jop.lifted_rhs(*j)):
        _close(a, b, 1e-13)
    solve = tf.TensorFastDiagDPP(mesh, p, 2, padding, device="cpu").solve(*t)
    for a, b in zip(solve, jtf.TensorFastDiagDPP(jm, jp, 2, padding).solve(*j)):
        _close(a, b, 1e-13)


def test_padded_p2_operator_matches_jax():
    mesh = create_mesh(4, 4, quadrilateral=False)
    pad = (3, 1)
    p = DPPParameters(**PARAMS)
    op = sf.P2SimplexDPPOperator(mesh, p, pad, device="cpu")
    jop = jsf.P2SimplexDPPOperator(jmesh.create_mesh(4, 4, quadrilateral=False), JParams(**PARAMS), pad)
    assert op.dof_shape == jop.dof_shape == (12, 10)
    z1, z2 = (np.random.default_rng(s).standard_normal(op.dof_shape) for s in (5, 6))
    t, j = (torch.as_tensor(z1), torch.as_tensor(z2)), (jnp.asarray(z1), jnp.asarray(z2))
    for a, b in zip(op.matvec(*t), jop.matvec(*j)):
        _close(a, b, 1e-13)
    for a, b in zip(op.lifted_rhs(*t), jop.lifted_rhs(*j)):
        _close(a, b, 1e-13)
    # phantom rows (both padded axes, both fields) are the identity
    for y, z in zip(op.matvec(*t), (z1, z2)):
        assert np.array_equal(y.numpy()[9:], z[9:]) and np.array_equal(y.numpy()[:, 9:], z[:, 9:])


def test_padded_mixed_direct_equals_unpadded():
    """The mixed-precision direct solve on a padded grid: the unpadded
    solve's interior (1e-13) and the phantom rows passed through."""
    mesh = create_mesh(9, 6)
    p = DPPParameters(**PARAMS)
    pad = (2, 3)
    b1, b2 = (torch.as_tensor(a) for a in _padded_random(mesh.node_shape, pad, 7, 2))
    z = MixedPrecisionDPPDirect(mesh, p, device="cpu", padding=pad).solve(b1, b2)
    crop = tuple(slice(0, n) for n in mesh.node_shape)
    ref = MixedPrecisionDPPDirect(mesh, p, device="cpu").solve(b1[crop].contiguous(), b2[crop].contiguous())
    for a, r in zip(z, ref):
        _close(a[crop], r, 1e-13)
        assert not a.numpy()[mesh.node_shape[0]:].any()


# K1's halo twin over loopback blocks: (element, cells, block mesh, padded)
LOOPBACK = [
    ("quad", (15, 11), (4,), False), ("quad", (15, 11), (2, 2), False), ("triangle", (10, 13), (4, 2), True),
    ("hex", (5, 5, 7), (4,), False), ("hex", (5, 5, 7), (2, 2), False), ("tet", (6, 6, 4), (4, 2), True),
    ("hex", (5, 4, 4), (2, 1, 5), True),
]


@pytest.mark.parametrize("mode", ["matvec", "lift"])
@pytest.mark.parametrize("element,cells,blocks,padded", LOOPBACK,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[2]))}" for c in LOOPBACK])
def test_k1_halo_twin_over_loopback_blocks(element, cells, blocks, padded, mode):
    """K1's halo twin, one call a block of the (phantom-padded) grid with
    its ghosts moved between blocks, equals the whole-grid twin bit for bit;
    phantom rows are the identity."""
    shape = tuple(n + 1 for n in reversed(cells))
    z = torch.as_tensor(np.random.default_rng(8).standard_normal((2,) + shape))
    S = dpp_stencils(StructuredMesh(cells=cells, element=element), DPPParameters(**PARAMS))
    pad = [(-n) % b for n, b in zip(shape, blocks)] + [0] * (len(shape) - len(blocks))
    assert padded == any(pad)
    zp = F.pad(z, [v for q in reversed(pad) for v in (0, q)])
    want = zp.clone()
    want[(slice(None),) + tuple(slice(0, n) for n in shape)] = torch.stack(
        fused_dpp_apply_plain(z[0], z[1], *S, mode=mode))
    assert torch.equal(loopback_apply(zp, S, blocks, mode, n_phys=shape), want)
    assert torch.equal(join_blocks(split_blocks(zp, blocks), blocks), zp)


# the planes entry against the extended-box twin: (element, cells, blocks)
PLANES = [
    ("quad", (15, 11), (4,)), ("triangle", (10, 13), (2, 2)), ("quad", (12, 16), (4, 2)),
    ("hex", (7, 5, 6), (4,)), ("tet", (5, 6, 7), (2, 2)), ("hex", (6, 4, 5), (4, 2)), ("hex", (5, 4, 4), (2, 1, 5)),
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["matvec", "lift"])
@pytest.mark.parametrize("element,cells,blocks", PLANES, ids=[f"{c[0]}-{'x'.join(map(str, c[2]))}" for c in PLANES])
def test_halo_planes_entry_equals_the_box_twin(element, cells, blocks, mode, dtype):
    """Each block of a (phantom-padded) grid through the planes entry, its
    planes as the exchange builds them (None at the grid's edges) and read
    through the kernel's regions, equals the extended-box twin on the block
    extended whole, bit for bit; the planes are plane-sized."""
    shape = tuple(n + 1 for n in reversed(cells))
    z = torch.as_tensor(np.random.default_rng(9).standard_normal((2,) + shape)).to(dtype)
    S = dpp_stencils(StructuredMesh(cells=cells, element=element), DPPParameters(**PARAMS))
    pad = [(-n) % b for n, b in zip(shape, blocks)] + [0] * (len(shape) - len(blocks))
    zp = F.pad(z, [v for q in reversed(pad) for v in (0, q)])
    split = split_blocks(zp, blocks)
    planes = loopback_planes(split, blocks)
    local = [n // b for n, b in zip(zp.shape[1:], blocks)] + list(zp.shape[1 + len(blocks):])
    for c, b in split.items():
        ghosts, offsets, n_phys = block_geometry(blocks, c, local, shape)
        got = fused_dpp_apply_halo_planes(b[0], b[1], planes[c], *S, mode=mode, offsets=offsets, n_phys=n_phys)
        box = halo_box(b, planes[c])
        assert tuple(box.shape[1:]) == tuple(n + 2 * (k < len(blocks)) for k, n in enumerate(b.shape[1:]))
        want = fused_dpp_apply_halo_plain(box, *S, mode=mode, ghosts=ghosts, offsets=offsets, n_phys=n_phys)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(fused_dpp_apply_halo(box, *S, mode=mode, ghosts=ghosts, offsets=offsets, n_phys=n_phys), want)
        for k, pair in enumerate(planes[c]):
            for side, g in enumerate(pair):
                edge = c[k] == (0 if side == 0 else blocks[k] - 1)
                assert (g is None) == edge
                if g is not None:
                    assert tuple(g.shape) == (2,) + tuple(box.shape[1:1 + k]) + (1,) + tuple(b.shape[2 + k:])
    # what a rank sends along axis 1 carries the axis-0 ghosts' edge rows
    c = (1,) + (0,) * (len(blocks) - 1)
    if len(blocks) > 1:
        sent = send_plane(split[c], planes[c][:1], 1, 0)
        assert torch.equal(sent, halo_box(split[c], planes[c][:1]).narrow(2, 0, 1))


# boxes for the plan: (box, ghosts, offsets, n_phys) — edge ranks, boxes
# thinner than a chunk, 1-plane slabs, phantoms past the physical grid, 2D
PLAN_BOXES = [
    ((129, 129, 129), None, None, None),
    ((136, 129, 129), None, None, (129, 129, 129)),
    ((19, 129, 129), ((1, 1), (0, 0), (0, 0)), (0, 0, 0), (129, 129, 129)),
    ((19, 129, 129), ((1, 1), (0, 0), (0, 0)), (51, 0, 0), (129, 129, 129)),
    ((19, 129, 129), ((1, 1), (0, 0), (0, 0)), (119, 0, 0), (129, 129, 129)),
    ((4, 20, 37), ((1, 1), (0, 0), (0, 0)), (5, 0, 0), (40, 20, 37)),  # 2 owned planes, thinner than a chunk
    ((3, 18, 35), ((1, 1), (0, 0), (0, 0)), (7, 0, 0), (16, 18, 35)),  # a 1-plane slab
    ((3, 18, 35), ((1, 1), (0, 0), (0, 0)), (15, 0, 0), (16, 18, 35)),  # a 1-plane slab on the boundary
    ((3, 18, 35), ((1, 1), (0, 0), (0, 0)), (17, 0, 0), (16, 18, 35)),  # a slab of phantoms
    ((7, 11, 35), ((1, 1), (1, 1), (0, 0)), (0, 9, 0), (12, 14, 35)),  # a pencil at the corner
    ((10, 6, 9), ((0, 1), (1, 1), (1, 0)), (0, 4, 14), (8, 30, 15)),
    ((2, 2, 2), None, None, None),  # no interior
    ((130, 1026), ((1, 1), (0, 0)), (256, 0), (1024, 1024)),
    ((18, 35), ((1, 1), (1, 1)), (16, 99), (1024, 110)),
]


@pytest.mark.parametrize("wave", [DEFAULT_WAVE, 1, 10 ** 6], ids=["h100", "one", "huge"])
@pytest.mark.parametrize("box,ghosts,offsets,n_phys", PLAN_BOXES, ids=[str(i) for i in range(len(PLAN_BOXES))])
def test_halo_plan_writes_every_owned_node_once(box, ghosts, offsets, n_phys, wave):
    """Every owned node is written by exactly one block of the plan: by a
    stencil tile where it is a global interior node, raw elsewhere; the
    chunk is :func:`fill_chunk`'s; a 129^3 box with no ghost is tiled as K1
    tiles it (8 x 8 x 32 blocks at K1's chunk of 4; 8 x 8 x 16 at the
    rule's 8 for the H100's wave)."""
    plan = halo_plan(box, ghosts, offsets, n_phys, wave)
    count, stencil = plan_writes(plan)
    assert (count == 1).all()
    gh, off, nph = halo_geometry(box, ghosts, offsets, n_phys)
    interior = np.ones(plan.nout, dtype=bool)
    for a, (o, n, lo, nn) in enumerate(zip(off, plan.nout[3 - len(box):], gh, nph)):
        g = np.arange(n) + o
        shape = [1, 1, 1]
        shape[3 - len(box) + a] = n
        interior &= ((g >= 1) & (g <= nn - 2)).reshape(shape)
    assert np.array_equal(stencil, interior)
    if len(box) == 3:
        columns, planes = plan.blocks[1] * plan.blocks[2], plan.c1[0] - plan.c0[0]
        assert plan.chunk == fill_chunk(columns, planes, wave) and plan.chunk in (4, 8)
        if wave == 10 ** 6:
            assert plan.chunk == 4
        if wave == 1 and columns * -(-planes // 8) >= 2:
            assert plan.chunk == 8
        for chunk in (1, 2, 3, 5):  # any chunk the launcher is given
            assert (plan_writes(halo_plan(box, ghosts, offsets, n_phys, wave, chunk))[0] == 1).all()
    if box == (129, 129, 129) and wave == DEFAULT_WAVE:
        assert plan.blocks == (16, 8, 8) and plan.chunk == 8
        assert halo_plan(box, chunk=4).blocks == (32, 8, 8)


def test_halo_geometry_refuses():
    """Ghosts are 0 or 1 a side, and an owned interior node needs both
    neighbours in the box: the wrapper refuses other geometries on every
    device."""
    z = torch.zeros((2, 6, 5))
    S = [np.ones((3, 3))] * 3
    for kw in (dict(ghosts=((2, 0), (0, 0))), dict(ghosts=((0, 0), (0, 0)), offsets=(3, 0), n_phys=(12, 5)),
               dict(ghosts=((1, 0), (0, 0)), n_phys=(12, 5)), dict(offsets=(-1, 0))):
        with pytest.raises(ValueError):
            fused_dpp_apply_halo(z, *S, **kw)
    # the last block of a padded grid needs no high ghost: its owned nodes
    # from n_phys - 1 on are boundary and phantom rows
    assert halo_geometry((6, 5), ((1, 0), (0, 0)), (7, 0), (10, 5)) == (((1, 0), (0, 0)), (7, 0), (10, 5))


def _jax_padded_case(element, n, degree, padding):
    jm = (jmesh.create_mesh(n, n, quadrilateral=element == "quad") if element in ("quad", "triangle")
          else jmesh.create_cube_mesh(n, n, n, hexahedral=element == "hex"))
    jW = jmixed(JFunctionSpace(jm, degree=degree)) if degree > 1 else jmixed(jspaces(jm)[1])
    exact = jms.exact_expressions if jm.dim == 2 else jms.exact_expressions_3d
    _, p1, _, p2 = exact(jW.mesh, JParams())
    g = [jnp.pad(a, [(0, q) for q in padding]) for a in jbcv(jW, [JBC(jW.sub(0), p1), JBC(jW.sub(1), p2)])]
    return jW, g


BUILDERS = [  # element, n, degree, options, padding, builder, tolerance on the fields
    ("quad", 8, 1, sp.PLAIN_GMRES_PARAMS, (3, 1), _build_linear_solver, 1e-6),
    ("hex", 5, 1, {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}, (2, 0, 1), _build_linear_solver, 1e-9),
    ("quad", 6, 1, sp.LINEAR_SOLVER_PARAMS, (1, 3), _build_linear_solver, 1e-10),
    ("quad", 4, 2, {"ksp_type": "gmres", "pc_type": "fieldsplit", "ksp_rtol": 1e-8}, (3, 1),
     _build_tensor_linear_solver, 1e-10),
    ("quad", 4, 2, {"ksp_type": "preonly", "pc_type": "lu"}, (1, 2), _build_tensor_linear_solver, 1e-10),
    ("triangle", 4, 2, {"ksp_type": "gmres", "pc_type": "jacobi", "ksp_rtol": 1e-8}, (3, 1),
     _build_simplex_p2_linear_solver, 1e-12),
]


@pytest.mark.parametrize("element,n,degree,options,padding,builder,tol", BUILDERS,
                         ids=["q1-gmres", "hex-fieldsplit", "q1-direct", "q2-fieldsplit", "q2-direct", "p2-jacobi"])
def test_padded_builders_match_jax(element, n, degree, options, padding, builder, tol):
    """The builders' padded solve (``padding``): the JAX package's padded
    builder's count and fields, phantom rows zero, and the unpadded solve's
    fields on the physical grid; a padding of zeros is the unpadded call's
    cache entry."""
    W = _space(element, n, degree, "cpu")
    frozen = _freeze(options)
    g = [torch.as_tensor(np.array(a)) for a in _jax_padded_case(element, n, degree, padding)[1]]
    z1, z2, its, _ = builder(W, DPPParameters(), frozen, padding)(*g)
    jW, jg = _jax_padded_case(element, n, degree, padding)
    jbuild = {_build_linear_solver: jsolver._build_linear_solver,
              _build_tensor_linear_solver: jsolver._build_tensor_linear_solver,
              _build_simplex_p2_linear_solver: jsolver._build_simplex_p2_linear_solver}[builder]
    jz1, jz2, jits, _ = jbuild(jW, JParams(), jsolver._freeze(options), padding)(*jg)
    assert its == int(jits)
    ref = solve_dpp(W, DPPParameters(), _manufactured_bcs(W), solver_parameters=options)
    crop = tuple(slice(0, m) for m in W.spaces[0].dof_shape)
    for a, b, r in zip((z1, z2), (jz1, jz2), ref.solution.data):
        _close(a, np.asarray(b), max(tol, 1e-9))
        _close(a[crop], r, tol)
        assert not a.numpy()[W.spaces[0].dof_shape[0]:].any()
    zero = (0,) * len(padding)
    assert builder(W, DPPParameters(), frozen, zero) is builder(W, DPPParameters(), frozen)


def test_world_of_one_without_a_process_group():
    """A mesh of one rank needs no process group: the sharded entries then
    equal the single-device solves, the mesh helpers are the identity, and a
    sharded P2 preonly solve is refused on a divisible lattice too."""
    dm = device_mesh([1, 1], axis_names=("y", "x"), device="cpu")
    assert dm.shape == (1, 1) and dm.coords == (0, 0)
    assert field_spec(dm, 2) == (None, "y", "x") and field_spec(device_mesh([1], device="cpu"), 3) == (None, "z", None, None)
    assert mesh_padding((9, 7), dm) == (0, 0)
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(shard_grid(x, dm), x) and torch.equal(shard_stacked(torch.stack([x, x]), dm)[1], x)
    with pytest.raises(ValueError, match="Need 2 ranks"):
        device_mesh([2], device="cpu")
    for element, n, options, nonlinear in (("quad", 8, sp.GMRES_ILU_PARAMS, False),
                                           ("quad", 8, sp.PICARD_LU_SOLVER_PARAMS, True),
                                           ("quad", 8, {**sp.GMRES_ILU_PARAMS, "pc_factor_mat_ordering_type": "rcm"},
                                            False)):
        W = _space(element, n, 1, "cpu")
        bcs = _manufactured_bcs(W)
        fn, ref_fn = (sharded_solve_dpp_nonlinear, solve_dpp_nonlinear) if nonlinear else (sharded_solve_dpp, solve_dpp)
        sol = fn(W, DPPParameters(), bcs, dm, solver_parameters=options)
        ref = ref_fn(W, DPPParameters(), bcs, solver_parameters=options)
        assert sol.iteration_number == ref.iteration_number
        for a, b in zip(sol.solution.data, ref.solution.data):
            _close(a, b, 1e-9)
    W = _space("triangle", 8, 2, "cpu")
    with pytest.raises(NotImplementedError, match="sharded P2 simplex"):
        sharded_solve_dpp(W, DPPParameters(), [], dm, solver_parameters={"ksp_type": "preonly", "pc_type": "lu"})
    with pytest.raises(ValueError, match="Bad padding"):
        DPPOperator(_space("quad", 4, 1, "cpu"), DPPParameters(), (1,))
    g = bc_values_per_field(W, [])
    assert tuple(g[0].shape) == W.spaces[0].dof_shape  # boundary data stays unpadded


@pytest.fixture(scope="module")
def world_of_two():
    return spawn_world(2, "halo_bench", {"device": "cpu", "n": 6}, timeout=300.0)


def test_benchmark_vs_gathered_on_two_ranks(world_of_two):
    """``benchmark_vs_gathered`` on (2,) slabs of a padded hex grid: both
    times and a difference of 0 on every rank; ``make_global`` cuts each
    rank's slab, ``replicate_scalar`` gives rank 0's value everywhere."""
    grid = np.arange(8 * 7 * 7, dtype=np.float64).reshape(8, 7, 7)  # 7 nodes padded to 8
    for rank, r in enumerate(world_of_two):
        bench = r["bench"]
        assert bench["max_abs_diff"] == 0.0 and bench["halo_s"] > 0 and bench["gathered_s"] > 0
        assert bench["mesh"] == {"z": 2}
        assert r["coords"] == (rank,) and np.array_equal(r["block"], grid[4 * rank: 4 * rank + 4])
        assert r["scalar"] == 7.0


@pytest.fixture(scope="module")
def halo_world_of_two():
    cases = [dict(element="hex", cells=(5, 4, 6), axes=[2], names=["z"], seed=1, params=PARAMS),
             dict(element="quad", cells=(9, 6), axes=[1, 2], names=["y", "x"], seed=2, params=PARAMS),
             dict(element="tet", cells=(4, 5, 3), axes=[2, 1], names=["z", "y"], seed=3, params=PARAMS)]
    return cases, spawn_world(2, "halo_matvecs", {"device": "cpu", "cases": cases}, timeout=300.0)


def test_sharded_apply_on_two_ranks_matches_jax(halo_world_of_two):
    """The sharded matvec and lift (planes exchanged between two gloo ranks,
    the planes entry on each block) gathered: the JAX package's padded
    ``DPPOperator`` stacked matvec and lift on the gathered grid within
    1e-13, the same on both ranks, one exchange a split axis an apply."""
    cases, world = halo_world_of_two
    for i, case in enumerate(cases):
        shape = tuple(n + 1 for n in reversed(case["cells"]))
        x = np.random.default_rng(case["seed"]).standard_normal((2,) + shape)
        r0 = world[0][i]
        pad = r0["padding"]
        xp = np.pad(x, [(0, 0)] + [(0, p) for p in pad])
        mesh = jmesh.StructuredMesh(cells=tuple(case["cells"]), element=case["element"])
        jop = JOp(jmixed(jspaces(mesh)[1]), JParams(**PARAMS), pad)
        _close(r0["matvec"], jop.stacked_matvec()(jnp.asarray(xp)), 1e-13)
        _close(r0["lift"], np.stack(jop.lifted_rhs(jnp.asarray(xp[0]), jnp.asarray(xp[1]))), 1e-13)
        for rank in world:
            assert np.array_equal(rank[i]["matvec"], r0["matvec"]) and np.array_equal(rank[i]["lift"], r0["lift"])
            assert rank[i]["collectives"]["exchange"] == 2 * len(case["axes"])
