"""Parity of the port's assembled operator (K1's plain twin on the CPU) with
the JAX package: matvec, residual, lift, flat/stacked views and diagonal on
2D quad/tri and 3D hex/tet, and K1's plain twin against the Pallas kernel
in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC, DPPOperator as JOp, bc_values_per_field as jbcv
from perphil_tpu.ops.pallas_kernels import fused_dpp_apply as jax_fused_dpp_apply

from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.ops import _cuda
from perphil_tpu_torch.ops.assembly import DPPOperator, _masks, bc_values_per_field, dpp_stencils
from perphil_tpu_torch.ops.fused_apply import (
    box_boundary,
    fused_dpp_apply,
    fused_dpp_apply_plain,
    fused_dpp_apply_stacked,
    pack_weights,
    packed_weights,
)

PARAMS = dict(k1=1.3, beta=0.8, mu=1.1)
CASES = [("quad", (8, 8)), ("triangle", (8, 8)), ("hex", (4, 4, 4)), ("tet", (4, 4, 4))]
CASE_IDS = [c[0] for c in CASES]


def _pair(element, cells, seed=0):
    """The same random system in both packages: (port op, JAX op, arrays)."""
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(mesh.node_shape) for _ in range(4)]
    state = from_numpy_state(PARAMS, cells, element, arrs[0], arrs[1], device="cpu")
    _, jV = jspaces_of(mesh)
    jop = JOp(jmixed(jV), JParams(**PARAMS))
    return DPPOperator(state.W, state.params), jop, arrs, state


def _stencils(element, cells, params=PARAMS):
    mesh = jmesh.StructuredMesh(cells=cells, element=element)
    zero = np.zeros(mesh.node_shape)
    state = from_numpy_state(params, cells, element, zero, zero, device="cpu")
    return mesh, dpp_stencils(state.mesh, state.params)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= rtol * np.abs(b).max(), np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("element,cells", CASES, ids=CASE_IDS)
def test_matvec_residual_lift_match(element, cells):
    op, jop, (z1, z2, b1, b2), _ = _pair(element, cells)
    t = [torch.as_tensor(a) for a in (z1, z2, b1, b2)]
    j = [jnp.asarray(a) for a in (z1, z2, b1, b2)]
    for a, b in zip(op.matvec(t[0], t[1]), jop.matvec(j[0], j[1])):
        _close(a, b, 1e-13)
    for a, b in zip(op.residual(*t), jop.residual(*j)):
        _close(a, b, 1e-13)
    for a, b in zip(op.lifted_rhs(t[0], t[1]), jop.lifted_rhs(j[0], j[1])):
        _close(a, b, 1e-13)


@pytest.mark.parametrize("element,cells", CASES, ids=CASE_IDS)
def test_flat_stacked_diagonal_match(element, cells):
    op, jop, (z1, z2, _, _), _ = _pair(element, cells, seed=1)
    flat = np.concatenate([z1.ravel(), z2.ravel()])
    _close(op.flat_matvec()(torch.as_tensor(flat)), jop.flat_matvec()(jnp.asarray(flat)), 1e-13)
    st = np.stack([z1, z2])
    _close(op.stacked_matvec()(torch.as_tensor(st)), jop.stacked_matvec()(jnp.asarray(st)), 1e-13)
    assert np.array_equal(op.diagonal().numpy(), np.asarray(jop.diagonal()))
    assert np.array_equal(op._mask_arrays[0].numpy(), np.asarray(jop._mask_arrays[0]))


@pytest.mark.parametrize("element,cells", CASES, ids=CASE_IDS)
def test_bc_values_per_field_match(element, cells):
    _, jop, (g1, g2, _, _), state = _pair(element, cells, seed=2)
    W = jop.W
    jg = jbcv(W, [JBC(W.sub(0), jnp.asarray(g1)), JBC(W.sub(1), jnp.asarray(g2))])
    tg = bc_values_per_field(state.W, state.bcs)
    for a, b in zip(tg, jg):
        assert np.array_equal(a.numpy(), np.asarray(b))
    zero = bc_values_per_field(state.W, [state.bcs[1]])[0]
    assert not zero.any() and zero.dtype == torch.float64


@pytest.mark.parametrize("element,cells", [("quad", (13, 9)), ("hex", (7, 6, 5))], ids=["2d", "3d"])
def test_k1_twin_matches_pallas_interpret_f32(element, cells):
    """K1's twin in matvec mode vs the Pallas kernel on interior-masked f32
    input plus identity boundary rows. The combined stencil sums in another
    order, so the tolerance is f32-level (rtol 1e-5)."""
    mesh, (S1, S2, C) = _stencils(element, cells)
    rng = np.random.default_rng(3)
    z1, z2 = (rng.standard_normal(mesh.node_shape).astype(np.float32) for _ in range(2))
    bdry, interior = _masks(mesh)
    y1, y2 = jax_fused_dpp_apply(
        jnp.asarray(np.where(interior, z1, 0.0).astype(np.float32)),
        jnp.asarray(np.where(interior, z2, 0.0).astype(np.float32)),
        S1, S2, C, interpret=True,
    )
    ref = [np.where(bdry, z, np.asarray(y)) for z, y in ((z1, y1), (z2, y2))]
    out = fused_dpp_apply_plain(torch.as_tensor(z1), torch.as_tensor(z2), S1, S2, C, mode="matvec")
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - b).max() <= 1e-5 * (np.abs(b).max() + 1.0)


def test_k1_wrapper_on_cpu_is_the_twin_and_checks_inputs():
    mesh, S = _stencils("triangle", (5, 6), {})
    rng = np.random.default_rng(4)
    z1, z2 = (torch.as_tensor(rng.standard_normal(mesh.node_shape)) for _ in range(2))
    before = dict(_cuda.KERNEL_LAUNCHES)
    for mode in ("matvec", "lift"):
        for a, b in zip(fused_dpp_apply(z1, z2, *S, mode=mode), fused_dpp_apply_plain(z1, z2, *S, mode=mode)):
            assert torch.equal(a, b)
    assert dict(_cuda.KERNEL_LAUNCHES) == before  # CPU tensors launch nothing
    with pytest.raises(ValueError, match="mode"):
        fused_dpp_apply(z1, z2, *S, mode="raw")
    with pytest.raises(ValueError):
        fused_dpp_apply(z1, z2[:-1], *S)
    with pytest.raises(TypeError):
        fused_dpp_apply(z1.to(torch.int64), z2.to(torch.int64), *S)


@pytest.mark.parametrize("element,cells", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("mode", ["matvec", "lift"])
def test_k1_stacked_entry_is_the_pair_path(element, cells, mode):
    """On CPU tensors the stacked entry is the (z1, z2) twin, stacked, and
    launches nothing; the operator's stacked and flat views go through it."""
    op, _, (z1, z2, _, _), _ = _pair(element, cells, seed=5)
    S = dpp_stencils(op.mesh, op.params)
    z = torch.stack([torch.as_tensor(z1), torch.as_tensor(z2)])
    before = dict(_cuda.KERNEL_LAUNCHES)
    y = fused_dpp_apply_stacked(z, *S, mode=mode)
    assert torch.equal(y, torch.stack(fused_dpp_apply(z[0], z[1], *S, mode=mode)))
    if mode == "matvec":
        assert torch.equal(op.stacked_matvec()(z), y)
        assert torch.equal(op.flat_matvec()(z.reshape(-1)), y.reshape(-1))
    assert dict(_cuda.KERNEL_LAUNCHES) == before
    with pytest.raises(ValueError, match="stacked"):
        fused_dpp_apply_stacked(z[0], *S, mode=mode)


def test_box_boundary_and_weights():
    mesh = jmesh.StructuredMesh(cells=(3, 4, 2), element="tet")
    assert np.array_equal(box_boundary(mesh.node_shape, torch.device("cpu")).numpy(), mesh.boundary_mask())
    S1, S2, C = (np.full((3, 3), v) for v in (1.0, 2.0, 3.0))
    w = pack_weights(S1, S2, C)
    assert w.shape == (3, 27) and w.dtype == np.float64
    assert np.array_equal(w[:, :9], np.repeat([[1.0], [2.0], [3.0]], 9, axis=1)) and not w[:, 9:].any()
    # the wrappers' weights: packed once per stencil set, by value, read-only
    cached = packed_weights(S1, S2, C)
    assert np.array_equal(cached, w) and not cached.flags.writeable
    assert packed_weights(S1.copy(), S2, C) is cached
    assert np.array_equal(packed_weights(S2, S1, C)[:2], w[[1, 0]])


def test_padding_is_not_ported():
    state = from_numpy_state({}, (4, 4), "quad", np.zeros((5, 5)), np.zeros((5, 5)), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 9"):
        DPPOperator(state.W, state.params, padding=(1, 0))
