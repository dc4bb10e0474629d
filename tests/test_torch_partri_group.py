"""Partri's grouped 2D pass (``ops/partri.py::GridTriSolve2D(..., group=G)``,
the solve option ``partri_group``) on the CPU, against the JAX package's
grouped mode (``PERPHIL_TPU_PARTRI_GROUP``) and the port's own tree:

- ``GridTriSolve2D`` at the JAX test's three shapes (divisible,
  non-divisible, wide rows; ``tests/test_partri.py``) on seeded f64 numpy
  coefficients: the grouped solve against the JAX package's grouped one and
  against the port's tree, 1e-12 relative (the same recurrence summed in
  other orders; measured 0 against JAX, <= 4e-16 against the tree);
- ``PartriILU`` / ``PartriGS`` grouped on 2D fields and monolithic systems
  against the JAX package's grouped partri (its ILU in float64) and the
  wavefront twins (``StructuredILU0``, ``GaussSeidelSweeper``), 1e-12;
- the option through the host GMRES+ILU loop (the count of the ungrouped
  loop), the 3D plane solves staying on the tree, and the plan's bytes.

The JAX package reads its switches when a solver is built, hence the
``monkeypatch`` around each JAX construction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.ops.ilu as jilu
import perphil_tpu.ops.partri as jpartri
from perphil_tpu.models.dpp import DPPParameters as JParams

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.ops import ilu, partri
from perphil_tpu_torch.ops.assembly import DPPOperator
from perphil_tpu_torch.solvers import solve_dpp
from perphil_tpu_torch.solvers.solver import _freeze, _monolithic_pc

TOL = 1e-12  # relative, the same recurrence summed in other orders
SHAPES = [(64, 17, 32), (257, 33, 32), (70, 9, 16)]  # ny, nx, G: divisible, not, wide rows
PARAMS = {"k1": 1.2, "beta": 0.9}


def _rel(a, b) -> float:
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.abs(a - b).max() / np.abs(b).max())


def _coefficients(ny, nx):
    rng = np.random.default_rng(11)
    return [rng.normal(0.0, 0.3, (ny, nx)) for _ in range(5)]  # wr, bm, b0, bp, c


@pytest.mark.parametrize("ny,nx,G", SHAPES, ids=[f"{ny}x{nx}-G{G}" for ny, nx, G in SHAPES])
def test_grouped_solve_matches_jax_grouped(monkeypatch, ny, nx, G):
    *coef, c = _coefficients(ny, nx)
    monkeypatch.setenv("PERPHIL_TPU_PARTRI_GROUP", str(G))
    ref = jpartri.GridTriSolve2D(*(jnp.asarray(a) for a in coef))
    assert ref.chain is None  # the JAX package's grouped mode
    got = partri.GridTriSolve2D(*(torch.tensor(a) for a in coef), group=G)
    assert (got.G, got.ngroups, got.pad) == (G, -(-ny // G), -(-ny // G) * G - ny) and got.chain is None
    x = got.apply(torch.tensor(c)).numpy()
    assert _rel(x, np.asarray(ref.apply(jnp.asarray(c)))) <= TOL
    # the maps kept: one a group, nx^2 each
    assert tuple(got.g_Mhat.shape) == (got.ngroups, nx, nx)


@pytest.mark.parametrize("ny,nx,G", SHAPES, ids=[f"{ny}x{nx}-G{G}" for ny, nx, G in SHAPES])
def test_grouped_solve_matches_the_tree(ny, nx, G):
    *coef, c = _coefficients(ny, nx)
    coef = [torch.tensor(a) for a in coef]
    tree, grouped = partri.GridTriSolve2D(*coef), partri.GridTriSolve2D(*coef, group=G)
    assert tree.G == 0 and tree.chain is not None
    x = grouped.apply(torch.tensor(c))
    assert _rel(x.numpy(), tree.apply(torch.tensor(c)).numpy()) <= TOL
    # a sequential numpy recurrence, row by row
    wr, bm, b0, bp = (a.numpy() for a in coef)
    ref = np.zeros((ny, nx))
    for y in range(ny):
        up = ref[y - 1] if y else np.zeros(nx)
        row = c[y] + bm[y] * np.pad(up[:-1], (1, 0)) + b0[y] * up + bp[y] * np.pad(up[1:], (0, 1))
        for i in range(nx):
            ref[y, i] = row[i] + (wr[y, i] * ref[y, i - 1] if i else 0.0)
    assert _rel(x.numpy(), ref) <= TOL


def test_grouped_mode_only_where_it_applies():
    """Batched coefficients (the 3D plane solver) and ``ny < 2 G`` stay on
    the tree; the grouped pass solves one right-hand side at a time."""
    *coef, c = _coefficients(20, 7)
    coef = [torch.tensor(a) for a in coef]
    assert partri.GridTriSolve2D(*coef, group=11).G == 0
    assert partri.GridTriSolve2D(*coef, group=10).G == 10
    batched = partri.GridTriSolve2D(*(a.expand(3, 20, 7) for a in coef), group=4)
    assert batched.G == 0 and batched.chain is not None
    with pytest.raises(ValueError, match="one right-hand side"):
        partri.GridTriSolve2D(*coef, group=5).apply_columns(torch.tensor(c)[..., None])
    with pytest.raises(ValueError, match="group"):
        partri.GridTriSolve2D(*coef, group=-1)


def _systems(element, cells, kind):
    jm, m = jmesh.StructuredMesh(cells=cells, element=element), StructuredMesh(cells=cells, element=element)
    jp, p = JParams(**PARAMS), DPPParameters(**PARAMS)
    if kind == "monolithic":
        return jilu.build_monolithic_system(jm, jp), ilu.build_monolithic_system(m, p)
    return jilu.build_field_system(jm, jp.k2, jp.beta, jp.mu), ilu.build_field_system(m, p.k2, p.beta, p.mu)


CASES = [("quad", (16, 16), "field", 4), ("quad", (16, 16), "monolithic", 8), ("triangle", (12, 15), "monolithic", 5)]
CASE_IDS = [f"{e}{c[0]}-{k}-G{g}" for e, c, k, g in CASES]


@pytest.mark.parametrize("element,cells,kind,G", CASES, ids=CASE_IDS)
def test_grouped_ilu_matches_jax_and_wavefront(monkeypatch, element, cells, kind, G):
    """``PartriILU`` grouped against the JAX package's grouped partri ILU
    (float64) and the wavefront twin (``structured_ilu_apply``'s plain
    sweep)."""
    jsys, sys = _systems(element, cells, kind)
    monkeypatch.setenv("PERPHIL_TPU_ILU_DTYPE", "float64")
    monkeypatch.setenv("PERPHIL_TPU_PARTRI_GROUP", str(G))
    monkeypatch.delenv("PERPHIL_TPU_TRISOLVE", raising=False)
    jref = jilu.StructuredILU0._from_system(jsys)
    assert jref.partri is not None
    got = ilu.PartriILU.for_system(sys, "cpu", group=G)
    assert got.group == G and all(s.solver.G == G for s in (*got.lower_solve, *got.upper_solve))
    r = np.random.default_rng(13).standard_normal(sys.nrows)
    z = got.apply_flat(torch.tensor(r)).numpy()
    assert _rel(z, np.asarray(jref.apply_flat(jnp.asarray(r)))) <= TOL
    assert _rel(z, ilu.StructuredILU0(sys, "cpu").plain(torch.tensor(r)).numpy()) <= TOL


@pytest.mark.parametrize("element,cells,kind,G", CASES, ids=CASE_IDS)
def test_grouped_gs_matches_the_wavefront(element, cells, kind, G):
    _, sys = _systems(element, cells, kind)
    got = ilu.PartriGS.for_system(sys, "cpu", group=G)
    assert all(s.solver.G == G for s in got.ld_solve)
    x, b = np.random.default_rng(14).standard_normal((2, sys.nrows))
    z = got.sweep(torch.tensor(x), torch.tensor(b)).numpy()
    assert _rel(z, ilu.GaussSeidelSweeper(sys, "cpu").plain(torch.tensor(x), torch.tensor(b)).numpy()) <= TOL
    assert _rel(z, ilu.PartriGS.for_system(sys, "cpu").sweep(torch.tensor(x), torch.tensor(b)).numpy()) <= TOL


def test_3d_planes_stay_on_the_tree():
    _, sys = _systems("hex", (3, 4, 5), "field")
    got = ilu.PartriILU.for_system(sys, "cpu", group=2)
    assert all(s.solver.plane2d.G == 0 for s in got.lower_solve)
    r = torch.tensor(np.random.default_rng(15).standard_normal(sys.nrows))
    assert torch.equal(got.apply_flat(r), ilu.PartriILU.for_system(sys, "cpu").apply_flat(r))


@pytest.mark.parametrize("option", [{}, {"fieldsplit_inner_ksp": "pcg"}], ids=["literal", "pcg"])
def test_option_through_the_host_routes(option):
    """``trisolve_backend: partri`` with ``partri_group``: the host GMRES+ILU
    loop lands the ungrouped loop's count and fields, and the host route's
    fieldsplit with GMRES + ILU blocks (what SS-GMRES+ILU runs beyond K8's
    envelope, whatever ``fieldsplit_inner_ksp`` says) applies as the
    ungrouped one."""
    mesh = jmesh.StructuredMesh(cells=(16, 16), element="quad")
    rng = np.random.default_rng(16)
    g1, g2 = rng.standard_normal((2,) + mesh.node_shape)
    state = from_numpy_state({}, (16, 16), "quad", g1, g2, device="cpu")
    base = {"trisolve_backend": "partri", **option}
    sols = [
        solve_dpp(state.W, state.params, state.bcs, solver_parameters={**sp.GMRES_ILU_PARAMS, **base, **group})
        for group in ({"partri_group": 4}, {})
    ]
    assert sols[0].iteration_number == sols[1].iteration_number > 0
    for a, b in zip(sols[0].solution.data, sols[1].solution.data):
        assert _rel(a.numpy(), b.numpy()) <= 1e-10
    op = DPPOperator(state.W, state.params)
    ssi = {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_ILU_PARAMS, **base}
    grouped = _monolithic_pc(op, dict(_freeze({**ssi, "partri_group": 4})))
    tree = _monolithic_pc(op, dict(_freeze(ssi)))
    r = torch.tensor(rng.standard_normal((2,) + mesh.node_shape))
    assert _rel(grouped(r).numpy(), tree(r).numpy()) <= 1e-10


PLAN = [  # node shape, fields, group, bytes of the maps: two directional solves a field
    ((129, 129), 2, 16, 2 * 2 * 9 * 129**2 * 8),  # 9 groups of 16 rows (the last short)
    ((257, 257), 2, 32, 2 * 2 * 9 * 257**2 * 8),
    ((257, 257), 1, 16, 2 * 17 * 257**2 * 8),
    ((20, 20), 2, 11, 2 * 2 * 2 * 20 * 20**2 * 8),  # ny < 2 G: the tree's
    ((9, 9, 9), 2, 2, 2 * 2 * 2 * 9 * 81**2 * 8),  # 3D: the tree's
]


@pytest.mark.parametrize("shape,nfields,G,nbytes", PLAN, ids=["2d128", "2d256", "field256", "short", "3d"])
def test_partri_plan_counts_the_groups_maps(shape, nfields, G, nbytes):
    assert ilu.partri_plan(shape, nfields, group=G) == nbytes
    assert ilu.partri_plan(shape, nfields, group=G) <= ilu.partri_plan(shape, nfields)
    tree_set = ilu.partri_plan(shape, 1) // 4
    extra = (5 if len(shape) == 2 else 7) * tree_set + 64 * nfields * int(np.prod(shape)) * 8
    assert ilu.partri_peak(shape, nfields, group=G) == nbytes + extra
