"""Parity of the PyTorch port's host-side modules with the JAX package:
meshes, element matrices, stencils, quadrature, spaces, manufactured
solutions, parameters, presets and options. Both packages get the same
inputs, made with numpy from a seed."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.forms.spaces as jspaces
import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.ops.element as jelement
import perphil_tpu.ops.stencil as jstencil
import perphil_tpu.solvers.options as joptions
import perphil_tpu.solvers.parameters as jparams
import perphil_tpu.solvers.solver as jsolver
import perphil_tpu.utils.manufactured_solutions as jms
import perphil_tpu.utils.quadrature as jquad
from perphil_tpu.models.dpp import DPPParameters as JParams

import perphil_tpu_torch.forms.spaces as tspaces
import perphil_tpu_torch.mesh.structured as tmesh
import perphil_tpu_torch.ops.element as telement
import perphil_tpu_torch.ops.stencil as tstencil
import perphil_tpu_torch.solvers.options as toptions
import perphil_tpu_torch.solvers.parameters as tparams
import perphil_tpu_torch.solvers.solver as tsolver
import perphil_tpu_torch.utils.manufactured_solutions as tms
import perphil_tpu_torch.utils.quadrature as tquad
from perphil_tpu_torch.config import default_dtype, resolve_device
from perphil_tpu_torch.models.dpp import DPPParameters as TParams

REPO = Path(__file__).resolve().parents[1]

CASES = [("quad", (5, 4)), ("triangle", (4, 5)), ("hex", (3, 4, 2)), ("tet", (2, 3, 4))]
CASE_IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("element,cells", CASES, ids=CASE_IDS)
def test_mesh_arrays_equal(element, cells):
    jm = jmesh.StructuredMesh(cells=cells, element=element)
    tm = tmesh.StructuredMesh(cells=cells, element=element)
    assert tm.node_shape == jm.node_shape
    assert tm.num_cells == jm.num_cells and tm.h == jm.h and tm.hmax() == jm.hmax()
    assert np.array_equal(tm.boundary_mask(), jm.boundary_mask())
    for a, b in zip(tm.coordinates(), jm.coordinates()):
        assert np.array_equal(a, b)


def test_mesh_factories_match():
    from perphil_tpu.mesh.builtin import create_cube_mesh as jcube, create_mesh as jsq
    from perphil_tpu_torch.mesh.builtin import create_cube_mesh as tcube, create_mesh as tsq

    for args in ((3, 4), (3, 4, False)):
        assert tsq(*args).cells == jsq(*args).cells and tsq(*args).element == jsq(*args).element
    for kw in ({}, {"hexahedral": True}):
        assert tcube(2, 3, 4, **kw).element == jcube(2, 3, 4, **kw).element


@pytest.mark.parametrize("element,cells", CASES, ids=CASE_IDS)
def test_element_matrices_and_stencils_bit_equal(element, cells):
    jm = jmesh.StructuredMesh(cells=cells, element=element)
    tm = tmesh.StructuredMesh(cells=cells, element=element)
    for (tv, tK, tM), (jv, jK, jM) in zip(
        telement.cell_subcells(element, tm.h), jelement.cell_subcells(element, jm.h)
    ):
        assert np.array_equal(tv, jv) and np.array_equal(tK, jK) and np.array_equal(tM, jM)
    for ts, js in zip(tstencil.compile_stencils(tm), jstencil.compile_stencils(jm)):
        assert np.array_equal(ts, js)


@pytest.mark.parametrize("element,cells", CASES, ids=CASE_IDS)
def test_apply_stencil_matches(element, cells):
    tm = tmesh.StructuredMesh(cells=cells, element=element)
    K, M = tstencil.compile_stencils(tm)
    st = 2.0 * K + 0.5 * M
    u = np.random.default_rng(1).standard_normal(tm.node_shape)
    yt = tstencil.apply_stencil(torch.as_tensor(u), st).numpy()
    yj = np.asarray(jstencil.apply_stencil(jnp.asarray(u), st))
    assert np.abs(yt - yj).max() <= 1e-14 * np.abs(yj).max()


@pytest.mark.parametrize("element,cells", CASES, ids=CASE_IDS)
def test_quadrature_tables_equal(element, cells):
    tq = tquad.cell_quadrature(tmesh.StructuredMesh(cells=cells, element=element))
    jq = jquad.cell_quadrature(jmesh.StructuredMesh(cells=cells, element=element))
    assert len(tq) == len(jq)
    for a, b in zip(tq, jq):
        assert a.weight == b.weight and a.point == b.point
        assert a.vertex_offsets == b.vertex_offsets
        assert a.basis == b.basis and a.basis_grad == b.basis_grad


def test_parameters_fields_equal():
    for kw in ({}, {"k1": 2.0, "beta": 0.5}, {"k1": 3.0, "k2": 0.2, "mu": 2.0, "scale_contrast": 10.0}):
        t, j = TParams(**kw), JParams(**kw)
        assert (t.k1, t.k2, t.beta, t.mu, t.scale_contrast, t.eta) == (
            j.k1, j.k2, j.beta, j.mu, j.scale_contrast, j.eta
        )


@pytest.mark.parametrize("dim", [2, 3])
def test_manufactured_values_match(dim):
    cells = (5, 4) if dim == 2 else (3, 4, 2)
    element = "quad" if dim == 2 else "hex"
    tm = tmesh.StructuredMesh(cells=cells, element=element)
    jm = jmesh.StructuredMesh(cells=cells, element=element)
    p = dict(k1=1.5, beta=0.7)
    tex = (tms.exact_expressions if dim == 2 else tms.exact_expressions_3d)(tm, TParams(**p))
    jex = (jms.exact_expressions if dim == 2 else jms.exact_expressions_3d)(jm, JParams(**p))
    pts = np.random.default_rng(2).uniform(0.0, 1.0, size=(dim, 50))
    for tf, jf in zip(tex, jex):
        tv = tf(*[torch.as_tensor(c) for c in pts])
        jv = jf(*[jnp.asarray(c) for c in pts])
        for a, b in zip(tv if isinstance(tv, tuple) else (tv,), jv if isinstance(jv, tuple) else (jv,)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-14 * np.abs(b).max()


@pytest.mark.parametrize("element,cells", CASES, ids=CASE_IDS)
def test_boundary_grids_match(element, cells):
    tm = tmesh.StructuredMesh(cells=cells, element=element)
    jm = jmesh.StructuredMesh(cells=cells, element=element)
    ex_t = tms.exact_expressions if tm.dim == 2 else tms.exact_expressions_3d
    ex_j = jms.exact_expressions if jm.dim == 2 else jms.exact_expressions_3d
    _, tp1, _, _ = ex_t(tm, TParams())
    _, jp1, _, _ = ex_j(jm, JParams())
    gt = tspaces._evaluate(tp1, tm, (), "cpu")
    gj = np.asarray(jspaces._evaluate(jp1, jm, ()))
    assert gt.dtype == torch.float64 and tuple(gt.shape) == jm.node_shape
    assert np.abs(gt.numpy() - gj).max() <= 1e-15 * np.abs(gj).max()
    arr = np.random.default_rng(3).standard_normal(jm.node_shape)
    assert np.array_equal(tspaces._evaluate(arr, tm, (), "cpu").numpy(), np.asarray(jspaces._evaluate(arr, jm, ())))


def test_spaces_and_functions():
    mesh = tmesh.create_mesh(3, 2)
    U, V = tspaces.create_function_spaces(mesh, device="cpu")
    jU, jV = jspaces.create_function_spaces(jmesh.create_mesh(3, 2))
    assert (U.dim(), V.dim(), U.dof_shape, V.dof_shape) == (jU.dim(), jV.dim(), jU.dof_shape, jV.dof_shape)
    W = tspaces.mixed_space(V)
    assert W.device == torch.device("cpu") and W.dim() == jspaces.mixed_space(jV).dim()
    assert W.sub(1).index == 1 and W.sub(1).device == W.device
    f = tspaces.Function(W)
    assert f.dat.shape == (W.dim(),) and f.data[0].dtype == default_dtype()
    g = tspaces.Function(V).interpolate(lambda x, y: x + 2 * y)
    assert torch.equal(g.data, torch.as_tensor(mesh.coordinates()[0] + 2 * mesh.coordinates()[1]))
    p1, p2 = tspaces.Function(W, (g.data, 2 * g.data)).split()
    assert torch.equal(p2.data, 2 * p1.data)
    # degree p: the p-times refined DoF lattice, as in the JAX package;
    # degree 3 on triangles raises its ValueError
    _, V2 = tspaces.create_function_spaces(mesh, pressure_deg=2, device="cpu")
    _, jV2 = jspaces.create_function_spaces(jmesh.create_mesh(3, 2), pressure_deg=2)
    assert (V2.dim(), V2.dof_shape, V2.dof_mesh.cells) == (jV2.dim(), jV2.dof_shape, jV2.dof_mesh.cells) == (
        35, (5, 7), (6, 4))
    tri = tmesh.create_mesh(3, 2, quadrilateral=False)
    assert tspaces.FunctionSpace(tri, degree=2, device="cpu").dof_shape == (5, 7)
    with pytest.raises(ValueError, match="Simplex meshes support degrees 1 and 2"):
        tspaces.FunctionSpace(tri, degree=3, device="cpu")
    with pytest.raises(ValueError, match="Simplex meshes support degrees 1 and 2"):
        jspaces.FunctionSpace(jmesh.create_mesh(3, 2, quadrilateral=False), degree=3)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").index == torch.cuda.current_device()
        assert resolve_device(None) == resolve_device("cuda")
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)


def _default_device_constructors():
    """(name, constructor taking ``device``) for everything whose ``device``
    parameter defaults to the card."""
    from perphil_tpu_torch.interop import from_numpy_state
    from perphil_tpu_torch.ops import direct as tdirect
    from perphil_tpu_torch.ops import ilu as tilu
    from perphil_tpu_torch.ops.mixed import MixedPrecisionDPPDirect
    from perphil_tpu_torch.ops.simplexfem import P2SimplexDPPOperator
    from perphil_tpu_torch.ops.tensorfem import TensorDPPOperator, TensorFastDiagDPP

    mesh, p = tmesh.create_mesh(4, 3), TParams()
    zero = np.zeros(mesh.node_shape)
    return {
        "create_function_spaces": lambda **kw: tspaces.create_function_spaces(mesh, **kw)[1],
        "FunctionSpace": lambda **kw: tspaces.FunctionSpace(mesh, **kw),
        "_evaluate": lambda **kw: tspaces._evaluate(1.5, mesh, (), **kw),
        "from_numpy_state": lambda **kw: from_numpy_state({}, (4, 3), "quad", zero, zero, **kw).W,
        "StructuredILU0": lambda **kw: tilu.StructuredILU0(tilu.build_monolithic_system(mesh, p), **kw),
        "StructuredILU0.for_monolithic": lambda **kw: tilu.StructuredILU0.for_monolithic(mesh, p, **kw),
        "MixedPrecisionDPPDirect": lambda **kw: MixedPrecisionDPPDirect(mesh, p, **kw).fast32.det,
        "FastDiagFieldSolver": lambda **kw: tdirect.FastDiagFieldSolver(mesh, 1.0, 0.5, 1.0, **kw).mode_scale,
        "LumpedDPPPreconditioner": lambda **kw: tdirect.LumpedDPPPreconditioner(mesh, p, **kw).pc1.mode_scale,
        "FastDiagDPPSolver": lambda **kw: tdirect.FastDiagDPPSolver(mesh, p, **kw).det,
        "TensorDPPOperator": lambda **kw: TensorDPPOperator(mesh, p, 2, **kw)._bdry,
        "TensorFastDiagDPP": lambda **kw: TensorFastDiagDPP(mesh, p, 2, **kw)._mode_data[0],
        "P2SimplexDPPOperator": lambda **kw: P2SimplexDPPOperator(
            tmesh.create_mesh(4, 3, quadrilateral=False), p, **kw)._bdry,
    }


DEFAULT_DEVICE_NAMES = [
    "create_function_spaces", "FunctionSpace", "_evaluate", "from_numpy_state", "StructuredILU0",
    "StructuredILU0.for_monolithic", "MixedPrecisionDPPDirect", "FastDiagFieldSolver",
    "LumpedDPPPreconditioner", "FastDiagDPPSolver", "TensorDPPOperator", "TensorFastDiagDPP",
    "P2SimplexDPPOperator",
]


@pytest.mark.parametrize("name", DEFAULT_DEVICE_NAMES)
def test_default_device_is_the_card(name):
    """With no ``device`` the port runs on the card: without one it raises
    and names CUDA, with one the object lies there. Nothing falls back to
    the CPU, which is had by name."""
    make = _default_device_constructors()[name]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert make(device="cpu").device == torch.device("cpu")


def test_no_device_parameter_defaults_to_the_cpu():
    """No signature under the port names the CPU as a default."""
    import inspect
    import pkgutil

    import perphil_tpu_torch

    seen = 0
    for info in pkgutil.walk_packages(perphil_tpu_torch.__path__, "perphil_tpu_torch."):
        module = __import__(info.name, fromlist=["_"])
        for _, obj in inspect.getmembers(module, lambda o: inspect.isclass(o) or inspect.isfunction(o)):
            if getattr(obj, "__module__", None) != info.name:
                continue
            fns = [obj] if inspect.isfunction(obj) else [
                f for _, f in inspect.getmembers(obj, inspect.isfunction)
            ]
            for fn in fns:
                prm = inspect.signature(fn).parameters.get("device")
                if prm is not None and prm.default is not inspect.Parameter.empty:
                    seen += 1
                    assert prm.default is None, f"{info.name}.{fn.__qualname__}: device={prm.default!r}"
    assert seen >= len(DEFAULT_DEVICE_NAMES)


def test_presets_equal():
    names = {n for n in dir(jparams) if n.isupper()}
    assert {n for n in dir(tparams) if n.isupper()} == names
    assert "TPU_DIRECT_PARAMS" in names and len([n for n in names if n.endswith("_PARAMS")]) >= 12
    for name in sorted(names):
        assert getattr(tparams, name) == getattr(jparams, name), name


def test_option_plumbing_matches(monkeypatch):
    nested = {"ksp_type": "gmres", "fieldsplit_0": {"ksp_type": "preonly", "pc_type": "lu"}}
    assert tsolver._flatten_options(nested) == jsolver._flatten_options(nested)
    assert tsolver._freeze(nested) == jsolver._freeze(nested)
    flat = tsolver._flatten_options(nested)
    assert tsolver._sub_options(flat, "fieldsplit_0_") == jsolver._sub_options(flat, "fieldsplit_0_")
    monkeypatch.setenv("PERPHIL_TPU_OPTIONS", "dpp_ksp_rtol=1e-10 dpp_pc_type=ilu other_x=1")
    base = {"ksp_type": "preonly"}
    try:
        toptions.set_options("dpp", ksp_max_it=7)
        joptions.set_options("dpp", ksp_max_it=7)
        assert toptions.apply_prefix_overrides(base, "dpp") == joptions.apply_prefix_overrides(base, "dpp")
    finally:
        toptions.clear_options("dpp")
        joptions.clear_options("dpp")
    assert toptions.apply_prefix_overrides(base, "none") is base


def test_import_does_not_load_jax():
    code = (
        "import sys, pkgutil, importlib, perphil_tpu_torch\n"
        "for m in pkgutil.walk_packages(perphil_tpu_torch.__path__, 'perphil_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'perphil_tpu', 'pandas', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
