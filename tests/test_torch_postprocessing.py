"""The port's postprocessing on the CPU: ``tests/test_postprocessing.py``
case for case against the port, and the port held to the JAX package on the
same inputs (numpy from a seed):

- ``calculate_darcy_velocity_from_pressure`` (quad, triangle, hex) against
  the JAX projection: <= 1e-10 relative (both CG solves stop at 1e-13);
- ``slice_along_x`` and ``Function.at`` (degree 1 and 2, 2D and 3D, points
  inside, on nodes and on the boundary): <= 1e-13;
- ``interpolate_exact``: the same nodal values to 1e-13;
- ``split_dpp_solution``: names and data.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perphil_tpu.forms.spaces import Function as JFunction, FunctionSpace as JFunctionSpace
from perphil_tpu.forms.spaces import create_function_spaces as jspaces_of
from perphil_tpu.mesh.structured import StructuredMesh as JMesh
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.utils import manufactured_solutions as jms
from perphil_tpu.utils import postprocessing as jpost

from perphil_tpu_torch.forms.spaces import Function, FunctionSpace, create_function_spaces, mixed_space
from perphil_tpu_torch.mesh import create_mesh
from perphil_tpu_torch.mesh.structured import StructuredMesh
from perphil_tpu_torch.models.dpp import DPPParameters
from perphil_tpu_torch.utils.manufactured_solutions import interpolate_exact
from perphil_tpu_torch.utils.postprocessing import (
    calculate_darcy_velocity_from_pressure,
    h1_seminorm_error,
    l2_error,
    slice_along_x,
    split_dpp_solution,
)

CPU = torch.device("cpu")


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _space(mesh, degree=1):
    return FunctionSpace(mesh, degree=degree, device="cpu")


# -- tests/test_postprocessing.py, case for case -------------------------------------


def test_l2_error_exact_polynomial():
    f = Function(_space(create_mesh(4, 4))).interpolate(lambda x, y: x + 2 * y)
    assert l2_error(f, lambda x, y: x + 2 * y) < 1e-13
    assert h1_seminorm_error(f, lambda x, y: x + 2 * y) < 1e-12


def test_l2_error_known_value():
    f = Function(_space(create_mesh(3, 5)))
    assert abs(l2_error(f, lambda x, y: 1.0 + 0 * x) - 1.0) < 1e-13


def test_l2_error_triangles():
    V = _space(create_mesh(4, 4, quadrilateral=False))
    f = Function(V).interpolate(lambda x, y: x * 0.0)
    assert abs(l2_error(f, lambda x, y: 1.0 + 0 * x) - 1.0) < 1e-12
    g = Function(V).interpolate(lambda x, y: x + y)
    assert l2_error(g, lambda x, y: x + y) < 1e-13


def test_h1_error_against_function():
    V = _space(create_mesh(4, 4))
    f = Function(V).interpolate(lambda x, y: x)
    g = Function(V).interpolate(lambda x, y: 2 * x)
    assert abs(h1_seminorm_error(f, g) - 1.0) < 1e-12


def test_split_dpp_solution():
    W = mixed_space(_space(create_mesh(2, 2)))
    data = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 3)))
    p1, p2 = split_dpp_solution(Function(W, (data[0], data[1])))
    assert p1.name == "p1_h" and p2.name == "p2_h"
    assert torch.equal(p1.data, data[0]) and torch.equal(p2.data, data[1])
    with pytest.raises(ValueError, match="2-field"):
        split_dpp_solution(Function(W.spaces[0]))


def test_slice_along_x():
    f = Function(_space(create_mesh(4, 4))).interpolate(lambda x, y: y)
    y_pts, vals = slice_along_x(f, 0.5)
    assert np.allclose(y_pts, np.linspace(0, 1, 5))
    assert np.allclose(vals, y_pts)


def test_darcy_velocity_projection():
    p = Function(_space(create_mesh(4, 4))).interpolate(lambda x, y: x)
    u = calculate_darcy_velocity_from_pressure(p, conductivity=2.0)
    assert u.data.shape == (5, 5, 2) and u.data.device == CPU
    assert np.allclose(u.data[..., 0].numpy(), -2.0, atol=1e-10)
    assert np.allclose(u.data[..., 1].numpy(), 0.0, atol=1e-10)


# -- the port against the JAX package on the same inputs ------------------------------

MESHES = [("quad", (6, 5)), ("triangle", (5, 5)), ("hex", (3, 4, 2))]


def _pair(element, cells, degree=1, seed=0):
    """A port Function and the JAX package's on the same random nodal data."""
    mesh, jm = StructuredMesh(cells=cells, element=element), JMesh(cells=cells, element=element)
    V, jV = _space(mesh, degree), JFunctionSpace(jm, degree=degree)
    data = np.random.default_rng(seed).standard_normal(V.dof_shape)
    return Function(V, torch.from_numpy(data)), JFunction(jV, jnp.asarray(data))


@pytest.mark.parametrize("element,cells", MESHES, ids=[m[0] for m in MESHES])
def test_velocity_projection_matches_jax(element, cells):
    f, jf = _pair(element, cells)
    u = calculate_darcy_velocity_from_pressure(f, conductivity=0.7)
    ju = jpost.calculate_darcy_velocity_from_pressure(jf, conductivity=0.7)
    assert u.data.shape == ju.data.shape and u.space.value_shape == ju.space.value_shape
    assert rel(u.data, ju.data) <= 1e-10


@pytest.mark.parametrize("element,cells,degree", [("quad", (6, 5), 1), ("quad", (3, 2), 2),
                                                  ("triangle", (4, 3), 2), ("hex", (3, 2, 2), 1),
                                                  ("hex", (2, 2, 1), 3)])
def test_function_at_matches_jax(element, cells, degree):
    f, jf = _pair(element, cells, degree, seed=1)
    d = len(cells)
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(0.0, 1.0, (20, d)), np.zeros((1, d)), np.ones((1, d)),
                          np.full((1, d), 0.5)])
    assert rel(f.at(pts), np.asarray(jf.at(jnp.asarray(pts)))) <= 1e-13
    assert abs(float(f.at(pts[0])) - float(jf.at(jnp.asarray(pts[0])))) <= 1e-13 * float(f.data.abs().max())


@pytest.mark.parametrize("degree", [1, 2])
def test_slice_along_x_matches_jax(degree):
    f, jf = _pair("quad", (8, 6), degree, seed=3)
    for x in (0.0, 0.31, 0.5, 1.0):
        y, v = slice_along_x(f, x)
        jy, jv = jpost.slice_along_x(jf, x)
        np.testing.assert_array_equal(y, jy)
        assert rel(v, jv) <= 1e-13


def test_interpolate_exact_matches_jax():
    mesh = create_mesh(5, 4)
    U, V = create_function_spaces(mesh, device="cpu")
    got = interpolate_exact(mesh, U, V, DPPParameters())
    jm = JMesh(cells=(5, 4))
    jU, jV = jspaces_of(jm)
    want = jms.interpolate_exact(jm, jU, jV, JParams())
    for g, w in zip(got, want):
        assert g.name == w.name and g.data.shape == w.data.shape and g.data.device == CPU
        assert rel(g.data, w.data) <= 1e-13
