"""Plotting helpers for structured-mesh fields.

Counterpart of ``perphil_tpu/utils/plotting.py``: ``plot_scalar_field``
(pcolormesh), ``plot_vector_field`` (quiver) and ``plot_2d_mesh`` (grid
lines), each taking and returning matplotlib axes. matplotlib is imported
at the first call (:func:`_require_matplotlib`, the Agg backend unless one
is chosen), never when this module is imported: the machines that run the
port on the card have none. Field tensors go to the host with
``.cpu().numpy()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from perphil_tpu_torch.forms.spaces import Function


def _require_matplotlib():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def plot_scalar_field(
    scalar_field: Function,
    axes=None,
    title: Optional[str] = None,
    colorbar: bool = True,
    **kwargs,
):
    """Filled plot of a scalar CG1 field."""
    plt = _require_matplotlib()
    mesh = scalar_field.space.mesh
    if mesh.dim != 2:
        raise ValueError("plot_scalar_field supports 2D meshes")
    X, Y = mesh.coordinates()
    if axes is None:
        _, axes = plt.subplots()
    m = axes.pcolormesh(X, Y, _host(scalar_field.data), shading="gouraud", **kwargs)
    if colorbar:
        plt.colorbar(m, ax=axes)
    if title:
        axes.set_title(title)
    axes.set_aspect("equal")
    return axes


def plot_vector_field(
    vector_field: Function,
    axes=None,
    title: Optional[str] = None,
    stride: int = 1,
    **kwargs,
):
    """Quiver plot of a vector CG1 field."""
    plt = _require_matplotlib()
    mesh = vector_field.space.mesh
    if mesh.dim != 2:
        raise ValueError("plot_vector_field supports 2D meshes")
    X, Y = mesh.coordinates()
    data = _host(vector_field.data)
    U, V = data[..., 0], data[..., 1]
    if axes is None:
        _, axes = plt.subplots()
    s = slice(None, None, stride)
    axes.quiver(X[s, s], Y[s, s], U[s, s], V[s, s], **kwargs)
    if title:
        axes.set_title(title)
    axes.set_aspect("equal")
    return axes


def plot_2d_mesh(mesh, axes=None, title: Optional[str] = None, **kwargs):
    """Draw the mesh edges (and a simplicial mesh's splitting diagonals)."""
    plt = _require_matplotlib()
    if mesh.dim != 2:
        raise ValueError("plot_2d_mesh supports 2D meshes")
    X, Y = mesh.coordinates()
    if axes is None:
        _, axes = plt.subplots()
    kwargs.setdefault("color", "k")
    kwargs.setdefault("linewidth", 0.5)
    axes.plot(X, Y, **kwargs)
    axes.plot(X.T, Y.T, **kwargs)
    if mesh.element == "triangle":
        # the splitting diagonals: (1,0)-(0,1) for "left"
        nx1, ny1 = X.shape[1], X.shape[0]
        for j in range(ny1 - 1):
            for i in range(nx1 - 1):
                if mesh.diagonal == "left":
                    axes.plot([X[j, i + 1], X[j + 1, i]], [Y[j, i + 1], Y[j + 1, i]], **kwargs)
                else:
                    axes.plot([X[j, i], X[j + 1, i + 1]], [Y[j, i], Y[j + 1, i + 1]], **kwargs)
    if title:
        axes.set_title(title)
    axes.set_aspect("equal")
    return axes
