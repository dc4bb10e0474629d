"""Checkpoint and restore of solution fields and study state.

Counterpart of ``perphil_tpu/utils/checkpoint.py``, with its file layout:
a compressed ``.npz`` holding each field as ``field_<i>`` (float64) and a
JSON ``__meta__`` string (the kind, the field count, the value shape of a
scalar space and the mesh: cells, element, diagonal, extent). A file written
by either package loads in the other with the arrays bit for bit. Fields go
to the file through the host (``.cpu()``); ``load_function`` puts them on
``device`` (default: the card). Result rows are JSON.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Union

import numpy as np

from perphil_tpu_torch.config import DeviceLike
from perphil_tpu_torch.forms.spaces import Function, FunctionSpace, MixedFunctionSpace
from perphil_tpu_torch.mesh.structured import StructuredMesh


def _mesh_meta(mesh: StructuredMesh) -> Dict:
    return {
        "cells": list(mesh.cells),
        "element": mesh.element,
        "diagonal": mesh.diagonal,
        "extent": list(mesh.extent),
    }


def _npz_path(path: Union[str, Path]) -> Path:
    """np.savez appends '.npz' to bare names; normalise so save and load agree."""
    p = Path(path)
    return p if p.suffix == ".npz" else p.with_suffix(p.suffix + ".npz")


def save_function(path: Union[str, Path], f: Function) -> None:
    """Save a (possibly mixed-space) Function with its mesh metadata."""
    path = _npz_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    space = f.space
    if isinstance(space, MixedFunctionSpace):
        arrays = {f"field_{i}": d.detach().cpu().numpy() for i, d in enumerate(f.data)}
        meta = {"kind": "mixed", "nfields": len(f.data), "mesh": _mesh_meta(space.mesh)}
    else:
        arrays = {"field_0": f.data.detach().cpu().numpy()}
        meta = {
            "kind": "scalar",
            "nfields": 1,
            "value_shape": list(space.value_shape),
            "mesh": _mesh_meta(space.mesh),
        }
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_function(path: Union[str, Path], device: DeviceLike = None) -> Function:
    """Load a Function on ``device``; rebuilds its mesh and space from the
    metadata."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        mesh = StructuredMesh(
            cells=tuple(meta["mesh"]["cells"]),
            element=meta["mesh"]["element"],
            diagonal=meta["mesh"]["diagonal"],
            extent=tuple(meta["mesh"]["extent"]),
        )
        if meta["kind"] == "mixed":
            V = FunctionSpace(mesh, device=device)
            W = MixedFunctionSpace(spaces=(V,) * meta["nfields"])
            return Function(W, tuple(data[f"field_{i}"] for i in range(meta["nfields"])))
        V = FunctionSpace(mesh, value_shape=tuple(meta.get("value_shape", [])), device=device)
        return Function(V, data["field_0"])


def save_rows(path: Union[str, Path], rows: List[Dict]) -> None:
    """Persist experiment rows (restart-safe sweep state)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rows, indent=1, default=str))


def load_rows(path: Union[str, Path]) -> List[Dict]:
    p = Path(path)
    if not p.exists():
        return []
    return json.loads(p.read_text())
