"""Multi-process runtime: the process group, and global tensors.

Counterpart of ``perphil_tpu/parallel/distributed.py``. The reference scales
across nodes with MPI (``mpiexec -n P``); the JAX package brings up its
multi-controller runtime with ``jax.distributed.initialize``. Here every
rank is a process of one ``torch.distributed`` process group: NCCL for
ranks on the card, gloo for ranks on the CPU. Nothing picks another backend
than the device asks for, and a failed start raises.

Environment contract (as an MPI launcher exports rank and size):

  PERPHIL_COORDINATOR     host:port of rank 0 (default 127.0.0.1:12421)
  PERPHIL_NUM_PROCESSES   world size P
  PERPHIL_PROCESS_ID      this process's rank in [0, P)

PyTorch's own variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``) take precedence where set, as JAX's do in the JAX package. The JAX
package's metadata bootstrap of a TPU pod (``PERPHIL_AUTO_DISTRIBUTED``) has
no counterpart: a run with no variables is a single process.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from perphil_tpu_torch.config import DeviceLike, resolve_device

DEFAULT_COORDINATOR = "127.0.0.1:12421"


def backend_for(device: torch.device) -> str:
    """The process group backend a device takes: NCCL on the card, gloo on
    the CPU."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process group backend for {device}")


def is_initialized() -> bool:
    """True when the process group is up."""
    return dist.is_available() and dist.is_initialized()


def _coordinator() -> str:
    addr = os.environ.get("MASTER_ADDR")
    if addr:
        return f"{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    return os.environ.get("PERPHIL_COORDINATOR") or DEFAULT_COORDINATOR


def initialize_from_env(device: DeviceLike = None) -> bool:
    """Start the process group from the environment contract above, on
    ``device``'s backend (None: the card, NCCL).

    Returns True when a multi-process group was (or already is) up, False
    for an ordinary single-process run with no variables set, which starts
    nothing. Safe to call more than once. One of world size and rank set
    without the other raises: it is a broken launcher, not a single
    process.
    """
    if is_initialized():
        return dist.get_world_size() > 1
    num = os.environ.get("WORLD_SIZE") or os.environ.get("PERPHIL_NUM_PROCESSES")
    pid = os.environ.get("RANK") or os.environ.get("PERPHIL_PROCESS_ID")
    if (num is None) != (pid is None):
        raise RuntimeError(
            "Partial multi-process configuration: set BOTH "
            "PERPHIL_NUM_PROCESSES/WORLD_SIZE and PERPHIL_PROCESS_ID/RANK "
            f"(or neither) — got num_processes={num!r}, process_id={pid!r}"
        )
    if num is None:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(dev), init_method=f"tcp://{_coordinator()}", world_size=int(num), rank=int(pid)
    )
    return dist.get_world_size() > 1


def global_device_mesh(
    axis_sizes: Sequence[int],
    axis_names: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
):
    """A device mesh over every rank of the process group; the axis
    conventions of :func:`perphil_tpu_torch.parallel.sharding.device_mesh`."""
    from perphil_tpu_torch.parallel.sharding import device_mesh

    return device_mesh(axis_sizes, axis_names, device)


def make_global(x, dmesh, stacked: bool = False) -> torch.Tensor:
    """This rank's block of a host-replicated array (numpy or tensor), on
    the mesh's device: every rank holds the whole ``x`` (boundary data is
    cheap to replicate, as the reference replicates its BC lists) and cuts
    its own block."""
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    return dmesh.block(t.to(dmesh.device), stacked=stacked)


def replicate_scalar(x, dmesh) -> float:
    """A host float equal on every rank: rank 0's value, broadcast."""
    t = torch.tensor([float(x)], dtype=torch.float64, device=dmesh.device)
    if is_initialized():
        dist.broadcast(t, src=0)
    return float(t.item())
