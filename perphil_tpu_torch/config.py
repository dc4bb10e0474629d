"""Runtime configuration.

The JAX package switches JAX's x64 mode on at import
(``perphil_tpu/config.py``). Here the working type is float64 throughout and
there is no global switch; the device is an explicit argument that the
function space carries.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_dtype() -> torch.dtype:
    """The working dtype: float64 (the reference computes in float64)."""
    return torch.float64


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Normalise a device spec; ``None`` means the CPU.

    ``"cuda"`` resolves to the current CUDA device's index, so that spaces
    built with ``"cuda"`` and ``"cuda:0"`` compare (and cache) equal. Without
    a card this raises, as torch does: nothing falls back to the CPU.
    """
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
