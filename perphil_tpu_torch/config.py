"""Runtime configuration.

The JAX package switches JAX's x64 mode on at import
(``perphil_tpu/config.py``). Here the working type is float64 throughout and
there is no global switch; the device is an argument that the function
space carries. It defaults to the card: the port's entry points run on the
current CUDA device unless the caller asks for the CPU by name.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_dtype() -> torch.dtype:
    """The working dtype: float64 (the reference computes in float64)."""
    return torch.float64


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Normalise a device spec; ``None`` means the current CUDA device.

    ``None`` and ``"cuda"`` resolve to the current CUDA device's index, so
    that spaces built with either and with ``"cuda:0"`` compare (and cache)
    equal. Without a card this raises and names CUDA: nothing falls back to
    the CPU, which a caller gets by passing ``"cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: perphil_tpu_torch runs on the card by default; "
                'pass device="cpu" to run on the CPU'
            )
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
