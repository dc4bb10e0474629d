"""Roofline characterisation of measured kernels.

Counterpart of ``perphil_tpu/utils/roofline.py``: locates a measured
kernel on the card's roofline, its achieved FLOP/s and bytes/s against the
card's peak compute and memory bandwidth.

The caller gives the kernel's analytic operation and byte counts (each
input read once, each output written once, from the call's shapes).
The JAX package's ``cost_of`` / ``analyze_compiled``, which read XLA's cost
analysis of a compiled computation, have no counterpart: PyTorch exposes no
compiled program to ask, and the hand-written kernels' work is what their
shapes say.

Peaks are per card, keyed by ``torch.cuda.get_device_name``: NVIDIA's H100
SXM data sheet (dense rates, at the full 700 W power limit), float64 and
float32 outside the tensor cores beside the tensor cores' rates. An unknown
card raises: no figure is assumed for it.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Tuple

import torch

#: per card name (a substring of ``torch.cuda.get_device_name``): the peak
#: FLOP/s of each arithmetic (f64 / f32: outside the tensor cores; the
#: ``*_tc`` keys: the tensor cores) and the HBM bandwidth in bytes/s
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 80GB HBM3": {
        "f64": 34e12,
        "f32": 67e12,
        "f64_tc": 67e12,
        "tf32_tc": 495e12,
        "bf16_tc": 989e12,
        "f16_tc": 989e12,
        "fp8_tc": 1979e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(name: Optional[str] = None) -> Tuple[Dict[str, float], str]:
    """``(peaks, key)`` of the card ``name`` (default: the current CUDA
    device's name); raises for a card with no entry in :data:`PEAKS`."""
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the roofline's peaks are the card's")
        name = torch.cuda.get_device_name(torch.cuda.current_device())
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks, key
    raise ValueError(f"no published peaks for {name!r}: add its data sheet's rates to PEAKS")


@dataclass
class RooflinePoint:
    """One kernel located on the roofline."""

    name: str
    seconds: float
    flops: float
    bytes: float
    gflops: float  # achieved
    gbs: float  # achieved
    intensity: float  # flops/byte
    peak_frac: float  # achieved / the arithmetic's peak compute
    hbm_frac: float  # achieved / peak HBM bandwidth
    bound: str  # "compute" or "memory" at this intensity
    bound_seconds: float  # the larger of flops / peak and bytes / bandwidth
    arithmetic: str  # the key of PEAKS' rates the flops are held to
    device: str

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)


def analyze(
    name: str,
    seconds: float,
    flops: float,
    bytes_accessed: float,
    arithmetic: str = "f64",
    device: Optional[str] = None,
) -> RooflinePoint:
    """Locate a measured kernel execution (``seconds``) doing ``flops``
    operations of type ``arithmetic`` on ``bytes_accessed`` bytes on the
    roofline of ``device`` (a card name; default the current card)."""
    peaks, key = device_peaks(device)
    peak = peaks[arithmetic]
    bw = peaks["hbm_bytes_per_s"]
    achieved = flops / seconds
    rate = bytes_accessed / seconds
    intensity = flops / max(bytes_accessed, 1.0)
    return RooflinePoint(
        name=name,
        seconds=seconds,
        flops=flops,
        bytes=bytes_accessed,
        gflops=achieved / 1e9,
        gbs=rate / 1e9,
        intensity=intensity,
        peak_frac=achieved / peak,
        hbm_frac=rate / bw,
        bound="compute" if intensity >= peak / bw else "memory",
        bound_seconds=max(flops / peak, bytes_accessed / bw),
        arithmetic=arithmetic,
        device=key,
    )
