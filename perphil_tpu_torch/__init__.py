"""perphil-tpu-torch: the double porosity/permeability (DPP) FEM library on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``perphil_tpu`` (the JAX/Pallas package beside it, which stays the
reference). Modules keep the reference's layout and public names, so each
counterpart is found by its path. Every tensor lives on the device of the
function space it belongs to: the current CUDA device by default
(``create_function_spaces(mesh)``), the CPU when asked for by name
(``device="cpu"``); the working type is float64.

On a CUDA tensor each kernel wrapper launches its kernel (built from
``csrc/`` at first use) or raises; on a CPU tensor it runs the kernel's plain
PyTorch twin. Importing this package never imports JAX.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
