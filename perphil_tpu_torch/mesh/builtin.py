"""Import-path parity with ``perphil_tpu.mesh.builtin``."""

from perphil_tpu_torch.mesh.structured import create_cube_mesh, create_mesh

__all__ = ["create_mesh", "create_cube_mesh"]
