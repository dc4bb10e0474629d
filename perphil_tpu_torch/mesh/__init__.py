from perphil_tpu_torch.mesh.structured import (
    StructuredMesh,
    create_cube_mesh,
    create_mesh,
)

__all__ = ["StructuredMesh", "create_mesh", "create_cube_mesh"]
