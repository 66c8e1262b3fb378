"""Point-cloud file I/O (port of kss_icp_tpu/io)."""

from kss_icp_torch.io.formats import (
    load_normals,
    load_obj,
    load_off,
    load_ply,
    load_points,
    load_xyz,
    save_xyz,
)

__all__ = [
    "load_points",
    "load_ply",
    "load_off",
    "load_obj",
    "load_xyz",
    "load_normals",
    "save_xyz",
]
