from kss_icp_torch.core.cloud import PointCloud
from kss_icp_torch.core.transforms import (
    Similarity,
    apply_similarity,
    compose,
    euler_xyz_matrix,
    rot_x,
    rot_y,
    rot_z,
)
from kss_icp_torch.core.preshape import masked_centroid, masked_mean_radius, middle_align

__all__ = [
    "PointCloud",
    "Similarity",
    "apply_similarity",
    "compose",
    "euler_xyz_matrix",
    "rot_x",
    "rot_y",
    "rot_z",
    "masked_centroid",
    "masked_mean_radius",
    "middle_align",
]
