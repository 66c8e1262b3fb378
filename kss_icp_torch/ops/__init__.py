from kss_icp_torch.ops.aivs import aivs_resample
from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot
from kss_icp_torch.ops.nn import (masked_mean_nn_distance, masked_mean_nn_sqdist, masked_quantile_threshold,
                                  nearest_neighbor)
from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_torch.ops.normals import estimate_oriented_normals
from kss_icp_torch.ops.resample import farthest_point_sampling
from kss_icp_torch.ops.resample_cuda import fps
from kss_icp_torch.ops.spatial import build_voxel_grid, estimate_box_scale

__all__ = [
    "field_ave",
    "field_dot",
    "fps",
    "nn1",
    "nearest_neighbor",
    "masked_mean_nn_distance",
    "masked_mean_nn_sqdist",
    "masked_quantile_threshold",
    "farthest_point_sampling",
    "build_voxel_grid",
    "estimate_box_scale",
    "aivs_resample",
    "estimate_oriented_normals",
]
