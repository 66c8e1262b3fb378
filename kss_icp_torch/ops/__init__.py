from kss_icp_torch.ops.aivs import aivs_resample
from kss_icp_torch.ops.coarse_cuda import field_ave, field_dot
from kss_icp_torch.ops.nn import (knn, masked_mean_nn_distance, masked_mean_nn_sqdist, masked_quantile_threshold,
                                  nearest_neighbor, pairwise_sqdist)
from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_torch.ops.normals import estimate_oriented_normals
from kss_icp_torch.ops.resample import farthest_point_sampling, fps_points, voxel_downsample
from kss_icp_torch.ops.resample_cuda import fps
from kss_icp_torch.ops.simplify import grid_simplify, hierarchy_simplify, octree_simplify
from kss_icp_torch.ops.spatial import build_voxel_grid, estimate_box_scale, estimate_radius
from kss_icp_torch.ops.wlop import wlop_resample

__all__ = [
    "field_ave",
    "field_dot",
    "fps",
    "nn1",
    "knn",
    "pairwise_sqdist",
    "nearest_neighbor",
    "masked_mean_nn_distance",
    "masked_mean_nn_sqdist",
    "masked_quantile_threshold",
    "farthest_point_sampling",
    "fps_points",
    "voxel_downsample",
    "grid_simplify",
    "hierarchy_simplify",
    "octree_simplify",
    "build_voxel_grid",
    "estimate_box_scale",
    "estimate_radius",
    "wlop_resample",
    "aivs_resample",
    "estimate_oriented_normals",
]
