from kss_icp_torch.ops.coarse_cuda import field_ave
from kss_icp_torch.ops.nn import masked_mean_nn_distance, masked_mean_nn_sqdist, nearest_neighbor
from kss_icp_torch.ops.nn_cuda import nn1
from kss_icp_torch.ops.resample import farthest_point_sampling
from kss_icp_torch.ops.resample_cuda import fps

__all__ = [
    "field_ave",
    "fps",
    "nn1",
    "nearest_neighbor",
    "masked_mean_nn_distance",
    "masked_mean_nn_sqdist",
    "farthest_point_sampling",
]
