from kss_icp_torch.parallel.mesh import distributed_init, make_mesh
from kss_icp_torch.parallel.batch import overlap_batch, register_batch, register_many
from kss_icp_torch.parallel.rotation_shard import score_rotation_field_sharded
from kss_icp_torch.parallel.point_shard import icp_point_sharded, mean_nn_distance_sharded

__all__ = [
    "distributed_init",
    "make_mesh",
    "register_batch",
    "register_many",
    "score_rotation_field_sharded",
    "icp_point_sharded",
    "mean_nn_distance_sharded",
    "overlap_batch",
]
