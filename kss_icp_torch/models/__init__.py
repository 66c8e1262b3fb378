from kss_icp_torch.models.coarse import CoarseResult, coarse_align, score_rotation_field
from kss_icp_torch.models.icp import ICPParams, ICPResult, icp, kabsch
from kss_icp_torch.models.kss_icp import RegistrationResult, register_pair

__all__ = [
    "CoarseResult",
    "coarse_align",
    "score_rotation_field",
    "ICPParams",
    "ICPResult",
    "icp",
    "kabsch",
    "RegistrationResult",
    "register_pair",
]
