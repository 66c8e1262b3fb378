"""Host utilities (port of kss_icp_tpu/utils)."""

from kss_icp_torch.utils.log import JsonlLogger

__all__ = ["JsonlLogger"]
