"""Host utilities (port of kss_icp_tpu/utils)."""

from kss_icp_torch.utils.cache import ArrayCache, content_key
from kss_icp_torch.utils.log import JsonlLogger, get_logger

__all__ = ["JsonlLogger", "get_logger", "ArrayCache", "content_key"]
