"""Host utilities (port of kss_icp_tpu/utils)."""

from kss_icp_torch.utils.profiling import StageTimer, trace_annotation
from kss_icp_torch.utils.log import JsonlLogger, get_logger
from kss_icp_torch.utils.cache import ArrayCache, content_key

__all__ = [
    "StageTimer",
    "trace_annotation",
    "JsonlLogger",
    "get_logger",
    "ArrayCache",
    "content_key",
]
