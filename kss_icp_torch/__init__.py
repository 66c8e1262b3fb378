"""kss_icp_torch — KSS-ICP point-cloud registration in PyTorch, with CUDA kernels for Hopper.

The port of `kss_icp_tpu` (JAX/Pallas), which stays the reference: the same
pipeline, knobs and answers, with each Pallas kernel of the main path
replaced by a hand-written CUDA kernel (kss_icp_torch/csrc) that has a plain
PyTorch version beside it. CPU tensors run the plain versions; CUDA tensors
run the kernels. This package imports torch and never jax.
"""

import torch

from kss_icp_torch.config import KSSICPConfig
from kss_icp_torch.core.cloud import PointCloud
from kss_icp_torch.core.transforms import Similarity, apply_similarity
from kss_icp_torch.metrics import registration_measure
from kss_icp_torch.models.kss_icp import RegistrationResult, register_pair

# Exact float32 everywhere: no TF32 in any matrix product or convolution.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = [
    "KSSICPConfig",
    "PointCloud",
    "Similarity",
    "apply_similarity",
    "register_pair",
    "RegistrationResult",
    "registration_measure",
    "__version__",
]


def register_many(*args, **kwargs):
    """Batched registration of raw cloud pairs: parallel/batch.py::register_many.
    (Imported at call time, as kss_icp_tpu.register_many is.)"""
    from kss_icp_torch.parallel.batch import register_many as _impl

    return _impl(*args, **kwargs)
