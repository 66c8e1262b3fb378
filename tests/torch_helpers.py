"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture()
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    return torch.device("cuda", 0)
