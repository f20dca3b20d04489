"""The benchmark's tests: the repo's root on the path, and the `card`
fixture, which decides inside the test whether a CUDA device is there
(tests that need one carry the `cuda` marker and skip without it)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
