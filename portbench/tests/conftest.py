import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, in a
    fixture, never while a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
