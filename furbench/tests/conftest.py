"""Shared set-up of the benchmark's tests: the checkout on sys.path, and
`card`, the fixture that skips a test where no CUDA device is present."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

#: tiny versions of the cells' configurations and traffic, for the CPU
TINY = {
    "hairball.progressive": {"params": {"n_fibers": 2000, "resolution": [24, 24]}},
}
TINY_TRAFFIC = {"check_pixels": 64, "check_passes": 4, "warmup_passes": 1,
                "profile_passes": 1}


def tiny(cell: str) -> dict:
    return {**TINY[cell], "traffic": TINY_TRAFFIC}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels)")
    return torch.device("cuda")
