"""pytest set-up of the benchmark's own tests: ``python -m pytest
codec_bench/tests`` from the root of the checkout. Tests of a run on the
card carry the ``cuda`` marker and take the ``card`` fixture, which skips
them where ``torch.cuda.is_available()`` is false."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
