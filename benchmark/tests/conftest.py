"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the repository's root. Tests marked ``cuda`` need the card and skip
without one (the decision is made inside a fixture, never at import)."""
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FIXTURES = os.path.join(BENCH, "tests", "fixtures")
import torch  # noqa: E402

torch.set_num_threads(2)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs the card; skips where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def tiny_manifest():
    """BENCHMARK.json with every cell on the tiny 33^2 x 9 configuration."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)
