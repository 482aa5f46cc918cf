"""The benchmark's own tests: CPU tests at a tiny size, and tests marked ``card`` that
run the cells on a CUDA device and skip without one (decided inside a fixture)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a test: several workers times PyTorch's own thread pool would slow
    every run many times over."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
