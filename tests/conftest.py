import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU with the CUDA toolkit; skips "
        "where torch.cuda.is_available() is false")


@pytest.fixture()
def rng():
    """Fresh deterministic generator per test.

    Function-scoped on purpose: with a session-scoped generator every
    test's data depended on which tests ran before it, so adding or
    skipping one test elsewhere reshuffled the inputs of all later ones
    (and occasionally landed float near-ties on comparison boundaries).
    """
    return np.random.default_rng(0)
