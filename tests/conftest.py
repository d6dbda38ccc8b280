import os

# tests run on ONE device (the dry-run sets its own 512-device env in a
# subprocess); keep any inherited dry-run flags out of the test process
os.environ.pop("XLA_FLAGS", None)

import numpy as np
import pytest


def pytest_configure(config):
    # `-m "not slow"` gives a quick iteration loop; tier-1 runs everything
    config.addinivalue_line(
        "markers",
        "slow: heavyweight serving/property tests (deselect with "
        "-m \"not slow\")")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA GPU (the port's hand-written kernels); skips "
        "without one")

try:        # hypothesis is optional: property tests skip when it is absent
    from hypothesis import HealthCheck, settings
except ModuleNotFoundError:
    pass
else:
    settings.register_profile(
        "repro", deadline=None,
        suppress_health_check=[HealthCheck.too_slow,
                               HealthCheck.data_too_large])
    settings.load_profile("repro")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
