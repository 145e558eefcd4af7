import os
import sys

import jax
import pytest

# make `from _compat import ...` robust regardless of pytest import mode
sys.path.insert(0, os.path.dirname(__file__))

# Tests run on the single host CPU device (the 512-device mesh is exclusively
# a dryrun.py concern — see launch/dryrun.py which sets XLA_FLAGS first).

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (an H100); skips without one"
    )
