"""An autouse fixture for the port's tests: each test runs under a fresh
model-health monitor of the port (``veles_torch/model_health.py``), as
``tests/conftest.py`` gives every test a fresh monitor of the JAX
package. The loss EWMA and the verdict one test's training run leaves
would otherwise stamp another test's checkpoints. A test module takes
the fixture by importing it."""

import pytest

from veles_torch import model_health


@pytest.fixture(autouse=True)
def port_model_health_isolation():
    with model_health.scoped():
        yield
