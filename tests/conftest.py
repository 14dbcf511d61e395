"""Shared fixtures.  Importing repro.core enables jax x64 (the simulator
needs it); model tests use explicit dtypes and are unaffected."""
import numpy as np
import pytest

import _hypothesis_stub

# Prefer the real hypothesis (requirements-dev.txt); fall back to the in-repo
# deterministic stub so the suite still collects in hermetic environments.
_hypothesis_stub.install()

import repro.core  # noqa: F401  (enables x64 before any jax compute)
from repro.core.eee import Policy, PowerModel
from repro.topology.megafly import Megafly, small_topology


@pytest.fixture(scope="session")
def topo():
    """Small Megafly: 5 groups x 16 nodes = 80 nodes, fast to simulate."""
    return small_topology()


@pytest.fixture(scope="session")
def paper_topo():
    """The exact paper scenario (host-side only — cheap to construct)."""
    return Megafly()


@pytest.fixture(scope="session")
def pm():
    return PowerModel()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skips "
        "without one")


def make_policy(**kw):
    return Policy(**kw)
