"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so multi-chip sharding paths compile
and execute without an accelerator, and with x64 enabled so numerical-parity tests
against the float64 oracles are meaningful.

The on-card tests (marker ``gpu``, ``tests/test_gpu.py``) are run by ``chip_smoke.py``
inside its own process, which already holds the GPU; it sets
``NEO_LS_SVM_GPU_TESTS=1`` so this file leaves the backend and x64 alone.
"""

import os

ON_CARD = os.environ.get("NEO_LS_SVM_GPU_TESTS") == "1"

if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # The suite hard-requires exactly 8 virtual devices: strip any pre-existing
    # xla_force_host_platform_device_count (whatever its value) and set our own.
    _flags = [
        f
        for f in os.environ.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    os.environ["XLA_FLAGS"] = " ".join([*_flags, "--xla_force_host_platform_device_count=8"])

import jax

if not ON_CARD:
    # A pytest plugin may import jax before this conftest runs, snapshotting
    # JAX_PLATFORMS — override via the config flag, not the env var.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng() -> np.random.RandomState:
    # Function-scoped on purpose: a shared mutable RandomState would make each test's
    # data depend on which tests ran before it, so failures in a full run could not
    # be reproduced by running the single test.
    return np.random.RandomState(0)


def make_regression_dataset(
    n: int = 2000, d: int = 8, noise: float = 0.1, seed: int = 0, dtype=np.float64
):
    """Synthetic nonlinear regression problem (offline stand-in for ames_housing)."""
    gen = np.random.RandomState(seed)
    X = gen.randn(n, d)
    y = (
        np.sin(X[:, 0])
        + 0.5 * X[:, 1] * X[:, 2]
        + 0.25 * np.abs(X[:, 3])
        + 0.1 * X[:, 4]
        + noise * gen.randn(n)
    )
    return X.astype(dtype), y.astype(dtype)


def make_classification_dataset(n: int = 2000, d: int = 8, seed: int = 0, dtype=np.float64):
    """Synthetic binary classification problem (offline stand-in for churn)."""
    gen = np.random.RandomState(seed)
    X = gen.randn(n, d)
    logits = np.sin(X[:, 0]) + X[:, 1] * X[:, 2] - 0.5 * X[:, 3] + 0.5 * gen.randn(n)
    y = np.where(logits > 0, "pos", "neg").astype(object)
    return X.astype(dtype), np.asarray(y)


@pytest.fixture(scope="session")
def regression_dataset():
    return make_regression_dataset()

@pytest.fixture(scope="session")
def classification_dataset():
    return make_classification_dataset()
