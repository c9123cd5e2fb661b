"""Tests that need an NVIDIA GPU (marker ``gpu``).

They check what only the card can show: float32 products run there at the precision
the code asks for (the default precision rounds to TF32), and the device lanes agree
with the host lanes. Whether a card is present is decided inside the fixture, so every
test is collected everywhere and skips on the CPU. ``python chip_smoke.py`` runs them
on the card, in its own process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neo_ls_svm_jax import NeoLSSVM
from neo_ls_svm_jax.models.primal import gamma_grid, primal_fit
from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures

from .conftest import make_regression_dataset

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu() -> jax.Device:
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; the default device is {device.platform!r}")
    return device


def _reg(n: int, seed: int):
    X, y = make_regression_dataset(n=n, d=32, seed=seed, dtype=np.float32)
    return X, y


def test_primal_fit_matches_float64_oracle(gpu) -> None:
    """float32 primal fit at HIGHEST precision against the complex float64 oracle."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark import oracle

    X, y = _reg(8192, seed=81)
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    fmap = OrthogonalRandomFourierFeatures().fit(X64, y64, np.ones_like(y64))
    M_map, b_map = fmap.linear_map()
    ours = primal_fit(
        *(jnp.asarray(np.asarray(a, np.float32))
          for a in (X, M_map, b_map, y, np.ones_like(y), gamma_grid(np.float32))),
        is_classifier=False,
    )
    ref = oracle.numpy_reference_fit(fmap.transform(X64), y64, gamma_grid(np.float64))
    assert abs(int(ours["optimum_index"]) - ref["optimum_index"]) <= 1
    assert float(ours["loo_error"]) == pytest.approx(ref["loo_error"], rel=1e-3)


def test_device_pretransform_matches_host_pretransform(gpu) -> None:
    """The on-device pre-transform (its products pinned to full float32) fits as well
    as the host pre-transform on the same data."""
    X, y = _reg(65536, seed=82)
    host = NeoLSSVM(pre_transform="host").fit(X, y)
    device = NeoLSSVM(pre_transform="device").fit(X, y)
    assert device.pre_transform_ == "device"
    assert float(device.loo_score_) == pytest.approx(float(host.loo_score_), abs=2e-2)


@pytest.mark.parametrize("conformal_method", ["exact", "smooth"])
def test_conformal_device_lane_matches_host_lane(gpu, conformal_method) -> None:
    """The device conformal combine returns the host lane's quantiles."""
    X, y = _reg(16384, seed=83)
    model = NeoLSSVM(conformal_method=conformal_method).fit(X, y)
    q_host = np.asarray(model.predict_quantiles(X[:4096], quantiles=(0.1, 0.5, 0.9)))
    q_dev = model.predict_quantiles(jax.device_put(X[:4096]), quantiles=(0.1, 0.5, 0.9))
    assert isinstance(q_dev, jax.Array)
    np.testing.assert_allclose(np.asarray(q_dev), q_host, rtol=0, atol=1e-4 * np.std(y))
