"""Device-resident prediction: jax.Array in → jax.Array out, no host round-trip.

Beyond-reference capability for accelerator serving pipelines whose features already live on
device: `decision_function`, `predict_std`, and regressor `predict` accept a
``jax.Array`` and return one, with metadata-only validation (the NaN scan is skipped —
documented — because a device reduction would cost the round-trip the path avoids).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neo_ls_svm_jax import NeoLSSVM

from .conftest import make_classification_dataset, make_regression_dataset


@pytest.mark.parametrize("n", [1600, 700])  # primal and dual routes
def test_device_prediction_matches_host(n) -> None:
    X, y = make_regression_dataset(n=n, seed=21)
    model = NeoLSSVM().fit(X, y)
    X_dev = jnp.asarray(X[:200])
    for method in ("decision_function", "predict_std", "predict"):
        host = getattr(model, method)(X[:200])
        dev = getattr(model, method)(X_dev)
        assert isinstance(dev, jax.Array), f"{method} must stay on device"
        np.testing.assert_allclose(np.asarray(dev), host, rtol=1e-10, atol=1e-12)


def test_device_classifier_predict_falls_back_to_labels() -> None:
    X, y = make_classification_dataset(n=700, seed=22)
    model = NeoLSSVM().fit(X, y)
    labels_host = model.predict(X[:100])
    labels_dev_in = model.predict(jnp.asarray(X[:100]))
    assert np.array_equal(labels_host, labels_dev_in)
    # decision_function itself stays on device for classifiers too.
    dev = model.decision_function(jnp.asarray(X[:100]))
    assert isinstance(dev, jax.Array)
    np.testing.assert_allclose(np.asarray(dev), model.decision_function(X[:100]), rtol=1e-10)


def test_device_input_validation() -> None:
    X, y = make_regression_dataset(n=1600, seed=23)
    model = NeoLSSVM().fit(X, y)
    with pytest.raises(ValueError, match="2D"):
        model.decision_function(jnp.asarray(X[0]))
    with pytest.raises(ValueError, match="features"):
        model.decision_function(jnp.asarray(X[:10, :3]))


def test_device_prediction_chunks(monkeypatch) -> None:
    import neo_ls_svm_jax.models.estimator as est_mod

    X, y = make_regression_dataset(n=1600, seed=24)
    model = NeoLSSVM().fit(X, y)
    full = model.decision_function(jnp.asarray(X[:300]))
    monkeypatch.setattr(est_mod, "PREDICT_CHUNK_ROWS", 128)
    chunked = model.decision_function(jnp.asarray(X[:300]))
    assert isinstance(chunked, jax.Array)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(full), rtol=1e-12)


def test_device_f32_input_casts_to_model_dtype() -> None:
    X, y = make_regression_dataset(n=1600, seed=25)
    model = NeoLSSVM().fit(X, y)  # f64 model (x64 test config)
    dev = model.decision_function(jnp.asarray(X[:50], dtype=jnp.float32))
    assert isinstance(dev, jax.Array)
    host = model.decision_function(X[:50])
    np.testing.assert_allclose(np.asarray(dev), host, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", [1600, 700])  # primal and dual routes
def test_device_quantiles_match_host(n) -> None:
    """Conformal quantile/interval serving stays on device and matches the host path."""
    X, y = make_regression_dataset(n=n, seed=27)
    model = NeoLSSVM().fit(X, y)
    X_dev = jnp.asarray(X[:200])
    quantiles = (0.05, 0.5, 0.95)
    host_q = model.predict_quantiles(X[:200], quantiles=quantiles)
    dev_q = model.predict_quantiles(X_dev, quantiles=quantiles)
    assert isinstance(dev_q, jax.Array), "predict_quantiles must stay on device"
    np.testing.assert_allclose(np.asarray(dev_q), host_q, rtol=1e-10, atol=1e-12)
    host_i = model.predict_interval(X[:200], coverage=0.9)
    dev_i = model.predict_interval(X_dev, coverage=0.9)
    assert isinstance(dev_i, jax.Array), "predict_interval must stay on device"
    np.testing.assert_allclose(np.asarray(dev_i), host_i, rtol=1e-10, atol=1e-12)
    # Steady-state serving reuses the staged conformal planes (no refit, no re-upload).
    key = ("conformal_dev", tuple(float(q) for q in quantiles), "accuracy")
    assert key in model._device_cache
    # predict(X, coverage=...) routes through the device path too.
    dev_p = model.predict(X_dev, coverage=0.9)
    assert isinstance(dev_p, jax.Array)
    np.testing.assert_allclose(np.asarray(dev_p), np.asarray(dev_i), rtol=1e-12)


def test_device_quantiles_classifier_proba_tensor() -> None:
    X, y = make_classification_dataset(n=1600, seed=28)
    model = NeoLSSVM().fit(X, y)
    X_dev = jnp.asarray(X[:150])
    host_q = model.predict_quantiles(X[:150], quantiles=(0.25, 0.75))
    dev_q = model.predict_quantiles(X_dev, quantiles=(0.25, 0.75))
    assert isinstance(dev_q, jax.Array)
    assert dev_q.shape == (150, 2, 2)
    np.testing.assert_allclose(np.asarray(dev_q), host_q, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [1600, 700])  # primal and dual routes
def test_device_predict_proba_matches_host(n) -> None:
    X, y = make_classification_dataset(n=n, seed=30)
    model = NeoLSSVM().fit(X, y)
    host = model.predict_proba(X[:120])
    dev = model.predict_proba(jnp.asarray(X[:120]))
    assert isinstance(dev, jax.Array), "predict_proba must stay on device"
    np.testing.assert_allclose(np.asarray(dev), host, rtol=1e-10, atol=1e-12)
    # Regressors pass through to device point predictions.
    Xr, yr = make_regression_dataset(n=n, seed=30)
    reg = NeoLSSVM().fit(Xr, yr)
    dev_reg = reg.predict_proba(jnp.asarray(Xr[:50]))
    assert isinstance(dev_reg, jax.Array)
    np.testing.assert_allclose(np.asarray(dev_reg), reg.predict_proba(Xr[:50]), rtol=1e-10)


def test_device_quantiles_coverage_priority_clamps() -> None:
    X, y = make_regression_dataset(n=1600, seed=29)
    model = NeoLSSVM().fit(X, y)
    X_dev = jnp.asarray(X[:100])
    host_i = model.predict_quantiles(
        X[:100], quantiles=(0.1, 0.9), priority="coverage"
    )
    dev_i = model.predict_quantiles(X_dev, quantiles=(0.1, 0.9), priority="coverage")
    np.testing.assert_allclose(np.asarray(dev_i), host_i, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [1600, 700])  # primal and dual routes
def test_device_prediction_after_restore(n) -> None:
    """Device-resident prediction must work on a model restored from a state dict
    (the device cache re-stages from host state on first use)."""
    X, y = make_regression_dataset(n=n, seed=26)
    model = NeoLSSVM().fit(X, y)
    restored = NeoLSSVM.from_state_dict(model.to_state_dict())
    for method in ("decision_function", "predict_std", "predict"):
        dev = getattr(restored, method)(jnp.asarray(X[:50]))
        assert isinstance(dev, jax.Array)
        np.testing.assert_allclose(
            np.asarray(dev), getattr(model, method)(X[:50]), rtol=1e-10, atol=1e-12
        )


def test_conformal_scalars_ride_the_device_cache() -> None:
    """γ and 1/c₀ must be uploaded once per fit, not once per serving chunk.

    The fused single-dispatch chunk programs only pay off if their scalar operands
    are cached like the matrix operands instead of a fresh host→device put per call
    (round-5 review finding)."""
    X, y = make_regression_dataset(n=1600, seed=27)
    model = NeoLSSVM().fit(X, y)
    model.predict_quantiles(X[:64])
    cache = model._device_cache
    assert "gamma" in cache and "inv_c0" in cache
    g1, c1 = cache["gamma"], cache["inv_c0"]
    model.predict_quantiles(X[64:128])
    # Same device handles on the second call: no re-upload happened.
    assert cache["gamma"] is g1 and cache["inv_c0"] is c1
    np.testing.assert_allclose(np.asarray(g1), model.γ_, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(c1), model._inv_c0, rtol=1e-6)
