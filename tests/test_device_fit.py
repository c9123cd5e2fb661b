"""Device-resident fit: a ``jax.Array`` X never takes the device→host→device trip.

VERDICT r4 #2: ``fit`` used to silently pull a device X to host (``np.asarray`` in
``check_X_y``) and re-upload it — two full transfers of X for nothing. The contract
now: a ``jax.Array`` X routes to the on-device pre-transform
with metadata-only validation, zero implicit device→host transfers of X (enforced
below via ``jax.transfer_guard_device_to_host``), and score parity with the
equivalent NumPy-input fit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neo_ls_svm_jax import NeoLSSVM


def _dataset(n=2048, d=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] * 2.0 + np.sin(X[:, 1]) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def test_device_fit_no_host_roundtrip_and_parity() -> None:
    X, y = _dataset()
    X_dev = jnp.asarray(X)
    m_dev = NeoLSSVM(random_state=42)
    # Implicit device→host transfers (np.asarray on a jax.Array) are forbidden for
    # the whole fit; the fit's own pulls (fingerprint, eager materialise) are
    # explicit jax.device_get calls, which "disallow" still permits.
    with jax.transfer_guard_device_to_host("disallow"):
        m_dev.fit(X_dev, y)
    assert m_dev.pre_transform_ == "device"
    assert m_dev.transfer_ == "float32"
    # Parity with the NumPy-input device-pre-transform fit: identical program,
    # identical seed, identical data → identical model.
    m_np = NeoLSSVM(random_state=42, pre_transform="device").fit(X, y)
    np.testing.assert_allclose(m_dev.predict(X[:64]), m_np.predict(X[:64]), rtol=1e-6)
    np.testing.assert_allclose(m_dev.score(X, y), m_np.score(X, y), rtol=1e-6)
    assert m_dev.score(X, y) > 0.9


def test_device_fit_device_targets_and_classifier() -> None:
    X, y = _dataset(n=1536)
    yc = (y > np.median(y)).astype(np.int32)
    m = NeoLSSVM(random_state=7).fit(jnp.asarray(X), jnp.asarray(yc))
    assert m._estimator_type == "classifier"
    assert set(np.unique(m.predict(X))) <= {0, 1}
    assert m.score(X, yc) > 0.8
    # Device sample weights ride the same one-shot pull as y.
    w = jnp.ones(X.shape[0])
    m2 = NeoLSSVM(random_state=7).fit(jnp.asarray(X), jnp.asarray(yc), sample_weight=w)
    np.testing.assert_allclose(m2.decision_function(X[:32]), m.decision_function(X[:32]), rtol=1e-6)


def test_device_fit_explicit_host_pre_transform_pulls_and_matches_bit_parity() -> None:
    X, y = _dataset()
    m_host = NeoLSSVM(random_state=3, pre_transform="host").fit(X, y)
    m_dev_in = NeoLSSVM(random_state=3, pre_transform="host").fit(jnp.asarray(X), y)
    assert m_dev_in.pre_transform_ == "host"
    np.testing.assert_array_equal(m_dev_in.predict(X[:64]), m_host.predict(X[:64]))


def test_device_fit_dual_route_pulls() -> None:
    X, y = _dataset(n=512)
    m = NeoLSSVM(random_state=1).fit(jnp.asarray(X), y)
    assert m.dual_
    ref = NeoLSSVM(random_state=1).fit(X, y)
    np.testing.assert_array_equal(m.predict(X[:32]), ref.predict(X[:32]))


def test_device_fit_rejects_transfer_narrowing() -> None:
    X, y = _dataset()
    with pytest.raises(ValueError, match="already device-resident"):
        NeoLSSVM(transfer="int8").fit(jnp.asarray(X), y)


def test_device_fit_validation_metadata_only() -> None:
    X, y = _dataset()
    with pytest.raises(ValueError, match="Expected 2D array"):
        NeoLSSVM().fit(jnp.asarray(X[:, 0]), y)
    with pytest.raises(ValueError, match="inconsistent numbers of samples"):
        NeoLSSVM().fit(jnp.asarray(X), y[:-5])
    # y is host-resident on this path, so the finiteness gate the host path gets
    # from check_X_y must still fire (only the O(n·d) X scan is skipped by design).
    y_nan = y.copy()
    y_nan[3] = np.nan
    with pytest.raises(ValueError, match="Input y contains NaN or infinity"):
        NeoLSSVM().fit(jnp.asarray(X), y_nan)


def test_device_fit_mesh_route() -> None:
    from neo_ls_svm_jax.parallel.mesh import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs >1 device")
    X, y = _dataset(n=1537)  # deliberately not a multiple of the mesh's data axis
    mesh = make_mesh()
    m_dev = NeoLSSVM(random_state=5, mesh=mesh).fit(jnp.asarray(X), y)
    m_np = NeoLSSVM(random_state=5, mesh=mesh, pre_transform="device").fit(X, y)
    np.testing.assert_allclose(m_dev.predict(X[:64]), m_np.predict(X[:64]), rtol=1e-5)
    assert m_dev.score(X, y) > 0.9


def test_device_fit_then_device_conformal_serving() -> None:
    """The full JAX-native pipeline: device X in → device fit → device-resident
    calibrated quantiles/intervals out, with parity against the host serving path
    of the same model (the conformal level fits themselves are tiny host LPs that
    pull calibration attributes via explicit device_get — allowed by contract)."""
    X, y = _dataset(n=2048, seed=3)
    y = np.abs(y).astype(np.float32) + 10.0  # price-like positive target
    m = NeoLSSVM(random_state=11).fit(jnp.asarray(X), jnp.asarray(y))
    assert m.pre_transform_ == "device"
    X_serve = jnp.asarray(X[:128])
    q_dev = m.predict_quantiles(X_serve)
    iv_dev = m.predict_interval(X_serve, coverage=0.9)
    assert isinstance(q_dev, jax.Array) and isinstance(iv_dev, jax.Array)
    np.testing.assert_allclose(
        np.asarray(q_dev), m.predict_quantiles(X[:128]), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(iv_dev), m.predict_interval(X[:128], coverage=0.9), rtol=1e-5, atol=1e-7
    )
    assert np.all(np.diff(np.asarray(q_dev), axis=1) >= -1e-6)
