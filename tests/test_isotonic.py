"""Isotonic calibrator parity vs sklearn's IsotonicRegression (the reference's choice)."""

import numpy as np
import pytest
from sklearn.isotonic import IsotonicRegression

from neo_ls_svm_jax.models.isotonic import IsotonicCalibrator, pool_adjacent_violators


def test_pav_basic() -> None:
    y = np.array([1.0, 3.0, 2.0, 4.0])
    w = np.ones(4)
    out = pool_adjacent_violators(y, w)
    assert np.all(np.diff(out) >= 0)
    np.testing.assert_allclose(out, [1.0, 2.5, 2.5, 4.0])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_matches_sklearn(seed, weighted) -> None:
    gen = np.random.RandomState(seed)
    x = gen.randn(500)
    # Binary targets as in predict_proba calibration, with duplicate x values.
    x = np.round(x, 1)
    y = (x + 0.5 * gen.randn(500) > 0).astype(float)
    w = gen.rand(500) + 0.1 if weighted else None
    ours = IsotonicCalibrator(y_min=0, y_max=1, increasing=True, out_of_bounds="clip")
    ours.fit(x, y, sample_weight=w)
    theirs = IsotonicRegression(out_of_bounds="clip", y_min=0, y_max=1, increasing=True)
    theirs.fit(x, y, sample_weight=w)
    x_new = np.concatenate([gen.randn(300), [-10, 10]])  # incl. out-of-range probes
    np.testing.assert_allclose(ours.transform(x_new), theirs.transform(x_new), atol=1e-12)


def test_out_of_bounds_semantics() -> None:
    """transform must honour out_of_bounds like sklearn's IsotonicRegression."""
    X = np.array([1.0, 2.0, 3.0, 4.0])
    y = np.array([0.1, 0.4, 0.3, 0.9])
    clip = IsotonicCalibrator(out_of_bounds="clip").fit(X, y)
    lo, hi = clip.transform([0.0])[0], clip.transform([9.0])[0]
    assert lo == clip.transform([1.0])[0] and hi == clip.transform([4.0])[0]
    nan = IsotonicCalibrator(out_of_bounds="nan").fit(X, y)
    out = nan.transform([0.0, 2.5, 9.0])
    assert np.isnan(out[0]) and np.isnan(out[2]) and np.isfinite(out[1])
    raise_ = IsotonicCalibrator(out_of_bounds="raise").fit(X, y)
    np.testing.assert_allclose(raise_.transform([2.5]), nan.transform([2.5]))
    with pytest.raises(ValueError, match="interpolation range"):
        raise_.transform([0.0])
    bogus = IsotonicCalibrator(out_of_bounds="bogus").fit(X, y)
    with pytest.raises(ValueError, match="out_of_bounds"):
        bogus.transform([2.0])


def test_native_pav_matches_python_fallback() -> None:
    """The C++ PAV kernel must agree exactly with the semantics-defining Python loop."""
    from neo_ls_svm_jax import native
    from neo_ls_svm_jax.models import isotonic as iso_mod

    if native.pav_fit is None:
        pytest.skip("no C++ compiler available")
    gen = np.random.RandomState(7)
    for _ in range(50):
        n = gen.randint(1, 80)
        y = np.round(gen.randn(n), 2)  # ties exercise the >= merge rule
        w = gen.uniform(0.1, 3.0, n)
        fast = native.pav_fit(y, w)
        saved = native.pav_fit
        native.pav_fit = None  # force the Python fallback
        try:
            slow = iso_mod.pool_adjacent_violators(y, w)
        finally:
            native.pav_fit = saved
        np.testing.assert_allclose(fast, slow, rtol=1e-14, atol=0)
        assert np.all(np.diff(fast) >= 0)
