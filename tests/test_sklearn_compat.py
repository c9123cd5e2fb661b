"""sklearn estimator-contract battery (mirrors ref ``tests/test_neo_ls_svm.py:111-116``).

On scikit-learn 1.9 the *reference* fails four checks (verified in this environment:
check_estimator_tags_renamed, check_n_features_in_after_fitting,
check_all_zero_sample_weights_error, check_sample_weight_equivalence_on_dense_data).
This implementation fails two, both knowingly:

* ``check_sample_weight_equivalence_on_dense_data`` — inherent to the algorithm family
  (shared with the reference): the affine separator samples edges through
  ``RandomState.choice(p=weights)``, so integer weights and literally repeated rows
  consume different RNG streams, and the discrete LOO γ-argmin amplifies the
  difference far beyond rtol 1e-7.
* ``check_regressors_no_decision_function`` — deliberate API parity: the reference
  exposes ``decision_function``/``predict_proba`` for regressors too
  (ref ``_neo_ls_svm.py:655,772``).
"""

import pytest
from sklearn.utils.estimator_checks import check_estimator

from neo_ls_svm_jax import NeoLSSVM
from neo_ls_svm_jax.models.cqr import CoherentLinearQuantileRegressor

EXPECTED_FAILURES = {
    "check_sample_weight_equivalence_on_dense_data": (
        "weight-vs-repetition equivalence cannot hold: RNG-based edge sampling and the"
        " discrete LOO gamma argmin (the reference fails this check too)"
    ),
    "check_regressors_no_decision_function": (
        "decision_function/predict_proba exist for regressors by reference API parity"
    ),
}


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_check_estimator_neo_ls_svm(kind) -> None:
    check_estimator(
        NeoLSSVM(estimator_type=kind),
        expected_failed_checks=EXPECTED_FAILURES,
    )


def test_check_estimator_cqr() -> None:
    # Mirrors ref tests/test_coherent_linear_quantile_regressor.py:8-11.
    results = check_estimator(CoherentLinearQuantileRegressor(quantiles=(0.5,)), on_fail=None)
    failed = [r for r in results if r.get("status") == "failed"]
    allowed = {
        # Same weight-vs-repetition caveat: the smoothed solve is deterministic but the
        # pinball objective has non-unique minimisers, so tiny formulation differences
        # exceed rtol 1e-7.
        "check_sample_weight_equivalence_on_dense_data",
        # predict returns one column per quantile, (n, Q) — the reference's contract
        # (ref _coherent_linear_quantile_regressor.py:241-255) — while sklearn's
        # regressor battery asserts a (n,)-shaped predict. The reference's CQR fails
        # this check identically under the sklearn ≥1.6 tag protocol.
        "check_regressors_train",
    }
    unexpected = [r["check_name"] for r in failed if r["check_name"] not in allowed]
    assert not unexpected, f"unexpected check_estimator failures: {unexpected}"


def test_metadata_routing_requests_surface() -> None:
    """The routing request surface matches what sklearn auto-generates for the
    reference (explicit non-X/y keyword args of fit/predict/score)."""
    m = NeoLSSVM()
    routing = m.get_metadata_routing()
    assert routing.fit.requests == {"sample_weight": None}
    assert routing.predict.requests == {"coverage": None, "quantiles": None}
    assert routing.score.requests == {"sample_weight": None}
    m.set_fit_request(sample_weight=True).set_score_request(sample_weight="w_alias")
    assert m.get_metadata_routing().fit.requests == {"sample_weight": True}
    assert m.get_metadata_routing().score.requests == {"sample_weight": "w_alias"}
    # Requests are configuration: clone preserves them (sklearn semantics).
    from neo_ls_svm_jax.utils.base import clone

    assert clone(m).get_metadata_routing().fit.requests == {"sample_weight": True}
    with pytest.raises(TypeError, match="routable metadata"):
        m.set_fit_request(nonexistent=True)
    with pytest.raises(ValueError, match="True/False/None"):
        m.set_fit_request(sample_weight=3.14)


def test_metadata_routing_end_to_end() -> None:
    """sample_weight routes through a sklearn meta-estimator with routing enabled,
    and unrequested metadata raises sklearn's UnsetMetadataPassedError."""
    import numpy as np
    import sklearn
    from sklearn.exceptions import UnsetMetadataPassedError
    from sklearn.model_selection import cross_validate

    rng = np.random.RandomState(0)
    X = rng.randn(300, 4).astype(np.float32)
    y = (X @ rng.randn(4) + 0.05 * rng.randn(300)).astype(np.float32)
    w = rng.rand(300).astype(np.float32)
    sklearn.set_config(enable_metadata_routing=True)
    try:
        requested = NeoLSSVM().set_fit_request(sample_weight=True).set_score_request(
            sample_weight=True
        )
        out = cross_validate(requested, X, y, cv=2, params={"sample_weight": w})
        assert np.all(np.isfinite(out["test_score"]))
        with pytest.raises(UnsetMetadataPassedError):
            cross_validate(NeoLSSVM(), X, y, cv=2, params={"sample_weight": w})
    finally:
        sklearn.set_config(enable_metadata_routing=False)


def test_public_api_surface_superset_of_reference() -> None:
    """Every public method of the reference estimator exists here (switching users
    find everything they need; see VERDICT §2 component inventory)."""
    from .reference_shim import import_reference

    ref_cls = import_reference().NeoLSSVM
    ours = set(dir(NeoLSSVM))
    missing = [
        name
        for name in dir(ref_cls)
        if not name.startswith("_") and callable(getattr(ref_cls, name)) and name not in ours
    ]
    assert not missing, f"reference API not covered: {missing}"


def test_metadata_routing_survives_sklearn_clone_in_pipeline() -> None:
    """sklearn.base.clone must preserve routing requests (__sklearn_clone__ hook):
    meta-estimators clone before fitting, so without it a requested sample_weight
    raises UnsetMetadataPassedError from inside cross_validate(Pipeline(...))."""
    import numpy as np
    import sklearn
    from sklearn.base import clone as sk_clone
    from sklearn.model_selection import cross_validate
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler

    m = NeoLSSVM().set_fit_request(sample_weight=True).set_score_request(sample_weight=True)
    assert sk_clone(m).get_metadata_routing().fit.requests == {"sample_weight": True}

    rng = np.random.RandomState(3)
    X = rng.randn(300, 4).astype(np.float64)
    y = X @ rng.randn(4) + 0.05 * rng.randn(300)
    w = rng.rand(300)
    sklearn.set_config(enable_metadata_routing=True)
    try:
        pipe = Pipeline(
            [("sc", StandardScaler().set_fit_request(sample_weight=False)), ("m", m)]
        )
        out = cross_validate(
            pipe, X, y, cv=2, params={"sample_weight": w}, error_score="raise"
        )
        assert np.all(np.isfinite(out["test_score"]))
    finally:
        sklearn.set_config(enable_metadata_routing=False)
