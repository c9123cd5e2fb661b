"""Metric parity vs scikit-learn (the reference scores with sklearn.metrics,
ref benchmark/classification.py:110-112, benchmark/regression.py:102)."""

import numpy as np
import pytest
import sklearn.metrics

from neo_ls_svm_jax.utils.metrics import accuracy_score, r2_score, roc_auc_score


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_roc_auc_matches_sklearn(seed, weighted) -> None:
    gen = np.random.RandomState(seed)
    n = 500
    y = gen.randint(0, 2, n)
    # Quantised scores force ties, the hard case for rank-based AUC.
    score = np.round(gen.rand(n) + 0.3 * y, 2)
    w = gen.rand(n) + 0.05 if weighted else None
    ours = roc_auc_score(y, score, sample_weight=w)
    theirs = sklearn.metrics.roc_auc_score(y, score, sample_weight=w)
    assert ours == pytest.approx(theirs, abs=1e-12)


def test_roc_auc_string_labels_and_errors() -> None:
    y = np.array(["no", "yes", "yes", "no"])
    score = np.array([0.1, 0.9, 0.8, 0.4])
    assert roc_auc_score(y, score) == 1.0  # "yes" (larger label) is positive
    with pytest.raises(ValueError, match="2 classes"):
        roc_auc_score(np.array([1, 1, 1]), np.array([0.1, 0.2, 0.3]))


@pytest.mark.parametrize("weighted", [False, True])
def test_accuracy_and_r2_match_sklearn(weighted) -> None:
    gen = np.random.RandomState(3)
    w = gen.rand(200) + 0.05 if weighted else None
    y_true_c = gen.randint(0, 2, 200)
    y_pred_c = gen.randint(0, 2, 200)
    assert accuracy_score(y_true_c, y_pred_c, sample_weight=w) == pytest.approx(
        sklearn.metrics.accuracy_score(y_true_c, y_pred_c, sample_weight=w)
    )
    y_true_r = gen.randn(200)
    y_pred_r = y_true_r + 0.3 * gen.randn(200)
    assert r2_score(y_true_r, y_pred_r, sample_weight=w) == pytest.approx(
        sklearn.metrics.r2_score(y_true_r, y_pred_r, sample_weight=w)
    )


def test_r2_constant_target_matches_sklearn_convention() -> None:
    """Constant y_true: 1.0 for a perfect fit, 0.0 otherwise — never -inf/nan."""
    y = np.ones(5)
    assert r2_score(y, y) == 1.0
    assert r2_score(y, np.array([1.0, 1, 1, 1, 2])) == 0.0
    assert sklearn.metrics.r2_score(y, [1, 1, 1, 1, 2]) == r2_score(y, np.array([1.0, 1, 1, 1, 2]))


def test_sklearn_tags_derived_for_mixins() -> None:
    """CQR reports as a regressor and the affine maps as transformers (sklearn 1.6+
    tag protocol) without every class having to override __sklearn_tags__."""
    from neo_ls_svm_jax.models.cqr import CoherentLinearQuantileRegressor
    from neo_ls_svm_jax.models.isotonic import IsotonicCalibrator
    from neo_ls_svm_jax.ops.affine import AffineSeparator
    from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures

    assert CoherentLinearQuantileRegressor().__sklearn_tags__().estimator_type == "regressor"
    assert IsotonicCalibrator().__sklearn_tags__().estimator_type == "regressor"
    for transformer in (AffineSeparator(), OrthogonalRandomFourierFeatures()):
        tags = transformer.__sklearn_tags__()
        assert tags.estimator_type == "transformer"
        assert tags.transformer_tags is not None
