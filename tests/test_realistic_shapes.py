"""Full-pipeline parity on dataset shapes mirroring the reference's benchmark regimes.

The reference's headline numbers come from churn (one-hot-dummied categoricals,
imbalanced binary target) and ames_housing (wide mixed features, skewed positive
price target) (ref README.md:34-48). OpenML is unreachable offline, so these
generators reproduce the *structural* regimes — many binary columns, rare categories,
heavy-tailed targets — which exercise different quantizer/separator code paths
(binary features bin by unique codes; skewed targets stress the ECDF knots).
"""

import numpy as np
import pytest

from neo_ls_svm_jax import NeoLSSVM

from .reference_shim import import_reference

import_reference()
from neo_ls_svm import NeoLSSVM as RefNeoLSSVM  # noqa: E402


def make_churn_like(n: int = 2500, seed: int = 91):
    """Imbalanced binary task over one-hot dummies + a few numeric columns."""
    gen = np.random.RandomState(seed)
    numeric = np.column_stack(
        [
            np.exp(gen.randn(n) * 0.6 + 3.5),  # monthly charges-ish
            gen.randint(0, 72, n).astype(float),  # tenure months
            np.round(gen.rand(n) * 10, 1),  # support calls
        ]
    )
    cats = [gen.randint(0, k, n) for k in (3, 4, 2, 5)]
    dummies = np.column_stack(
        [np.eye(k)[c] for c, k in zip(cats, (3, 4, 2, 5))]
    )
    X = np.hstack([numeric, dummies])
    logits = (
        0.9 * (numeric[:, 1] < 12)
        + 0.5 * np.log(numeric[:, 0] / 40)
        + 0.8 * (cats[0] == 1)
        - 1.1
        + 0.8 * gen.randn(n)
    )
    y = np.where(logits > 0, "yes", "no")
    return X, y


def make_ames_like(n: int = 2500, seed: int = 92):
    """Wide mixed features with a skewed positive price target."""
    gen = np.random.RandomState(seed)
    area = np.exp(gen.randn(n) * 0.4 + 7)
    quality = gen.randint(1, 11, n).astype(float)
    year = gen.randint(1900, 2010, n).astype(float)
    cats = [gen.randint(0, k, n) for k in (5, 3, 4)]
    dummies = np.column_stack([np.eye(k)[c] for c, k in zip(cats, (5, 3, 4))])
    X = np.hstack([area[:, None], quality[:, None], year[:, None], dummies])
    y = (
        area * (25 + 4 * quality)
        + 120 * (year - 1900)
        + 6000 * (cats[0] == 2)
        + 4000 * gen.randn(n)
    )
    return X, y


@pytest.mark.parametrize("maker", [make_churn_like, make_ames_like])
def test_realistic_shape_parity(maker) -> None:
    X, y = maker()
    split = int(0.85 * len(y))
    ours = NeoLSSVM().fit(X[:split], y[:split])
    theirs = RefNeoLSSVM().fit(X[:split], y[:split])
    assert ours.γ_ == pytest.approx(theirs.γ_, rel=1e-10)
    np.testing.assert_allclose(ours.loo_residuals_, theirs.loo_residuals_, rtol=1e-5, atol=1e-7)
    ours_score = ours.score(X[split:], y[split:])
    theirs_score = theirs.score(X[split:], y[split:])
    assert ours_score == pytest.approx(theirs_score, abs=1e-6)
    if ours._estimator_type == "classifier":
        np.testing.assert_allclose(
            np.asarray(ours.predict_proba(X[split:])),
            np.asarray(theirs.predict_proba(X[split:])),
            atol=1e-6,
        )
        assert ours_score > 0.7
    else:
        assert ours_score > 0.7


@pytest.mark.parametrize(
    ("maker", "n"), [(make_churn_like, 10000), (make_ames_like, 12000)]
)
def test_dataset_scale_parity(maker, n) -> None:
    """Full-pipeline parity beyond the reference benchmark's dataset scale (churn is
    7,043 rows, ames 2,930 — ref README.md:146-198), where the quantizer sees dense
    ECDFs and the separator sees large bins. 10-12k rows keeps a comfortable margin
    over the real datasets at half the reference-fit wall of the old 20-25k sizes
    (suite-wall budget, VERDICT r4 #7)."""
    X, y = maker(n=n, seed=95)
    split = int(0.85 * len(y))
    ours = NeoLSSVM().fit(X[:split], y[:split])
    theirs = RefNeoLSSVM().fit(X[:split], y[:split])
    assert ours.γ_ == pytest.approx(theirs.γ_, rel=1e-10)
    np.testing.assert_allclose(ours.loo_residuals_, theirs.loo_residuals_, rtol=1e-5, atol=1e-7)
    assert ours.score(X[split:], y[split:]) == pytest.approx(
        theirs.score(X[split:], y[split:]), abs=1e-6
    )


def test_ames_like_interval_coverage() -> None:
    X, y = make_ames_like(n=5000)
    split = int(0.85 * len(y))
    model = NeoLSSVM().fit(X[:split], y[:split])
    interval = model.predict_interval(X[split:], coverage=0.95)
    empirical = np.mean((interval[:, 0] <= y[split:]) & (y[split:] <= interval[:, 1]))
    assert empirical >= 0.97 * 0.95
