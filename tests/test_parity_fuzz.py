"""Randomized-regime parity fuzz: full fits vs the reference across mixed datasets.

The north-star contract (BASELINE.md): LOO residuals match the actual reference at
rtol 1e-5 in float64. Twelve seeded regimes cover random sizes straddling the
primal/dual boundary (n ∈ {1023, 1024, 1025} included), random feature scales, four
target regimes (continuous, binary, skewed, few-unique-numeric — the last exercises
the direct-code binning path), float32 inputs, non-uniform sample weights, and pandas
passthrough; every regressor seed also gates ``predict_quantiles`` parity
(ref ``_neo_ls_svm.py:146-187,443-504``).
"""

import numpy as np
import pytest

from neo_ls_svm_jax import NeoLSSVM

from .reference_shim import import_reference

import_reference()
from neo_ls_svm import NeoLSSVM as RefNeoLSSVM  # noqa: E402

# One row per seed: (n, target kind, dtype, non-uniform weights?, pandas?).
# n straddles the primal/dual boundary (DUAL_THRESHOLD=1024) three ways; every
# fourth seed runs float32 (both sides keep f32 inputs in f32, so the two
# implementations' op orders diverge at f32 resolution — gated accordingly).
_REGIMES = [
    (300, "reg", np.float64, False, False),
    (1024, "clf", np.float64, True, False),
    (1025, "skewed", np.float64, False, True),
    (1800, "discrete", np.float32, False, False),
    (1023, "reg", np.float64, True, False),
    (700, "clf", np.float32, False, True),
    (1500, "skewed", np.float64, True, False),
    (900, "discrete", np.float64, False, False),
    (1100, "reg", np.float32, False, False),
    (640, "clf", np.float64, False, False),
    (1300, "reg", np.float64, True, True),
    (1025, "discrete", np.float64, True, False),
]


@pytest.mark.parametrize("seed", range(len(_REGIMES)))
def test_randomized_regime_parity(seed) -> None:
    n, kind, dtype, weighted, as_pandas = _REGIMES[seed]
    gen = np.random.RandomState(seed)
    d = int(gen.randint(2, 16))
    X = (gen.randn(n, d) * np.exp(gen.randn(d))).astype(dtype)
    if kind == "reg":
        y = (X[:, 0] + np.sin(X[:, 1 % d]) + 0.3 * gen.randn(n)).astype(dtype)
    elif kind == "clf":
        y = np.where(X[:, 0] + 0.5 * gen.randn(n) > 0, "a", "b")
    elif kind == "skewed":
        y = np.exp(0.3 * X[:, 0] + 0.1 * gen.randn(n)).astype(dtype)
    else:
        y = np.round(X[:, 0] * 2).clip(-3, 3).astype(dtype)
    w = (gen.rand(n) + 0.25).astype(dtype) if weighted else None
    X_in, y_in = X, y
    if as_pandas:
        pd = pytest.importorskip("pandas")
        X_in = pd.DataFrame(X, columns=[f"f{i}" for i in range(d)])
        y_in = pd.Series(y, name="target")
    ours = NeoLSSVM().fit(X_in, y_in, sample_weight=w)
    theirs = RefNeoLSSVM().fit(X_in, y_in, sample_weight=w)
    assert ours.γ_ == pytest.approx(theirs.γ_, rel=1e-9)
    # North-star gate: rtol 1e-5 with atol scaled by the residual spread. float32
    # regimes run BOTH implementations' linear algebra in f32 (inputs stay f32 by
    # contract), where different-but-valid op orders diverge at ~1e-3 relative —
    # the f64 contract itself stays at 1e-5.
    rtol = 1e-5 if dtype == np.float64 else 2e-3
    # f32 atol: high-leverage rows amplify op-order noise on near-zero residuals
    # beyond their tiny |expected| (seed 3 measured max|Δ|/std = 4.3e-3); gate those
    # by spread, not by the residual's own magnitude.
    atol_mult = rtol if dtype == np.float64 else 5e-3
    scale = max(np.finfo(np.float64).tiny, float(np.std(theirs.loo_residuals_)))
    np.testing.assert_allclose(
        ours.loo_residuals_, theirs.loo_residuals_, rtol=rtol, atol=atol_mult * scale
    )
    # Serving parity per seed: conformally calibrated quantiles end-to-end.
    X_q = X[:64]
    q = (0.25, 0.75)
    ours_q = np.asarray(ours.predict_quantiles(X_q, quantiles=q))
    theirs_q = np.asarray(theirs.predict_quantiles(X_q, quantiles=q))
    spread = max(np.finfo(np.float64).tiny, float(np.ptp(theirs_q)))
    np.testing.assert_allclose(ours_q, theirs_q, rtol=rtol, atol=max(rtol, 1e-5) * spread)
