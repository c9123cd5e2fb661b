"""Tests for the coherent linear quantile regressor vs the reference's HiGHS LP."""

import numpy as np
import pytest

from neo_ls_svm_jax.models.cqr import (
    CoherentLinearQuantileRegressor,
    coherent_linear_quantile_regression,
)

from .reference_shim import import_reference

import_reference()
from neo_ls_svm._coherent_linear_quantile_regressor import (  # noqa: E402
    CoherentLinearQuantileRegressor as RefCQR,
)


def _make_cqr_problem(n: int = 1200, seed: int = 0):
    # Mimics the conformal usage: features = [nonconformity, |ŷ|], target = residuals.
    gen = np.random.RandomState(seed)
    std = 0.5 + gen.rand(n)
    yhat_abs = np.abs(gen.randn(n) * 2)
    resid = std * gen.randn(n) + 0.05 * yhat_abs * gen.randn(n)
    X = np.column_stack([std, yhat_abs])
    return X, resid


def _pinball(y, pred, quantiles):
    loss = 0.0
    for j, q in enumerate(quantiles):
        r = y - pred[:, j]
        loss += np.mean(np.maximum(q * r, (q - 1) * r))
    return loss / len(quantiles)


@pytest.mark.parametrize("quantiles", [(0.025, 0.5, 0.975), (0.1, 0.9)])
def test_cqr_exact_matches_lp_optimum(quantiles) -> None:
    # The default (auto → exact-LP) path must hit the reference LP optimum.
    X, y = _make_cqr_problem()
    quantiles = np.asarray(quantiles)
    ours = CoherentLinearQuantileRegressor(quantiles=quantiles).fit(X, y)
    theirs = RefCQR(quantiles=quantiles).fit(X, y)
    pred_ours = ours.predict(X)
    pred_ref = theirs.predict(X)
    loss_ours = _pinball(y, pred_ours, quantiles)
    loss_ref = _pinball(y, pred_ref, quantiles)
    assert loss_ours <= loss_ref * 1.001
    # The two formulations reach the same vertex: predictions agree elementwise.
    scale = np.std(y)
    assert np.max(np.abs(pred_ours - pred_ref)) < 1e-6 * scale


def test_cqr_smooth_close_to_lp_optimum() -> None:
    # The jitted Newton (device/scale) path must stay within 0.5% of the LP optimum.
    # (Measured: the residual gap is ~0.3% and is entirely the *box* monotonicity
    # constraint — a strictly stronger guarantee the LP does not enforce; with
    # train-row-only monotonicity the solver reaches the LP optimum to ~0.001%.)
    quantiles = np.asarray((0.05, 0.25, 0.5, 0.75, 0.95))
    X, y = _make_cqr_problem()
    ours = CoherentLinearQuantileRegressor(quantiles=quantiles, method="smooth").fit(X, y)
    theirs = RefCQR(quantiles=quantiles).fit(X, y)
    pred_ours = ours.predict(X)
    pred_ref = theirs.predict(X)
    loss_ours = _pinball(y, pred_ours, quantiles)
    loss_ref = _pinball(y, pred_ref, quantiles)
    assert loss_ours <= loss_ref * 1.005
    scale = np.std(y)
    assert np.median(np.abs(pred_ours - pred_ref)) < 0.06 * scale
    # Convergence diagnostics: the continuation reports its stages and pinball trace.
    diag = ours.solver_diagnostics_
    assert diag["solver"] == "smooth_newton"
    assert diag["stages"] >= 4
    assert diag["pinball"] == pytest.approx(min(diag["pinball_trace"]))
    assert np.all(np.diff(diag["pinball_trace"]) <= 0)  # monotone improvement


def test_cqr_monotone_on_training_data() -> None:
    X, y = _make_cqr_problem(seed=3)
    quantiles = np.asarray((0.025, 0.1, 0.5, 0.9, 0.975))
    model = CoherentLinearQuantileRegressor(quantiles=quantiles).fit(X, y)
    pred = model.predict(X)
    assert np.all(np.diff(pred, axis=1) >= -1e-9)
    # The full (auxiliary-augmented) coefficient path must be monotone too.
    Xi = np.hstack([X, np.ones((len(X), 1))])
    pred_full = Xi @ model.β_full_
    assert np.all(np.diff(pred_full, axis=1) >= -1e-9)


def test_cqr_weighted_and_single_quantile() -> None:
    X, y = _make_cqr_problem(seed=4)
    w = np.random.RandomState(5).rand(len(y)) + 0.1
    model = CoherentLinearQuantileRegressor(quantiles=(0.5,)).fit(X, y, sample_weight=w)
    pred = model.predict(X)
    assert pred.shape == (len(y),)
    # Weighted median regression: roughly half the weighted mass below the fit.
    frac_below = np.sum(w * (y < pred)) / np.sum(w)
    assert 0.45 < frac_below < 0.55


def test_cqr_intercept_clip_matches_reference_semantics() -> None:
    X, y = _make_cqr_problem(seed=6)
    quantiles = np.asarray((0.1, 0.5, 0.9))
    ours = CoherentLinearQuantileRegressor(quantiles=quantiles).fit(X, y)
    clip = ours.intercept_clip(X, y)
    assert clip.shape == (2, len(quantiles))
    assert clip[0, 0] == -np.inf and clip[1, -1] == np.inf
    # Lower bounds never exceed upper bounds, and interior bounds straddle zero-ish
    # ranges consistent with coherence.
    assert np.all(clip[0] <= clip[1])
    # Same computation applied to the reference's coefficients gives the same matrix:
    # both solvers hit the LP optimum on this problem, so the clips agree numerically
    # (not just in shape). Tolerance covers HiGHS interior-point vs simplex wobble.
    theirs = RefCQR(quantiles=quantiles).fit(X, y)
    ref_clip = theirs.intercept_clip(X, y)
    assert ref_clip.shape == clip.shape
    finite = np.isfinite(ref_clip)
    assert np.array_equal(finite, np.isfinite(clip))
    scale = np.std(y)
    np.testing.assert_allclose(
        clip[finite], ref_clip[finite], rtol=1e-4, atol=1e-6 * scale
    )


def test_cqr_empirical_coverage() -> None:
    X, y = _make_cqr_problem(n=2000, seed=7)
    quantiles = np.asarray((0.05, 0.95))
    model = CoherentLinearQuantileRegressor(quantiles=quantiles).fit(X[:1500], y[:1500])
    pred = model.predict(X[1500:])
    y_test = y[1500:]
    coverage = np.mean((y_test >= pred[:, 0]) & (y_test <= pred[:, 1]))
    assert coverage >= 0.85


def test_batched_smooth_matches_sequential() -> None:
    """The vmapped multi-target smooth solve equals T independent smooth fits."""
    from neo_ls_svm_jax.models.cqr import (
        coherent_linear_quantile_regression,
        coherent_linear_quantile_regression_batched,
    )

    X, y1 = _make_cqr_problem(n=600, seed=8)
    _, y2 = _make_cqr_problem(n=600, seed=9)
    quantiles = np.asarray((0.1, 0.5, 0.9))
    Xi = np.hstack([X, np.ones((len(X), 1))])
    betas, betas_full = coherent_linear_quantile_regression_batched(
        Xi, np.stack([y1, y2]), quantiles=quantiles
    )
    assert betas.shape == (2, Xi.shape[1], 3)
    for t, y in enumerate((y1, y2)):
        beta_t, beta_full_t = coherent_linear_quantile_regression(
            Xi, y, quantiles=quantiles, method="smooth"
        )
        # vmap changes reduction order inside the Newton stages → ~1e-12 noise.
        np.testing.assert_allclose(betas[t], beta_t, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(betas_full[t], beta_full_t, rtol=1e-7, atol=1e-9)


def test_smooth_tolerates_zero_columns() -> None:
    """An all-zero feature column must not be mistaken for the intercept (that would
    divide by X[0, col] == 0 and destroy the whole fit with NaNs)."""
    gen = np.random.RandomState(3)
    n = 400
    X = np.hstack(
        [
            np.zeros((n, 1)),
            gen.randn(n, 2),
            np.ones((n, 1)),
        ]
    )
    y = 2.0 + X[:, 1] - 0.5 * X[:, 2] + 0.3 * gen.randn(n)
    quantiles = np.array([0.1, 0.5, 0.9])
    beta_s, _ = coherent_linear_quantile_regression(X, y, quantiles=quantiles, method="smooth")
    assert np.all(np.isfinite(beta_s))
    beta_e, _ = coherent_linear_quantile_regression(X, y, quantiles=quantiles, method="exact")
    pin_s = _pinball(y, X @ beta_s, quantiles)
    pin_e = _pinball(y, X @ beta_e, quantiles)
    assert pin_s <= pin_e * 1.005


def test_smooth_without_intercept_matches_objective() -> None:
    """With no constant column there is nowhere to fold the y centering back — the
    smooth path must solve the same (uncentered) objective the exact LP solves."""
    gen = np.random.RandomState(4)
    n = 300
    X = gen.randn(n, 2)
    y = 100.0 + X[:, 0] + 0.2 * gen.randn(n)  # large offset, NO intercept column
    quantiles = np.array([0.5])
    beta_s, _ = coherent_linear_quantile_regression(X, y, quantiles=quantiles, method="smooth")
    beta_e, _ = coherent_linear_quantile_regression(X, y, quantiles=quantiles, method="exact")
    pin_s = _pinball(y, X @ beta_s, quantiles)
    pin_e = _pinball(y, X @ beta_e, quantiles)
    assert np.all(np.isfinite(beta_s))
    assert pin_s <= pin_e * 1.005


def test_exact_lp_decomposition_matches_coupled_lp() -> None:
    """The monotone block decomposition must reach the one-shot coupled LP's optimum.

    On conformal-shaped designs the per-quantile optima are already monotone, so the
    decomposed path returns without any block merge; its concatenated solution attains
    the coupled LP's relaxation lower bound and is therefore a global optimum too.
    """
    import neo_ls_svm_jax.models.cqr as cqr_mod

    X, y = _make_cqr_problem(n=800, seed=7)
    quantiles = np.asarray((0.025, 0.1, 0.5, 0.9, 0.975))
    diag_fast: dict = {}
    beta_fast, beta_full_fast = coherent_linear_quantile_regression(
        X, y, quantiles=quantiles, method="exact", diagnostics=diag_fast
    )
    try:
        cqr_mod._LP_DECOMPOSITION = False
        beta_ref, beta_full_ref = coherent_linear_quantile_regression(
            X, y, quantiles=quantiles, method="exact"
        )
    finally:
        cqr_mod._LP_DECOMPOSITION = True
    pin_fast = _pinball(y, X @ beta_full_fast, np.linspace(0.01, 0.99, beta_full_fast.shape[1]))
    pin_ref = _pinball(y, X @ beta_full_ref, np.linspace(0.01, 0.99, beta_full_ref.shape[1]))
    # Identical optimum (the pinball quantile grid above is only a shared yardstick).
    assert pin_fast <= pin_ref * (1 + 1e-9)
    scale = np.std(y)
    assert np.max(np.abs(X @ (beta_fast - beta_ref))) < 1e-6 * scale
    # The decomposition reports its final partition; merges are rare on conformal
    # designs but legal — correctness never depends on the hit rate.
    assert 1 <= diag_fast["lp_blocks"] <= beta_full_fast.shape[1]
    assert diag_fast["lp_merge_rounds"] >= 0


def test_exact_lp_decomposition_merges_crossing_blocks() -> None:
    """When independent per-quantile planes cross, the PAV-style merge must kick in
    and the merged solution must (a) be monotone on the training rows and (b) still
    match the coupled LP optimum."""
    import neo_ls_svm_jax.models.cqr as cqr_mod

    # Heteroscedastic two-cluster design engineered so independent quantile planes
    # tilt differently and cross inside the data range.
    gen = np.random.RandomState(11)
    n = 600
    x = np.concatenate([gen.uniform(-2, -1, n // 2), gen.uniform(1, 2, n - n // 2)])
    noise = np.where(x < 0, 0.1, 2.0) * gen.standard_cauchy(n).clip(-5, 5)
    y = 0.5 * x + noise
    X = np.column_stack([x, np.ones(n)])
    quantiles = np.asarray((0.2, 0.4, 0.6, 0.8))
    diag: dict = {}
    beta, beta_full = coherent_linear_quantile_regression(
        X, y, quantiles=quantiles, method="exact", coherence_buffer=0, diagnostics=diag
    )
    pred = X @ beta_full
    assert np.all(np.diff(pred, axis=1) >= -1e-9)
    try:
        cqr_mod._LP_DECOMPOSITION = False
        _, beta_full_ref = coherent_linear_quantile_regression(
            X, y, quantiles=quantiles, method="exact", coherence_buffer=0
        )
    finally:
        cqr_mod._LP_DECOMPOSITION = True
    pin_fast = _pinball(y, X @ beta_full, quantiles)
    pin_ref = _pinball(y, X @ beta_full_ref, quantiles)
    assert pin_fast <= pin_ref * (1 + 1e-7)


def test_exact_lp_equilibration_retry_on_pathological_scaling() -> None:
    """HiGHS misreports mathematically-bounded pinball LPs (c ≥ 0, x ≥ 0) as
    unbounded when coefficients span ~20 orders of magnitude; the solver must fall
    back to the column-equilibrated formulation instead of raising.

    The fixture is a conformal level-1 design captured from a real failure
    (features scaled ~1e12: nonconformity ~1e12, |ŷ| ~1e12, intercept 1, with the
    √eps L1 weight ~5e-9) on which every raw HiGHS method returns "unbounded"."""
    from pathlib import Path

    from neo_ls_svm_jax.models.cqr import _solve_coupled_lp

    d = np.load(Path(__file__).parent / "data" / "lp_pathological_scaling.npz")
    X, y, q, s, alpha = d["X"], d["y"], d["q"], d["s"], float(d["alpha"])
    beta = _solve_coupled_lp(X, y, q, s, alpha)
    assert np.all(np.isfinite(beta))
    # The plane must be a valid 0.975-quantile fit: the weighted fraction of
    # training residuals above it matches 1 - q to pinball-optimality granularity.
    above = float(s[(y - (X @ beta)[:, 0]) > 0].sum() / s.sum())
    assert abs(above - (1.0 - float(q[0]))) < 5.0 / len(y)
