"""Parity of the real-embedding primal solver against the reference's complex solver."""

import jax.numpy as jnp
import numpy as np
import pytest

from neo_ls_svm_jax.models.primal import (
    gamma_grid,
    primal_decision_function,
    primal_fit,
    primal_predict_var,
)
from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures

from .conftest import make_classification_dataset, make_regression_dataset
from .reference_shim import import_reference

import_reference()
from neo_ls_svm import NeoLSSVM as RefNeoLSSVM  # noqa: E402


def _fit_both(task: str, weighted: bool = False, num_features: int = 96):
    if task == "regression":
        X, y = make_regression_dataset(n=1600, seed=11)
    else:
        X, y_raw = make_classification_dataset(n=1600, seed=11)
        y = np.where(y_raw == "pos", 1.0, -1.0)
    s = (np.random.RandomState(12).rand(len(y)) + 0.25) if weighted else np.ones_like(y)

    fmap = OrthogonalRandomFourierFeatures(num_features=num_features).fit(X, y, s)
    phi = fmap.transform(X)
    C = np.eye(num_features + 1, dtype=np.float64)

    ref = RefNeoLSSVM()
    ref._estimator_type = "classifier" if task == "classification" else "regressor"
    ref_beta, ref_gamma = ref._optimize_β̂_γ(phi, y, s.copy(), C)

    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)
    ours = primal_fit(
        jnp.asarray(X),
        jnp.asarray(M_map),
        jnp.asarray(b_map),
        jnp.asarray(y),
        jnp.asarray(s),
        jnp.asarray(gammas),
        is_classifier=(task == "classification"),
    )
    return X, y, s, fmap, phi, ref, ref_beta, ref_gamma, M_map, b_map, ours


@pytest.mark.parametrize("task", ["regression", "classification"])
@pytest.mark.parametrize("weighted", [False, True])
def test_primal_solver_matches_reference(task, weighted) -> None:
    X, y, s, fmap, phi, ref, ref_beta, ref_gamma, M_map, b_map, ours = _fit_both(task, weighted)

    assert float(ours["gamma"]) == pytest.approx(ref_gamma, rel=1e-12)
    np.testing.assert_allclose(
        np.asarray(ours["loo_errors_gammas"]), ref.loo_errors_γs_, rtol=1e-6, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ours["loo_residuals"]), ref.loo_residuals_, rtol=1e-5, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(ours["loo_leverage"]), ref.loo_leverage_, rtol=1e-5, atol=1e-12
    )
    assert float(ours["loo_error"]) == pytest.approx(ref.loo_error_, rel=1e-6)
    assert float(ours["loo_score"]) == pytest.approx(ref.loo_score_, rel=1e-6)
    np.testing.assert_allclose(np.asarray(ours["loo_std"]), ref.loo_std_, rtol=1e-5, atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(ours["residuals"]), ref.residuals_, rtol=1e-4, atol=1e-8
    )

    # The fitted coefficients agree through the decision function.
    X_new = np.random.RandomState(13).randn(300, X.shape[1])
    ref_decision = np.real(fmap.transform(X_new) @ ref_beta)
    ours_decision = np.asarray(
        primal_decision_function(
            jnp.asarray(X_new), jnp.asarray(M_map), jnp.asarray(b_map), ours["beta_emb"]
        )
    )
    np.testing.assert_allclose(ours_decision, ref_decision, rtol=1e-6, atol=1e-10)


def test_primal_predict_var_positive_and_consistent() -> None:
    X, y, s, fmap, phi, ref, ref_beta, ref_gamma, M_map, b_map, ours = _fit_both("regression")
    n, M = phi.shape
    var = np.asarray(
        primal_predict_var(
            jnp.asarray(X[:200]),
            jnp.asarray(M_map),
            jnp.asarray(b_map),
            ours["Qs"],
            ours["lam"],
            ours["gamma"],
            jnp.asarray(float(n * M)),
        )
    )
    assert np.all(var > 0)
    # In-sample: the LOO std must reproduce σ² + (sσ²)²/(1-h) of the train points.
    var_train = np.asarray(
        primal_predict_var(
            jnp.asarray(X),
            jnp.asarray(M_map),
            jnp.asarray(b_map),
            ours["Qs"],
            ours["lam"],
            ours["gamma"],
            jnp.asarray(float(n * M)),
        )
    )
    s_norm = s / s.sum()
    loo_var = var_train + (s_norm * var_train) ** 2 / (1 - np.asarray(ours["loo_leverage"]))
    np.testing.assert_allclose(np.asarray(ours["loo_std"]), np.sqrt(loo_var), rtol=1e-6)


def test_primal_general_complexity_matrix_matches_reference() -> None:
    """Non-identity C routes through the whitened GEVD and matches the reference's
    generalised-eigh + LU path (ref _neo_ls_svm.py:123-131)."""
    X, y = make_regression_dataset(n=1500, seed=14)
    s = np.ones_like(y)
    num_features = 48
    fmap = OrthogonalRandomFourierFeatures(num_features=num_features).fit(X, y, s)
    phi = fmap.transform(X)
    M = num_features + 1
    gen = np.random.RandomState(15)
    V = gen.randn(M, M)
    C = np.eye(M) + 0.3 * (V @ V.T) / M  # well-conditioned SPD, non-diagonal

    ref = RefNeoLSSVM()
    ref._estimator_type = "regressor"
    ref_beta, ref_gamma = ref._optimize_β̂_γ(phi, y, s.copy(), C.astype(np.float64))

    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)
    c_norm = np.mean(np.abs(np.diag(C))) * phi.size
    C_n = C / c_norm
    C_emb = np.block([[C_n, np.zeros_like(C_n)], [np.zeros_like(C_n), C_n]])
    ours = primal_fit(
        jnp.asarray(X),
        jnp.asarray(M_map),
        jnp.asarray(b_map),
        jnp.asarray(y),
        jnp.asarray(s),
        jnp.asarray(gammas),
        jnp.asarray(C_emb),
        is_classifier=False,
    )
    assert float(ours["gamma"]) == pytest.approx(ref_gamma, rel=1e-12)
    np.testing.assert_allclose(
        np.asarray(ours["loo_residuals"]), ref.loo_residuals_, rtol=1e-5, atol=1e-9
    )
    np.testing.assert_allclose(np.asarray(ours["loo_std"]), ref.loo_std_, rtol=1e-5, atol=1e-9)
    X_new = np.random.RandomState(16).randn(200, X.shape[1])
    ref_decision = np.real(fmap.transform(X_new) @ ref_beta)
    ours_decision = np.asarray(
        primal_decision_function(
            jnp.asarray(X_new), jnp.asarray(M_map), jnp.asarray(b_map), ours["beta_emb"]
        )
    )
    np.testing.assert_allclose(ours_decision, ref_decision, rtol=1e-6, atol=1e-10)


def test_gamma_grid_any_length() -> None:
    """primal_fit must accept grids that are not a multiple of gamma_chunk (the
    public gamma_grid helper invites arbitrary num)."""
    X, y = make_regression_dataset(n=600, seed=9)
    s = np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures(num_features=32).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    full = gamma_grid(np.float64, num=1000)  # 1000 % 128 != 0
    res = primal_fit(
        jnp.asarray(X), jnp.asarray(M_map), jnp.asarray(b_map),
        jnp.asarray(y), jnp.asarray(s), jnp.asarray(full), is_classifier=False,
    )
    assert res["loo_errors_gammas"].shape == (1000,)
    # The selected gamma must be the argmin of the returned objective curve on the
    # requested grid (no padding artifacts).
    aligned = primal_fit(
        jnp.asarray(X), jnp.asarray(M_map), jnp.asarray(b_map),
        jnp.asarray(y), jnp.asarray(s), jnp.asarray(full[:896]), is_classifier=False,
    )
    assert aligned["loo_errors_gammas"].shape == (896,)
    np.testing.assert_allclose(
        np.asarray(res["loo_errors_gammas"][:896]),
        np.asarray(aligned["loo_errors_gammas"]),
        rtol=1e-12,
    )


def test_inv_c0_scale_traced_int32_does_not_overflow() -> None:
    """n·M as int32 wraps for n ≥ ~4.2M at M=513; the float-first scale must not."""
    import jax
    import jax.numpy as jnp

    from neo_ls_svm_jax.models.primal import _inv_c0_scale

    n_traced = jnp.asarray(5_000_000, jnp.int32)  # n*513 > 2^31
    out = jax.jit(lambda n: _inv_c0_scale(n, 513, jnp.float32))(n_traced)
    assert float(out) == pytest.approx(5_000_000.0 * 513, rel=1e-6)
    assert float(out) > 0
    # And the static-int path agrees.
    assert float(_inv_c0_scale(5_000_000, 513, jnp.float32)) == pytest.approx(
        5_000_000.0 * 513, rel=1e-6
    )
