"""The streaming (O(chunk) memory) primal solver matches the in-memory solver."""

import jax.numpy as jnp
import numpy as np
import pytest

from neo_ls_svm_jax.models.primal import gamma_grid, primal_fit, primal_fit_streaming
from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures

from .conftest import make_classification_dataset, make_regression_dataset


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_streaming_matches_inmemory(task) -> None:
    if task == "regression":
        X, y = make_regression_dataset(n=2048, seed=61)
    else:
        X, y_raw = make_classification_dataset(n=2048, seed=61)
        y = np.where(y_raw == "pos", 1.0, -1.0)
    s = np.random.RandomState(62).rand(len(y)) + 0.25
    fmap = OrthogonalRandomFourierFeatures(num_features=64).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)
    args = (
        jnp.asarray(X),
        jnp.asarray(M_map),
        jnp.asarray(b_map),
        jnp.asarray(y),
        jnp.asarray(s),
        jnp.asarray(gammas),
    )
    dense = primal_fit(*args, is_classifier=(task == "classification"))
    streamed = primal_fit_streaming(
        *args, is_classifier=(task == "classification"), row_chunk=256
    )
    assert float(streamed["gamma"]) == pytest.approx(float(dense["gamma"]), rel=1e-12)
    for key in ("loo_residuals", "loo_leverage", "loo_std", "residuals", "beta_emb"):
        np.testing.assert_allclose(
            np.asarray(streamed[key]), np.asarray(dense[key]), rtol=1e-6, atol=1e-10, err_msg=key
        )
    np.testing.assert_allclose(
        np.asarray(streamed["loo_errors_gammas"]),
        np.asarray(dense["loo_errors_gammas"]),
        rtol=1e-8,
    )
    assert float(streamed["loo_score"]) == pytest.approx(float(dense["loo_score"]), rel=1e-8)


def test_streaming_with_padding_matches_unpadded() -> None:
    X, y = make_regression_dataset(n=1000, seed=63)
    s = np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures(num_features=32).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)
    # Pad rows to the chunk multiple with zero weights.
    pad = 1024 - 1000
    X_p = np.vstack([X, np.zeros((pad, X.shape[1]))])
    y_p = np.concatenate([y, np.zeros(pad)])
    s_p = np.concatenate([s, np.zeros(pad)])
    padded = primal_fit_streaming(
        jnp.asarray(X_p),
        jnp.asarray(M_map),
        jnp.asarray(b_map),
        jnp.asarray(y_p),
        jnp.asarray(s_p),
        jnp.asarray(gammas),
        is_classifier=False,
        row_chunk=256,
        num_samples=1000,
    )
    dense = primal_fit(
        jnp.asarray(X),
        jnp.asarray(M_map),
        jnp.asarray(b_map),
        jnp.asarray(y),
        jnp.asarray(s),
        jnp.asarray(gammas),
        is_classifier=False,
    )
    assert float(padded["gamma"]) == pytest.approx(float(dense["gamma"]), rel=1e-12)
    np.testing.assert_allclose(
        np.asarray(padded["loo_residuals"])[:1000],
        np.asarray(dense["loo_residuals"]),
        rtol=1e-6,
        atol=1e-10,
    )


@pytest.mark.parametrize("weighted", [False, True])
def test_streaming_matches_inmemory_float32(weighted) -> None:
    """The accelerator configuration: float32 operands at HIGHEST precision. The two
    routes sum in different orders, so γ may move by at most one grid step and the LOO
    residuals agree to float32 summation-order tolerance."""
    X, y = make_regression_dataset(n=2048, seed=64, dtype=np.float32)
    s = (np.random.RandomState(65).rand(len(y)) + 0.25) if weighted else np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures(num_features=64).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float32)
    args = tuple(jnp.asarray(a, jnp.float32) for a in (X, M_map, b_map, y, s, gammas))
    dense = primal_fit(*args, is_classifier=False)
    streamed = primal_fit_streaming(*args, is_classifier=False, row_chunk=512)
    assert streamed["loo_residuals"].dtype == jnp.float32
    assert abs(int(streamed["optimum_index"]) - int(dense["optimum_index"])) <= 1
    e_s, e_d = np.asarray(streamed["loo_residuals"]), np.asarray(dense["loo_residuals"])
    assert np.max(np.abs(e_s - e_d)) <= 1e-3 * np.std(e_d)
