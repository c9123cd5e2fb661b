"""The float64 NumPy oracles (benchmark/oracle.py) agree with the JAX solvers in x64.

The oracles are what the accelerator fits are checked against on the card, so they are
first checked here against the solvers at float64, where the two must agree to
round-off.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from neo_ls_svm_jax.models.dual import dual_decision_function, dual_fit
from neo_ls_svm_jax.models.primal import gamma_grid, primal_decision_function, primal_fit
from neo_ls_svm_jax.ops.affine import AffineSeparator
from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures

from .conftest import make_regression_dataset

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from benchmark import oracle  # noqa: E402


@pytest.mark.parametrize("num_features", [64, 256])
def test_primal_oracle_matches_primal_fit(num_features) -> None:
    X, y = make_regression_dataset(n=2048, seed=71)
    s = np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures(num_features=num_features).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)
    ref = oracle.numpy_reference_fit(fmap.transform(X), y, gammas)
    ours = primal_fit(
        *(jnp.asarray(a) for a in (X, M_map, b_map, y, s, gammas)), is_classifier=False
    )
    assert int(ours["optimum_index"]) == ref["optimum_index"]
    assert float(ours["loo_error"]) == pytest.approx(ref["loo_error"], rel=1e-8)
    np.testing.assert_allclose(
        np.asarray(ours["loo_residuals"]), ref["loo_residuals"], rtol=1e-6, atol=1e-9
    )
    X_new = X[:200] + 0.1
    np.testing.assert_allclose(
        np.asarray(primal_decision_function(X_new, M_map, b_map, ours["beta_emb"])),
        oracle.primal_predict(fmap.transform(X_new), ref["beta"]),
        rtol=1e-6,
        atol=1e-8,
    )


def test_dual_oracle_matches_dual_fit() -> None:
    X, y = make_regression_dataset(n=300, seed=72)
    s = np.ones_like(y)
    X_t = AffineSeparator().fit(X, y, s).transform(X)
    gammas = gamma_grid(np.float64, num=128)
    ref = oracle.dual_fit(X_t, y, gammas)
    ours = dual_fit(
        jnp.asarray(X_t), jnp.asarray(y), jnp.asarray(s), jnp.asarray(gammas),
        is_classifier=False,
    )
    assert int(ours["optimum_index"]) == ref["optimum_index"]
    assert float(ours["loo_error"]) == pytest.approx(ref["loo_error"], rel=1e-8)
    X_new = X_t[:50] + 0.05
    np.testing.assert_allclose(
        np.asarray(dual_decision_function(X_new, X_t, ours["alpha"])),
        oracle.dual_predict(X_new, X_t, ref["alpha"]),
        rtol=1e-7,
        atol=1e-9,
    )
