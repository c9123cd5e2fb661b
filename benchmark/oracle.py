"""Plain float64 NumPy oracles of the primal and dual LS-SVM fits.

Straightforward implementations of the reference's semantics (``_optimize_β̂_γ`` and
``_optimize_α̂_γ`` with the shipped defaults: identity complexity matrix, ρ = 1, uniform
sample weights, regression objective), independent of the JAX solvers under test:

- the primal oracle works on the complex feature matrix φ (no real embedding) with a
  complex Hermitian eigh and evaluates the LOO residuals of every γ as full n×G panels;
- the dual oracle inverts the regularised kernel system once per γ and applies the
  virtual-LOO formula element by element (no eigenbasis refactoring).

``bench.py`` times the primal oracle as its NumPy baseline; ``chip_smoke.py`` and the
tests check the accelerator fits against both.
"""

import numpy as np
import scipy.linalg

RBF_GAMMA = 0.5  # The dual kernel width (ref ``_neo_ls_svm.py:257,261``).


def numpy_reference_fit(phi: np.ndarray, y: np.ndarray, gammas: np.ndarray) -> dict:
    """Reference-equivalent complex NumPy primal solve with uniform sample weights.

    Gram → complex Hermitian eigh → closed-form LOO residuals over the γ grid →
    Cholesky re-solve (see SURVEY.md §3.1). Returns the selected γ and its grid index,
    the complex coefficients β̂ (ŷ = Re(φβ̂)), the LOO error at the optimum and over the
    whole grid, and the optimum's LOO residuals.
    """
    n, M = phi.shape
    s = np.full(n, 1.0 / n, dtype=y.dtype)
    s_phi = s[:, None] * phi
    gram = s_phi.conj().T @ s_phi
    gram = (gram + gram.conj().T) / 2
    inv_c0 = n * M
    lam, Q = scipy.linalg.eigh(inv_c0 * gram)
    rhs = s_phi.conj().T @ (s * y)
    beta_basis = Q * (inv_c0 * (Q.conj().T @ rhs))[None, :]
    phi_beta = np.ascontiguousarray(np.real(phi @ beta_basis))
    leverage_basis = np.ascontiguousarray(
        np.real(s_phi @ Q * (inv_c0 * (Q.conj().T @ s_phi.conj().T)).T)
    )
    resolvent = 1.0 / (gammas[None, :] + lam[:, None])
    with np.errstate(divide="ignore", invalid="ignore"):
        loo_residuals = (phi_beta @ resolvent - y[:, None]) / (1 - leverage_basis @ resolvent)
    loo_errors = s @ np.abs(loo_residuals)
    best = int(np.argmin(loo_errors))
    gamma = gammas[best]
    L = scipy.linalg.cho_factor(gamma / inv_c0 * np.eye(M, dtype=gram.dtype) + gram)
    beta = scipy.linalg.cho_solve(L, rhs)
    return {
        "gamma": float(gamma),
        "optimum_index": best,
        "beta": beta,
        "loo_error": float(loo_errors[best]),
        "loo_errors": loo_errors,
        "loo_residuals": loo_residuals[:, best],
    }


def primal_predict(phi: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """ŷ = Re(φβ̂) (ref ``_neo_ls_svm.py:661-665``)."""
    return np.real(phi @ beta)


def rbf_kernel(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """exp(-γ‖x-y‖²) from explicit pairwise differences."""
    sq = np.sum((X[:, None, :] - Y[None, :, :]) ** 2, axis=-1)
    return np.exp(-RBF_GAMMA * sq)


def dual_fit(X: np.ndarray, y: np.ndarray, gammas: np.ndarray) -> dict:
    """Dual LS-SVM with uniform weights and ρ = 1: (γI + K)α̂ = y, K = k(X, X) + 11ᵀ.

    For every γ the inverse H = (γI + K)⁻¹ is formed outright and the virtual LOO
    prediction is ŷᵢ = (K̃α̂)ᵢ − (Σₖ K̃ᵢₖHᵢₖ / Hᵢᵢ)·α̂ᵢ with K̃ the off-diagonal kernel
    (ref ``_neo_ls_svm.py:229-243,272-284``).
    """
    n = X.shape[0]
    K = rbf_kernel(X, X) + 1.0
    K_od = K * (1.0 - np.eye(n))
    loo_errors = np.empty(len(gammas))
    for g, gamma in enumerate(gammas):
        H = scipy.linalg.inv(gamma * np.eye(n) + K, assume_a="pos")
        alpha = H @ y
        yhat_loo = K_od @ alpha - np.sum(K_od * H, axis=1) / np.diag(H) * alpha
        loo_errors[g] = np.mean(np.abs(yhat_loo - y))
    best = int(np.argmin(loo_errors))
    gamma = float(gammas[best])
    alpha = scipy.linalg.solve(gamma * np.eye(n) + K, y, assume_a="pos")
    return {
        "gamma": gamma,
        "optimum_index": best,
        "alpha": alpha,
        "loo_error": float(loo_errors[best]),
        "loo_errors": loo_errors,
    }


def dual_predict(X: np.ndarray, X_train: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """ŷ(x) = k(x, X)α̂ + 1ᵀα̂ (ref ``_neo_ls_svm.py:666-671``)."""
    return rbf_kernel(X, X_train) @ alpha + np.sum(alpha)
