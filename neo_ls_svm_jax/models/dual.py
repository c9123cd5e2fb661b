"""Dual LS-SVM solver with closed-form leave-one-out γ tuning.

Implements the math of the reference's ``_optimize_α̂_γ`` (ref ``_neo_ls_svm.py:191-325``):
the kernel system (γρS⁻² + K)α̂ = y with K = φφᵀ + 11ᵀ - (1-ρ)/ρ·C, solved through one
EVD of the weighted kernel so that α̂(γ) and the exact LOO predictions for a whole γ grid
follow in closed form (Cawley & Talbot-style virtual LOO; ref derivation ``:229-243``).

Device-friendly reformulation of the LOO sweep: the reference materialises an n×G×n tensor
H_loo via einsum (``:272-278``, ~0.5–1 GB at n=1024). Here the contraction
Σₖ F̃ᵢₖ·H⁽ᵍ⁾ᵢₖ is refactored through the eigenbasis into ``(sQ ∘ (F̃ @ sQ)) @ r``, three
n×n matmuls plus n×G products — O(n²) memory instead of O(n²·G), no einsum.

Used for n ≤ 1024 (ref ``:375``), so everything fits on one device untiled.
"""

from functools import partial

import jax
import jax.numpy as jnp

from neo_ls_svm_jax.ops.kernels import rbf_kernel, squared_distances

RBF_GAMMA = 0.5  # Fixed kernel width; the metric is learned upstream (ref :257,261).


@partial(jax.jit, static_argnames=("rho", "is_classifier", "precision"))
def dual_fit(
    X: jax.Array,
    y: jax.Array,
    sample_weight: jax.Array,
    gammas: jax.Array,
    *,
    rho: float = 1.0,
    is_classifier: bool,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> dict[str, jax.Array]:
    """Fit the dual LS-SVM on (affine-transformed) X and tune γ by closed-form LOO."""
    n = X.shape[0]
    dtype = X.dtype
    eps = jnp.finfo(dtype).eps
    s = sample_weight / jnp.sum(sample_weight)
    sn = s / jnp.median(jnp.abs(s))

    K_rbf = rbf_kernel(X, X, RBF_GAMMA, same=True, precision=precision)
    F = K_rbf + 1.0  # φφᵀ + 11ᵀ: the rank-1 bias term rides the kernel (ref :261).
    if rho != 1.0:
        # Surface-complexity regulariser; inert at the shipped default ρ=1 (ref :256-263).
        sq = squared_distances(X, X, same=True, precision=precision)
        C = jnp.sqrt(K_rbf) * (1.0 - sq * (RBF_GAMMA / X.shape[1]))
        K = F - (1.0 - rho) / rho * C
    else:
        K = F
    lam, Q = jnp.linalg.eigh(sn[:, None] * K * sn[None, :])
    sQ = sn[:, None] * Q
    alpha_basis = sQ * jnp.dot(Q.T, sn * y, precision=precision)[None, :]

    # LOO sweep over the γ grid, all in the eigenbasis.
    r = 1.0 / (gammas[None, :] * rho + lam[:, None])  # n × G resolvent columns.
    F_od = F * (1.0 - jnp.eye(n, dtype=dtype))  # Off-diagonal F (ref :283-284).
    P = sQ * jnp.dot(F_od, sQ, precision=precision)  # (sQ ∘ F̃sQ): Σₖ F̃ᵢₖ H⁽ᵍ⁾ᵢₖ basis.
    cross = jnp.dot(P, r, precision=precision)  # n × G
    hdiag = jnp.dot(sQ * sQ, r, precision=precision)  # diag(H⁽ᵍ⁾), n × G
    hdiag = jnp.where(hdiag == 0, eps, hdiag)
    alpha_loo = jnp.dot(alpha_basis, r, precision=precision)  # α̂(γ) columns, n × G
    F_alpha = jnp.dot(F_od, alpha_basis, precision=precision)
    yhat_loo = (-cross / hdiag) * alpha_loo + jnp.dot(F_alpha, r, precision=precision)
    loo_residuals = yhat_loo - y[:, None]
    if is_classifier:
        y_col = y[:, None]
        loo_residuals = jnp.where(
            ((y_col > 0) & (loo_residuals > 0)) | ((y_col < 0) & (loo_residuals < 0)),
            0.0,
            loo_residuals,
        )
    abs_e = jnp.abs(loo_residuals)
    loo_errors_gs = s @ abs_e
    if is_classifier:
        objective = s @ (abs_e >= 1).astype(dtype) + s @ jnp.maximum(0.0, abs_e - 1) + loo_errors_gs
    else:
        objective = loo_errors_gs
    optimum = jnp.argmin(objective)
    gamma_opt = gammas[optimum]

    e_opt = loo_residuals[:, optimum]
    yhat_loo_opt = yhat_loo[:, optimum]  # Pre-clip LOO predictions feed loo_score_.
    if is_classifier:
        loo_score = s @ (jnp.sign(yhat_loo_opt) == y).astype(dtype)
    else:
        y_mean = s @ y
        resid = yhat_loo_opt - y
        loo_score = 1.0 - (s @ (resid * resid)) / (s @ ((y - y_mean) * (y - y_mean)))

    # Re-solve (γρ·diag(sn⁻²) + K)α̂ = y via Cholesky for accuracy (ref :313-314).
    K_reg = K + jnp.diag(gamma_opt * rho / (sn * sn))
    L = jax.scipy.linalg.cholesky(K_reg, lower=True)
    alpha = jax.scipy.linalg.cho_solve((L, True), y)
    residuals = jnp.dot(F, alpha, precision=precision) - y
    if is_classifier:
        residuals = jnp.where(((y > 0) & (residuals > 0)) | ((y < 0) & (residuals < 0)), 0.0, residuals)

    # Predictive variance σ²(x) = 1 - k(x,X)(LLᵀ)⁻¹k(X,x) on the train points (ref :321-323).
    sigma2 = 1.0 - jnp.sum(K_rbf * jax.scipy.linalg.cho_solve((L, True), K_rbf.T).T, axis=1)

    return {
        "alpha": alpha,
        "gamma": gamma_opt,
        "optimum_index": optimum,
        "chol": L,
        "loo_errors_gammas": loo_errors_gs,
        "loo_residuals": e_opt,
        "loo_yhat": y + e_opt,
        "loo_error": loo_errors_gs[optimum],
        "loo_score": loo_score,
        "loo_std": jnp.sqrt(sigma2),
        "residuals": residuals,
    }


@partial(jax.jit, static_argnames=("precision",))
def dual_decision_function(
    X: jax.Array,
    X_train: jax.Array,
    alpha: jax.Array,
    *,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """ŷ(x) = k(x, X)α̂ + 1ᵀα̂ (ref ``:666-671``)."""
    K = rbf_kernel(X, X_train, RBF_GAMMA, precision=precision)
    return jnp.dot(K, alpha, precision=precision) + jnp.sum(alpha)


@partial(jax.jit, static_argnames=("precision",))
def dual_decision_var(
    X: jax.Array,
    X_train: jax.Array,
    alpha: jax.Array,
    chol: jax.Array,
    *,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """ŷ(x) and σ²(x) stacked (n, 2), sharing ONE RBF kernel block.

    Both heads are dominated by the n×n_train Gram ``k(x, X)`` (ref ``:666-671`` and
    ``:471-475``); the conformal paths need both per row, and two separate jitted
    calls would each rebuild the block. One program halves the dominant FLOPs and
    costs a single dispatch per chunk.
    """
    K = rbf_kernel(X, X_train, RBF_GAMMA, precision=precision)
    yhat = jnp.dot(K, alpha, precision=precision) + jnp.sum(alpha)
    solved = jax.scipy.linalg.cho_solve((chol, True), K.T)
    var = 1.0 - jnp.sum(K * solved.T, axis=1)
    return jnp.stack([yhat, var], axis=1)


@partial(jax.jit, static_argnames=("precision",))
def dual_predict_var(
    X: jax.Array,
    X_train: jax.Array,
    chol: jax.Array,
    *,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """σ²(x) = K(x,x) - k(x,X)(LLᵀ)⁻¹k(X,x) (ref ``:471-475``)."""
    K = rbf_kernel(X, X_train, RBF_GAMMA, precision=precision)
    solved = jax.scipy.linalg.cho_solve((chol, True), K.T)
    return 1.0 - jnp.sum(K * solved.T, axis=1)
