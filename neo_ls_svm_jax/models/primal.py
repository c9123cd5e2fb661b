"""Primal LS-SVM solver with closed-form leave-one-out γ tuning, in the real embedding.

Implements the math of the reference's ``_optimize_β̂_γ`` (ref ``_neo_ls_svm.py:77-189``):

    β̂(γ) = argmin ‖S(φ(X)β̂ - y)‖² + γ β̂ᴴCβ̂,   C = c₀·I (shipped default)

with the LOO residuals of *every* γ on a grid obtained from one eigendecomposition:

    e⁽ˡᵒᵒ⁾(γ) = (φβ̂(γ) - y) / (1 - h(γ)),   h, φβ̂ rational in γ through Q diag(1/(γ+λ)) Qᴴ

Real formulation — no complex arithmetic anywhere:
the complex Hermitian system (φ = cos(U)+i·(-sin(U)) features) is carried in its exact
real symmetric embedding E(A) = [[Re A, -Im A], [Im A, Re A]]. For W = [cos U/√D, 1 |
sin U/√D, 0] (n×2M, M = D+1), all four blocks of E(A) come out of ONE matmul
WᵀS²W, the eigh is a real symmetric 2M×2M decomposition (complex eigenpairs appear as
exact duplicated pairs whose contributions this solver sums — phase-invariant, hence
exact), and the γ-sweep is two (n×2M)@(2M×G) matmuls evaluated in chunks so memory
stays O(n·2M). The solver therefore needs only real eigh/Cholesky, which every XLA
backend provides.

The γ-grid objective reduction streams over γ-chunks via ``lax.map``; only the optimum's
residual vector is ever materialised at full length.
"""

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_GAMMAS = (1e-6, 20.0, 1024)  # log-spaced grid (ref _neo_ls_svm.py:146)

# Result keys with one entry per input row (everything else is grid- or basis-sized).
PER_ROW_KEYS = frozenset({"loo_residuals", "loo_yhat", "loo_leverage", "loo_std", "residuals"})


def trim_per_row(result: dict, num_samples: int) -> dict:
    """Drop padding rows from the per-row outputs of a (padded) solver result."""
    return {k: (v[:num_samples] if k in PER_ROW_KEYS else v) for k, v in result.items()}


def gamma_grid(dtype: Any, num: int = 1024, lo: float = 1e-6, hi: float = 20.0) -> np.ndarray:
    """The γ grid the LOO sweep evaluates (ref ``_neo_ls_svm.py:146,270``)."""
    return np.logspace(np.log10(lo), np.log10(hi), num, dtype=dtype)


def _features_real_pair(
    X: jax.Array, M_map: jax.Array, b_map: jax.Array, *, precision: jax.lax.Precision
) -> jax.Array:
    """Build W = [cos U/√D, 1 | sin U/√D, 0] from the folded affine map U = X@M + b.

    The two M-column halves are the real part P and minus-the-imaginary part (−N) of
    φ = exp(-1j·U)/√D with its bias column: P = [cos U/√D, 1], N = [−sin U/√D, 0].
    """
    n = X.shape[0]
    D = M_map.shape[1]
    U = jnp.dot(X, M_map, precision=precision) + b_map
    inv_sqrt_D = 1.0 / jnp.sqrt(jnp.asarray(D, X.dtype))
    ones = jnp.ones((n, 1), X.dtype)
    zeros = jnp.zeros((n, 1), X.dtype)
    return jnp.concatenate([jnp.cos(U) * inv_sqrt_D, ones, jnp.sin(U) * inv_sqrt_D, zeros], axis=1)


def embed_from_gram_blocks(G: jax.Array, M: int) -> jax.Array:
    """Recombine the blocks of a WᵀS²W Gram into the symmetrised real embedding.

    φ = P - i·N  ⇒  A = φᴴS²φ has  Re A = PᵀS²P + NᵀS²N,  Im A = PᵀS²N - NᵀS²P,
    and E(A) = [[Re A, -Im A], [Im A, Re A]]. This sign-sensitive recombination is
    shared by the in-memory, streaming, and sharded-streaming solvers.
    """
    PP, PN = G[:M, :M], G[:M, M:]
    NP, NN = G[M:, :M], G[M:, M:]
    Ar = PP + NN
    Ai = PN - NP
    B = jnp.block([[Ar, -Ai], [Ai, Ar]])
    return (B + B.T) / 2


def _embedding_gram(W: jax.Array, s2: jax.Array, *, precision: jax.lax.Precision) -> jax.Array:
    """E(φᴴS²φ) from one matmul: blocks of WᵀS²W recombined into the real embedding."""
    M2 = W.shape[1]
    G = jnp.dot(W.T * s2[None, :], W, precision=precision)
    return embed_from_gram_blocks(G, M2 // 2)


def _inv_c0_scale(n: "jax.Array | int", M: int, dtype: Any) -> jax.Array:
    """1/c₀ = n·M, computed in floating point.

    ``n`` may be a traced scalar (padded callers pass the true row count as a jit
    argument); multiplying as integers would wrap int32 once n·M exceeds 2³¹
    (n ≈ 4.2M rows at M = 513), so cast to the float dtype BEFORE the multiply.
    """
    if isinstance(n, jax.Array):
        return n.astype(dtype) * jnp.asarray(M, dtype)
    return jnp.asarray(float(n) * M, dtype)


def _clip_classifier_residuals(e: jax.Array, y: jax.Array, is_classifier: bool) -> jax.Array:
    """Zero the residuals of confidently-correct classifications (ref ``:153-155``)."""
    if not is_classifier:
        return e
    y_b = y if e.ndim == 1 else y[:, None]
    return jnp.where(((y_b > 0) & (e > 0)) | ((y_b < 0) & (e < 0)), 0.0, e)


def _sweep_objective(
    e: jax.Array, s: jax.Array, is_classifier: bool
) -> tuple[jax.Array, jax.Array]:
    """Weighted-abs-LOO error and the γ-selection objective (ref ``:158-165``)."""
    abs_e = jnp.abs(e)
    loo_err = s @ abs_e
    if is_classifier:
        objective = s @ (abs_e >= 1).astype(e.dtype) + s @ jnp.maximum(0.0, abs_e - 1) + loo_err
    else:
        objective = loo_err
    return loo_err, objective


def _eigendecompose(
    B: jax.Array, C_emb: jax.Array | None, inv_c0: jax.Array, sign: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Eigendecompose the embedded Gram against the complexity matrix.

    Returns (λ, Qs, scale) with Qs = J@Q sign-folded so Z@Q = W@Qs, and ``scale`` the
    factor in (γC + A)⁻¹ = scale · Q diag(1/(γ+λ)) Qᵀ (1 for the GEVD path).
    """
    dtype = B.dtype
    if C_emb is None:
        with jax.named_scope("eigh"):
            lam, Q = jnp.linalg.eigh(inv_c0 * B)
    else:
        # Whitened GEVD: A·Q = C·Q·Λ with Q = Lc⁻ᵀ·Q́, eigh(Lc⁻¹·A·Lc⁻ᵀ) = Q́ΛQ́ᵀ.
        # Q is C-orthonormal, so (γC + A)⁻¹ = Q (γI + Λ)⁻¹ Qᵀ with no extra scaling.
        with jax.named_scope("gevd_whiten"):
            Lc = jax.scipy.linalg.cholesky(C_emb, lower=True)
            half = jax.scipy.linalg.solve_triangular(Lc, B, lower=True)
            Bw = jax.scipy.linalg.solve_triangular(Lc, half.T, lower=True).T
            Bw = (Bw + Bw.T) / 2
        with jax.named_scope("eigh"):
            lam, Qw = jnp.linalg.eigh(Bw)
        Q = jax.scipy.linalg.solve_triangular(Lc, Qw, lower=True, trans=1)
        inv_c0 = jnp.asarray(1.0, dtype)
    # Z = [P, -N] = W @ blockdiag(I, -I); fold the sign flip into Q once.
    return lam, sign[:, None] * Q, inv_c0



@partial(
    jax.jit,
    static_argnames=("is_classifier", "gamma_chunk", "precision", "sweep_precision"),
)
def primal_fit(
    X: jax.Array,
    M_map: jax.Array,
    b_map: jax.Array,
    y: jax.Array,
    sample_weight: jax.Array,
    gammas: jax.Array,
    C_emb: jax.Array | None = None,
    *,
    is_classifier: bool,
    gamma_chunk: int = 128,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
    sweep_precision: jax.lax.Precision | None = None,
    num_samples: jax.Array | int | None = None,
) -> dict[str, jax.Array]:
    """Fit the primal LS-SVM and tune γ by closed-form leave-one-out error.

    Returns a pytree with the fitted coefficients (in embedding space), the eigenbasis
    needed for out-of-sample predictive variance, and every LOO statistic the estimator
    exposes (ref attribute list ``_neo_ls_svm.py:146-187``).

    ``num_samples`` overrides the row count used in the c₀ normalisation so callers may
    pad X with zero-weight rows (for sharding alignment) without perturbing the solution.

    ``sweep_precision`` controls only the γ-sweep contractions (selection of the argmin
    over a smooth objective tolerates reduced-precision products: ``DEFAULT`` runs
    float32 products in TF32 on NVIDIA tensor cores); the Gram/eigh stay at
    ``precision``. Defaults to ``precision``.

    ``C_emb`` is the *normalised* complexity matrix in the real embedding (2M×2M). When
    None (the shipped default: C = c₀·I, ref ``_feature_maps.py:133-135``) the solver
    takes the scaled-identity fast path; otherwise the generalised eigenproblem
    A·Q = C·Q·Λ (ref ``_neo_ls_svm.py:123-131``) is reduced to a standard symmetric
    eigh by Cholesky whitening — all real (no LU needed).
    """
    n = X.shape[0] if num_samples is None else num_samples
    dtype = X.dtype
    if sweep_precision is None:
        sweep_precision = precision
    s = sample_weight / jnp.sum(sample_weight)
    s2 = s * s
    with jax.named_scope("featmap"):
        W = _features_real_pair(X, M_map, b_map, precision=precision)
    M2 = W.shape[1]
    M = M2 // 2
    # c₀: the normalised complexity matrix is c₀·I with c₀ = 1/(n·M) (ref :117-118 with
    # the shipped identity complexity matrix; φ.size = n·M).
    inv_c0 = _inv_c0_scale(n, M, dtype)
    inv_c0_id = inv_c0  # Identity-C resolvent scale, kept for the re-solve below.
    with jax.named_scope("gram"):
        B = _embedding_gram(W, s2, precision=precision)
    sign = jnp.concatenate([jnp.ones((M,), dtype), -jnp.ones((M,), dtype)])
    lam, Qs, inv_c0 = _eigendecompose(B, C_emb, inv_c0, sign)
    Gu = jnp.dot(W, Qs, precision=precision)  # n×2M: rows are zᵢᵀQ.
    b_vec = jnp.dot(W.T, s2 * y, precision=precision)  # Wᵀ S² y
    k = jnp.dot(Qs.T, b_vec, precision=precision)  # QᵀZᵀS²y
    Gu2 = Gu * Gu
    s2_col = s2[:, None]

    def loo_terms(
        r: jax.Array, dot_precision: jax.lax.Precision = precision
    ) -> tuple[jax.Array, jax.Array]:
        """φβ̂(γ)-columns and leverage-columns for resolvent columns r = 1/(γ+λ)."""
        num = inv_c0 * jnp.dot(Gu, k[:, None] * r, precision=dot_precision)
        lev = inv_c0 * s2_col * jnp.dot(Gu2, r, precision=dot_precision)
        return num, lev

    def sweep_chunk(g_chunk: jax.Array) -> tuple[jax.Array, jax.Array]:
        r = 1.0 / (g_chunk[None, :] + lam[:, None])  # 2M × chunk
        phi_beta, lev = loo_terms(r, sweep_precision)
        e = (phi_beta - y[:, None]) / (1.0 - lev)
        e = _clip_classifier_residuals(e, y, is_classifier)
        return _sweep_objective(e, s, is_classifier)

    # Pad the grid to a chunk multiple by repeating the last γ (argmin-invariant:
    # jnp.argmin returns the FIRST minimum, and the pads are trimmed before it runs).
    num_gammas = gammas.shape[0]
    gamma_pad = (-num_gammas) % gamma_chunk
    gammas_p = (
        jnp.concatenate([gammas, jnp.broadcast_to(gammas[-1:], (gamma_pad,))])
        if gamma_pad
        else gammas
    )
    g_chunks = gammas_p.reshape(-1, gamma_chunk)
    with jax.named_scope("gamma_sweep"):
        loo_err_chunks, obj_chunks = jax.lax.map(sweep_chunk, g_chunks)
    loo_errors_gs = loo_err_chunks.reshape(-1)[:num_gammas]
    objective = obj_chunks.reshape(-1)[:num_gammas]
    optimum = jnp.argmin(objective)
    gamma_opt = gammas[optimum]

    # Recompute the optimum's full LOO vectors (cheap: one resolvent column).
    r_opt = (1.0 / (gamma_opt + lam))[:, None]
    phi_beta_opt, lev_opt = loo_terms(r_opt)
    phi_beta_opt, lev_opt = phi_beta_opt[:, 0], lev_opt[:, 0]
    e_raw = (phi_beta_opt - y) / (1.0 - lev_opt)
    e_clipped = _clip_classifier_residuals(e_raw, y, is_classifier)
    yhat_loo_raw = y + e_raw  # Pre-clip LOO predictions feed loo_score_ (ref :150,172).
    if is_classifier:
        correct = (jnp.sign(yhat_loo_raw) == y).astype(dtype)
        loo_score = s @ correct
    else:
        y_mean = s @ y
        ss_res = s @ (e_raw * e_raw)
        ss_tot = s @ ((y - y_mean) * (y - y_mean))
        loo_score = 1.0 - ss_res / ss_tot

    # Re-solve (γC + A)β̂ = φᴴS²y at the optimum via Cholesky for accuracy (ref :177-178),
    # in embedding space: (γ·C + B) β̂_emb = Zᵀ S² y.
    if C_emb is None:
        B_reg = B + (gamma_opt / inv_c0_id) * jnp.eye(M2, dtype=dtype)
    else:
        B_reg = B + gamma_opt * C_emb
    with jax.named_scope("cholesky_resolve"):
        L = jax.scipy.linalg.cholesky(B_reg, lower=True)
    rhs = sign * b_vec  # Zᵀ S² y = J Wᵀ S² y
    beta_emb = jax.scipy.linalg.cho_solve((L, True), rhs)
    # Z @ β̂_emb = W @ (J β̂_emb); contract through W directly (valid for both the
    # orthonormal and the C-orthonormal eigenbasis).
    residuals = jnp.dot(W, sign * beta_emb, precision=precision) - y
    residuals = _clip_classifier_residuals(residuals, y, is_classifier)

    # Bayesian LOO predictive variance via the eigenbasis (≡ cho_solve against γC + A,
    # ref :183-187) plus the Sherman–Morrison leave-one-out correction.
    sigma2 = inv_c0 * jnp.dot(Gu2, r_opt, precision=precision)[:, 0]
    loo_sigma2 = sigma2 + (s * sigma2) ** 2 / (1.0 - lev_opt)

    return {
        "beta_emb": beta_emb,
        "gamma": gamma_opt,
        "optimum_index": optimum,
        "lam": lam,
        "Qs": Qs,
        "loo_errors_gammas": loo_errors_gs,
        "loo_residuals": e_clipped,
        "loo_yhat": y + e_clipped,
        "loo_leverage": lev_opt,
        "loo_error": loo_errors_gs[optimum],
        "loo_score": loo_score,
        "loo_std": jnp.sqrt(loo_sigma2),
        "residuals": residuals,
    }


@partial(jax.jit, static_argnames=("precision",))
def primal_decision_function(
    X: jax.Array,
    M_map: jax.Array,
    b_map: jax.Array,
    beta_emb: jax.Array,
    *,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """ŷ(x) = Re(φ(x)ᵀβ̂) as a single fused matmul chain (ref ``:661-665``)."""
    W = _features_real_pair(X, M_map, b_map, precision=precision)
    M = W.shape[1] // 2
    sign = jnp.concatenate([jnp.ones((M,), X.dtype), -jnp.ones((M,), X.dtype)])
    return jnp.dot(W, sign * beta_emb, precision=precision)


@partial(jax.jit, static_argnames=("precision",))
def primal_decision_var(
    X: jax.Array,
    M_map: jax.Array,
    b_map: jax.Array,
    beta_emb: jax.Array,
    Qs: jax.Array,
    lam: jax.Array,
    gamma: jax.Array,
    inv_c0: jax.Array,
    *,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """ŷ(x) and σ²(x) stacked (n, 2), sharing ONE feature transform.

    The conformal paths (ref ``predict_quantiles``, ``_neo_ls_svm.py:554-624``) need
    both heads for every row; evaluating them as one program computes the O(n·2M·d)
    feature block W once (two jitted calls would each rebuild it) and costs a single
    dispatch per chunk.
    """
    W = _features_real_pair(X, M_map, b_map, precision=precision)
    M = W.shape[1] // 2
    sign = jnp.concatenate([jnp.ones((M,), X.dtype), -jnp.ones((M,), X.dtype)])
    yhat = jnp.dot(W, sign * beta_emb, precision=precision)
    Gu = jnp.dot(W, Qs, precision=precision)
    r = (1.0 / (gamma + lam))[:, None]
    var = inv_c0 * jnp.dot(Gu * Gu, r, precision=precision)[:, 0]
    return jnp.stack([yhat, var], axis=1)


@partial(jax.jit, static_argnames=("precision",))
def primal_predict_var(
    X: jax.Array,
    M_map: jax.Array,
    b_map: jax.Array,
    Qs: jax.Array,
    lam: jax.Array,
    gamma: jax.Array,
    inv_c0: jax.Array,
    *,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """σ²(x) = Re(φ(x)ᵀ(γC + A)⁻¹φ(x)) via the stored eigenbasis (ref ``:464-469``)."""
    W = _features_real_pair(X, M_map, b_map, precision=precision)
    Gu = jnp.dot(W, Qs, precision=precision)
    r = (1.0 / (gamma + lam))[:, None]
    return inv_c0 * jnp.dot(Gu * Gu, r, precision=precision)[:, 0]


@partial(
    jax.jit,
    static_argnames=(
        "is_classifier",
        "row_chunk",
        "precision",
        "sweep_precision",
        "num_samples",
    ),
)
def primal_fit_streaming(
    X: jax.Array,
    M_map: jax.Array,
    b_map: jax.Array,
    y: jax.Array,
    sample_weight: jax.Array,
    gammas: jax.Array,
    C_emb: jax.Array | None = None,
    *,
    is_classifier: bool,
    row_chunk: int = 16384,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
    sweep_precision: jax.lax.Precision | None = None,
    num_samples: int | None = None,
) -> dict[str, jax.Array]:
    """Streaming variant of :func:`primal_fit`: O(row_chunk·2M) device memory.

    Three scans over row chunks — (1) augmented-Gram accumulation, (2) γ-sweep
    objective reduction, (3) per-row statistics at the optimum — rebuild the cos/sin
    feature block per chunk instead of materialising the n×2M feature matrix, its
    eigenbasis projection, and their squares (~12·n·M bytes). This caps device memory for
    arbitrarily large n; the extra cost is recomputing the feature block three times
    (one small n×d×D matmul plus elementwise cos/sin per pass — cheap next to the 2M-wide
    contractions). Results are identical to :func:`primal_fit` up to float summation
    order. Callers pad rows to a multiple of ``row_chunk`` with zero sample weights
    and pass the true row count via ``num_samples``.
    """
    n_pad = X.shape[0]
    assert n_pad % row_chunk == 0, "pad rows to a multiple of row_chunk"
    if sweep_precision is None:
        sweep_precision = precision
    n = n_pad if num_samples is None else num_samples
    dtype = X.dtype
    D = M_map.shape[1]
    M = D + 1
    M2 = 2 * M
    s = sample_weight / jnp.sum(sample_weight)
    s2 = s * s
    nb = n_pad // row_chunk
    Xc = X.reshape(nb, row_chunk, -1)
    yc = y.reshape(nb, row_chunk)
    sc = s.reshape(nb, row_chunk)
    s2c = s2.reshape(nb, row_chunk)
    sign = jnp.concatenate([jnp.ones((M,), dtype), -jnp.ones((M,), dtype)])

    # Pass 1: one augmented Gram accumulates every second-order statistic at once —
    # Y = [W | y] so YᵀS²Y contains WᵀS²W (the Gram), WᵀS²y (the rhs), and yᵀS²y.
    def gram_step(acc: jax.Array, chunk) -> tuple[jax.Array, None]:
        X_b, y_b, s2_b = chunk
        W_b = _features_real_pair(X_b, M_map, b_map, precision=precision)
        Y_b = jnp.concatenate([W_b, y_b[:, None]], axis=1)
        acc = acc + jnp.dot(Y_b.T * s2_b[None, :], Y_b, precision=precision)
        return acc, None

    with jax.named_scope("gram_stream"):
        G_aug, _ = jax.lax.scan(gram_step, jnp.zeros((M2 + 1, M2 + 1), dtype), (Xc, yc, s2c))
    G = G_aug[:M2, :M2]
    b_vec = G_aug[:M2, M2]  # Wᵀ S² y
    B = embed_from_gram_blocks(G, M)

    inv_c0 = _inv_c0_scale(n, M, dtype)
    inv_c0_id = inv_c0  # Identity-C resolvent scale, kept for the re-solve below.
    lam, Qs, inv_c0 = _eigendecompose(B, C_emb, inv_c0, sign)
    k = jnp.dot(Qs.T, b_vec, precision=precision)

    # Pass 2: γ-sweep objective reduction, feature block rebuilt per chunk.
    r_all = 1.0 / (gammas[None, :] + lam[:, None])  # 2M × G, materialised once.

    def sweep_step(acc, chunk):
        X_b, y_b, s_b, s2_b = chunk
        W_b = _features_real_pair(X_b, M_map, b_map, precision=precision)
        Gu_b = jnp.dot(W_b, Qs, precision=sweep_precision)
        num = inv_c0 * jnp.dot(Gu_b * k[None, :], r_all, precision=sweep_precision)
        lev = inv_c0 * s2_b[:, None] * jnp.dot(Gu_b * Gu_b, r_all, precision=sweep_precision)
        e = (num - y_b[:, None]) / (1.0 - lev)
        e = _clip_classifier_residuals(e, y_b, is_classifier)
        loo_err_b, obj_b = _sweep_objective(e, s_b, is_classifier)
        return (acc[0] + loo_err_b, acc[1] + obj_b), None

    zeros_g = jnp.zeros(gammas.shape[0], dtype)
    with jax.named_scope("gamma_sweep_stream"):
        (loo_errors_gs, objective), _ = jax.lax.scan(
            sweep_step, (zeros_g, zeros_g), (Xc, yc, sc, s2c)
        )
    optimum = jnp.argmin(objective)
    gamma_opt = gammas[optimum]

    # Cholesky re-solve at the optimum (ref :177-178).
    if C_emb is None:
        B_reg = B + (gamma_opt / inv_c0_id) * jnp.eye(M2, dtype=dtype)
    else:
        B_reg = B + gamma_opt * C_emb
    with jax.named_scope("cholesky_resolve"):
        L = jax.scipy.linalg.cholesky(B_reg, lower=True)
    beta_emb = jax.scipy.linalg.cho_solve((L, True), sign * b_vec)

    # Pass 3: per-row LOO statistics and residuals at the optimum.
    r_opt = (1.0 / (gamma_opt + lam))[:, None]
    kr_opt = (k * r_opt[:, 0])[:, None]
    beta_j = sign * beta_emb

    def stats_step(_, chunk):
        X_b, y_b, s2_b = chunk
        W_b = _features_real_pair(X_b, M_map, b_map, precision=precision)
        Gu_b = jnp.dot(W_b, Qs, precision=precision)
        num = inv_c0 * jnp.dot(Gu_b, kr_opt, precision=precision)[:, 0]
        sig2 = inv_c0 * jnp.dot(Gu_b * Gu_b, r_opt, precision=precision)[:, 0]
        lev = s2_b * sig2
        e_raw = (num - y_b) / (1.0 - lev)
        resid = jnp.dot(W_b, beta_j, precision=precision) - y_b
        return None, (e_raw, lev, sig2, resid)

    with jax.named_scope("final_stats_stream"):
        _, (e_raw_c, lev_c, sig2_c, resid_c) = jax.lax.scan(
            stats_step, None, (Xc, yc, s2c)
        )
    e_raw = e_raw_c.reshape(-1)
    lev_opt = lev_c.reshape(-1)
    sigma2 = sig2_c.reshape(-1)
    residuals = _clip_classifier_residuals(resid_c.reshape(-1), y, is_classifier)
    e_clipped = _clip_classifier_residuals(e_raw, y, is_classifier)
    yhat_loo_raw = y + e_raw
    if is_classifier:
        loo_score = s @ (jnp.sign(yhat_loo_raw) == y).astype(dtype)
    else:
        y_mean = s @ y
        loo_score = 1.0 - (s @ (e_raw * e_raw)) / (s @ ((y - y_mean) * (y - y_mean)))
    loo_sigma2 = sigma2 + (s * sigma2) ** 2 / (1.0 - lev_opt)

    return {
        "beta_emb": beta_emb,
        "gamma": gamma_opt,
        "optimum_index": optimum,
        "lam": lam,
        "Qs": Qs,
        "loo_errors_gammas": loo_errors_gs,
        "loo_residuals": e_clipped,
        "loo_yhat": y + e_clipped,
        "loo_leverage": lev_opt,
        "loo_error": loo_errors_gs[optimum],
        "loo_score": loo_score,
        "loo_std": jnp.sqrt(loo_sigma2),
        "residuals": residuals,
    }
