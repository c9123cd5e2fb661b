"""Conformal prediction stack: two-level CQR calibration + quantile/interval serving.

Split out of ``models/estimator.py`` (round-5; no behaviour change): everything the
reference's conformal path does (``_neo_ls_svm.py:489-532`` level fitting,
``:554-624`` quantile combination, ``:636-645`` intervals) lives here as a mixin the
estimator inherits. The level-1/level-2 fits are tiny host-side problems (HiGHS LPs
or the batched smooth Newton); serving has both a host chunked path (X crosses the
wire once per chunk) and a device-resident path (``jax.Array`` in → ``jax.Array``
out, zero round-trips after the one-time plane upload).
"""

from functools import partial
from typing import TYPE_CHECKING, Any, Literal

import jax
import jax.numpy as jnp
import numpy as np
import numpy.typing as npt

from neo_ls_svm_jax.models.cqr import CoherentLinearQuantileRegressor
from neo_ls_svm_jax.models.dual import dual_decision_var
from neo_ls_svm_jax.models.primal import primal_decision_var
from neo_ls_svm_jax.utils.typing import FloatMatrix, FloatTensor
from neo_ls_svm_jax.utils.validation import (
    _check_n_features,
    check_array,
    check_is_fitted,
    is_device_array as _is_device_array,
    is_pandas,
)

if TYPE_CHECKING:  # pandas is an optional I/O convenience, never a runtime dependency.
    import pandas as pd

CONFORMAL_L2_MIN = 128  # Level-2 bias needs ≥ 128 samples (ref :514).


def _coverage_clamped_biases(
    bias_abs: npt.NDArray,
    bias_rel: npt.NDArray,
    quantiles: npt.NDArray,
    priority: str,
) -> tuple[npt.NDArray, npt.NDArray]:
    """Copies of the level-2 biases, clamped outward when coverage has priority.

    ``priority="coverage"`` only allows outward quantile expansion (upper quantiles
    may shift up, lower down — ref ``_neo_ls_svm.py:571-577``); one shared helper so
    the host and device-resident serving paths cannot desynchronise on the rule.
    """
    bias_abs, bias_rel = bias_abs.copy(), bias_rel.copy()
    if priority == "coverage":
        quantiles = np.asarray(quantiles)
        upper, lower = 0.5 <= quantiles, quantiles <= 0.5
        bias_abs[upper] = np.maximum(bias_abs[upper], 0)
        bias_abs[lower] = np.minimum(bias_abs[lower], 0)
        bias_rel[upper] = np.maximum(bias_rel[upper], 0)
        bias_rel[lower] = np.minimum(bias_rel[lower], 0)
    return bias_abs, bias_rel


@partial(jax.jit, static_argnames=("is_regressor",))
def _conformal_quantiles_device(
    yhat: jax.Array,  # (n,) decision-function values
    std: jax.Array,  # (n,) Bayesian predictive std (the nonconformity score)
    beta_abs: jax.Array,  # (F+1, Q) level-1 CQR coefficients, absolute target
    bias_abs: jax.Array,  # (Q,) level-2 bias (coverage-clamped by the caller)
    beta_rel: jax.Array,  # (F+1, Q) level-1 CQR coefficients, relative target
    bias_rel: jax.Array,  # (Q,)
    *,
    is_regressor: bool,
) -> jax.Array:
    """Device-resident conformal combine (ref ``_neo_ls_svm.py:554-624``):
    two tiny matmuls against the fitted CQR planes, the per-row min-dispersion
    choice between absolute and relative corrections, and the recentre on ŷ."""
    abs_yhat = jnp.abs(yhat)
    feats = jnp.stack([std, abs_yhat], axis=1) if is_regressor else std[:, None]
    # Full float32 products: at the default precision NVIDIA GPUs round to TF32.
    hi = jax.lax.Precision.HIGHEST
    pred_abs = jnp.dot(feats, beta_abs[:-1], precision=hi) + (beta_abs[-1] + bias_abs)[None, :]
    pred_rel = jnp.dot(feats, beta_rel[:-1], precision=hi) + (beta_rel[-1] + bias_rel)[None, :]
    delta = jnp.stack([pred_abs, abs_yhat[:, None] * pred_rel], axis=2)  # (n, Q, 2)
    dispersion = jnp.std(delta, axis=1)  # (n, 2)
    pick = jnp.argmin(dispersion, axis=-1)  # ties break to "absolute", like np.argmin
    delta_sel = jnp.take_along_axis(delta, pick[:, None, None], axis=2)[:, :, 0]
    return yhat[:, None] + delta_sel


def _rearranged(values: Any, quantiles: npt.NDArray) -> Any:
    """Sort each row's quantile predictions into the order of their quantile levels.

    The coherent CQR planes are monotone across quantiles on the calibration rows and
    the monotonicity box, but a row outside them can still see two levels cross.
    Rearranging (sorting) the row restores monotone quantiles and never increases the
    pinball loss (Chernozhukov, Fernández-Val & Galichon, 2010). Rows that are already
    monotone are unchanged. Works on NumPy and JAX arrays alike.
    """
    order = np.argsort(np.asarray(quantiles), kind="stable")
    if isinstance(values, jax.Array):
        return values.at[:, order].set(jnp.sort(values[:, order], axis=1))
    out = np.array(values, copy=True)
    out[:, order] = np.sort(values[:, order], axis=1)
    return out


@jax.jit
def _isotonic_proba_device(
    yhat_quantiles: jax.Array,  # (n, Q)
    x_thresholds: jax.Array,
    y_thresholds: jax.Array,
) -> jax.Array:
    """Per-quantile isotonic calibration + class stacking on device.

    ``jnp.interp`` clamps to the end values, matching the host calibrator's
    ``out_of_bounds="clip"`` with y ∈ [0, 1] thresholds. Returns (n, Q, 2)."""
    proba = jax.vmap(lambda col: jnp.interp(col, x_thresholds, y_thresholds), in_axes=1, out_axes=1)(
        yhat_quantiles
    )
    return jnp.stack([1 - proba[:, ::-1], proba], axis=2)


class ConformalMixin:
    """Conformal calibration + quantile/interval prediction for ``NeoLSSVM``.

    Consumes the estimator's fitted calibration attributes (``ŷ_calib_*_``,
    ``nonconformity_calib_*_``, ``residuals_calib_*_``, ``sample_weight_calib_l1_``)
    and its serving primitives (``decision_function``, ``predict_std``, the chunked
    device helpers); provides ``predict_quantiles`` / ``predict_interval``.
    """

    def _primal_decision_var_device(self, X_c: jax.Array) -> jax.Array:
        """ŷ and σ² for one chunk, stacked (n, 2).

        The conformal paths need both; ONE jitted program (``primal_decision_var``)
        means X is uploaded once, the O(n·2M·d) feature block is computed once, and
        the chunk costs a single dispatch."""
        return primal_decision_var(
            X_c,
            self._device("M_map"),
            self._device("b_map"),
            self._device("beta_emb"),
            self._device("Qs"),
            self._device("lam"),
            self._device("gamma"),
            self._device("inv_c0"),
        )

    def _dual_decision_var_device(self, X_c: jax.Array) -> jax.Array:
        """ŷ and σ² for one (dual-transformed) chunk, stacked (n, 2).

        Dual counterpart of :meth:`_primal_decision_var_device`: ONE jitted program
        (``dual_decision_var``) computes the dominant n×n_train RBF block once for
        both heads and costs a single dispatch per chunk."""
        return dual_decision_var(
            X_c,
            self._device("X_train"),
            self._device("alpha"),
            self._device("chol"),
        )

    def _decision_var_in_chunks(self, X: Any, *, device_out: bool) -> Any:
        """Fused ŷ and σ² stacked (n, 2) over row chunks of X.

        The single primal/dual route selection for BOTH conformal serving paths
        (``device_out=True``: validated device-resident X in → device out;
        ``device_out=False``: host X in → one batched host pull) — one definition so
        the host and device lanes cannot desynchronise, mirroring
        ``_coverage_clamped_biases``'s rationale on the combine side.
        """
        if self.primal_:
            if device_out:
                return self._in_chunks(X, self._primal_decision_var_device, device_out=True)
            return self._in_chunks(
                # copy=False: skip the O(n·d) host duplicate when the dtype already
                # matches — this lane is wire-bound and the chunks are read-only.
                X.astype(self._compute_dtype(), copy=False),
                lambda X_c: self._primal_decision_var_device(self._upload_chunk(X_c)),
                device_out=False,
            )
        if device_out:
            return self._in_chunks(
                X,
                lambda X_c: self._dual_decision_var_device(self._device_dual_transform(X_c)),
                device_out=True,
            )
        # Host dual route: the affine dual transform is host-fit state; transform on
        # host, then each chunk crosses the wire once into the fused program.
        return self._in_chunks(
            self.dual_feature_map_.transform(X),
            lambda X_c: self._dual_decision_var_device(jnp.asarray(X_c)),
            device_out=False,
        )

    def _conformal_design(self, target_type: str, level: str = "l1") -> tuple:
        """The (X, y) design of one conformal level for one target type
        (ref ``_neo_ls_svm.py:497-510``): nonconformity score (+ |ŷ| for regressors)
        against the negated (possibly ŷ-relative) calibration residuals."""
        yhat = getattr(self, f"ŷ_calib_{level}_")
        eps = np.finfo(self.ŷ_calib_l1_.dtype).eps
        abs_yhat = np.maximum(np.abs(yhat), eps)
        X = getattr(self, f"nonconformity_calib_{level}_")[:, np.newaxis]
        if self._estimator_type == "regressor":
            X = np.hstack([X, np.abs(yhat[:, np.newaxis])])
        relative = "/ŷ" in target_type
        y = -getattr(self, f"residuals_calib_{level}_") / (abs_yhat if relative else 1)
        return X, y

    def _conformal_level2_bias(
        self,
        cqr_l1: CoherentLinearQuantileRegressor,
        target_type: str,
        quantiles: npt.NDArray,
        X_l1: npt.NDArray,
        y_l1: npt.NDArray,
    ) -> npt.NDArray:
        """Level 2: per-quantile bias on top of the level-1 quantile predictions,
        clipped so coherence survives (ref ``:511-531``)."""
        bias_l2 = np.zeros(quantiles.shape, dtype=self.ŷ_calib_l1_.dtype)
        if len(self.ŷ_calib_l2_) >= CONFORMAL_L2_MIN:
            X_l2, y_l2 = self._conformal_design(target_type, level="l2")
            # reshape: predict squeezes a single-quantile fit to 1-D (reference API
            # contract); the level-2 bias indexes per quantile, so restore (n, Q).
            # The reference crashes here on quantiles=(q,) (IndexError at ref
            # `_neo_ls_svm.py:517`); supporting it is a deliberate superset.
            delta_l2 = cqr_l1.predict(X_l2).reshape(len(X_l2), -1)
            clip = cqr_l1.intercept_clip(np.vstack([X_l1, X_l2]), np.hstack([y_l1, y_l2]))
            for j, quantile in enumerate(quantiles):
                intercept_l2 = np.quantile(y_l2 - delta_l2[:, j], quantile)
                bias_l2[j] = np.clip(intercept_l2, clip[0, j], clip[1, j])
        return bias_l2

    def _fit_conformal_pair(self, quantiles: npt.ArrayLike) -> None:
        """Fit the "Δŷ" and "Δŷ/ŷ" level-1 regressors together (VERDICT r3 #6).

        The two level-1 CQR fits share the design matrix; only the target differs
        (absolute vs ŷ-relative residuals). ``conformal_method="exact"`` (default)
        overlaps the two independent HiGHS LPs through a 2-thread pool (HiGHS
        releases the GIL during the C++ solve), halving the conformal first-call
        latency on multi-core hosts. ``conformal_method="smooth"`` solves BOTH
        problems in ONE vmapped damped-Newton device program
        (:func:`~neo_ls_svm_jax.models.cqr.coherent_linear_quantile_regression_batched`)
        — the on-device path, trading the LP's exact optimum for the smooth
        solver's documented ≤0.5% pinball gap. Subsequent
        :meth:`_lazily_fit_conformal_predictor` calls hit the cache either way.
        """
        key = tuple(np.asarray(quantiles))
        missing = [t for t in ("Δŷ", "Δŷ/ŷ") if key not in self.conformal_l1_[t]]
        if len(missing) < 2:
            # 0 or 1 missing: nothing to batch/overlap; the caller's sequential
            # path fits the stragglers.
            return
        # Materialise the shared calibration attributes BEFORE spawning/batching:
        # the lazy __getattr__ pull must not race between the two fit threads.
        self.ŷ_calib_l1_  # noqa: B018
        if getattr(self, "conformal_method", "exact") == "smooth":
            from neo_ls_svm_jax.models.cqr import (  # noqa: PLC0415
                coherent_linear_quantile_regression_batched,
            )

            quantiles_arr = np.asarray(quantiles)
            X_l1, y_abs = self._conformal_design("Δŷ")
            _, y_rel = self._conformal_design("Δŷ/ŷ")
            X_i = np.hstack([X_l1, np.ones((X_l1.shape[0], 1), dtype=X_l1.dtype)])
            beta, beta_full = coherent_linear_quantile_regression_batched(
                X_i,
                np.stack([y_abs, y_rel]),
                quantiles=quantiles_arr.astype(y_abs.dtype),
                sample_weight=self.sample_weight_calib_l1_,
            )
            for t, (target_type, y_t) in enumerate((("Δŷ", y_abs), ("Δŷ/ŷ", y_rel))):
                cqr = CoherentLinearQuantileRegressor(
                    quantiles=quantiles_arr, method="smooth"
                )
                cqr.n_features_in_ = X_l1.shape[1]
                cqr.y_dtype_ = y_t.dtype
                cqr.β_, cqr.β_full_ = beta[t], beta_full[t]
                self.conformal_l1_[target_type][key] = cqr
                self.conformal_l2_[target_type][key] = self._conformal_level2_bias(
                    cqr, target_type, quantiles_arr, X_l1, y_t
                )
            return
        from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = [
                pool.submit(self._lazily_fit_conformal_predictor, t, quantiles)
                for t in missing
            ]
            for future in futures:
                future.result()

    def _lazily_fit_conformal_predictor(
        self, target_type: str, quantiles: npt.ArrayLike
    ) -> tuple[CoherentLinearQuantileRegressor, npt.NDArray]:
        """Fit-or-fetch the two conformal levels for a quantile tuple (ref ``:489-532``)."""
        quantiles = np.asarray(quantiles)
        key = tuple(quantiles)
        if key in self.conformal_l1_[target_type]:
            return self.conformal_l1_[target_type][key], self.conformal_l2_[target_type][key]
        X_l1, y_l1 = self._conformal_design(target_type)
        cqr_l1 = CoherentLinearQuantileRegressor(
            quantiles=quantiles, method=getattr(self, "conformal_method", "exact")
        )
        cqr_l1.fit(X_l1, y_l1, sample_weight=self.sample_weight_calib_l1_)
        self.conformal_l1_[target_type][key] = cqr_l1
        bias_l2 = self._conformal_level2_bias(cqr_l1, target_type, quantiles, X_l1, y_l1)
        self.conformal_l2_[target_type][key] = bias_l2
        return cqr_l1, bias_l2

    def _conformal_device_params(
        self, quantiles: npt.NDArray, priority: str
    ) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
        """Stage the fitted conformal planes on device, once per (quantiles, priority).

        The level-1/level-2 fits themselves stay host-side (two tiny HiGHS LPs, fit
        lazily once per quantile tuple, ref ``:489-532``); what serving needs from them
        is only the (F+1)×Q coefficient planes and the Q biases, uploaded here in ONE
        batched transfer and cached so steady-state serving never touches the host.
        """
        key = ("conformal_dev", tuple(float(q) for q in quantiles), priority)
        cache = self.__dict__.setdefault("_device_cache", {})
        if key not in cache:
            self._fit_conformal_pair(quantiles)
            cqr_abs, bias_abs = self._lazily_fit_conformal_predictor("Δŷ", quantiles)
            cqr_rel, bias_rel = self._lazily_fit_conformal_predictor("Δŷ/ŷ", quantiles)
            bias_abs, bias_rel = _coverage_clamped_biases(
                bias_abs, bias_rel, quantiles, priority
            )
            dtype = self._compute_dtype()
            cache[key] = jax.device_put(
                tuple(
                    np.asarray(a, dtype)
                    for a in (cqr_abs.β_, bias_abs, cqr_rel.β_, bias_rel)
                )
            )
        return cache[key]

    def _predict_quantiles_device(
        self, X: jax.Array, quantiles: npt.NDArray, priority: str
    ) -> jax.Array:
        """Device-resident quantile serving: ``jax.Array`` in → ``jax.Array`` out.

        Same jax.Array contract as :meth:`decision_function` (ref path:
        ``_neo_ls_svm.py:554-624``): after the one-time conformal fit + upload, a call
        is ONE fused chunked device program for both conformal inputs (ŷ and σ share
        the dominant feature/kernel block — the same fusion the host path uses) plus
        one fused combine — zero device→host round-trips. Regressors return
        (n, |quantiles|); classifiers return the (n, |quantiles|, 2) calibrated
        probability tensor.
        """
        X_d = self._validate_device_X(X)
        beta_abs, bias_abs, beta_rel, bias_rel = self._conformal_device_params(
            quantiles, priority
        )
        both = self._decision_var_in_chunks(X_d, device_out=True)
        yhat = both[:, 0]
        std = jnp.sqrt(jnp.maximum(both[:, 1], 0.0))
        yhat_quantiles = _conformal_quantiles_device(
            yhat,
            std,
            beta_abs,
            bias_abs,
            beta_rel,
            bias_rel,
            is_regressor=self._estimator_type == "regressor",
        )
        yhat_quantiles = _rearranged(yhat_quantiles, quantiles)
        if self._estimator_type == "classifier":
            x_thr, y_thr = self._iso_thresholds_device(yhat.dtype)
            return _isotonic_proba_device(yhat_quantiles, x_thr, y_thr)
        return yhat_quantiles

    def predict_quantiles(
        self,
        X: "FloatMatrix | pd.DataFrame",
        *,
        quantiles: npt.ArrayLike = (0.025, 0.5, 0.975),
        priority: Literal["accuracy", "coverage"] = "accuracy",
    ) -> "FloatMatrix | FloatTensor | pd.DataFrame":
        """Predict conformally calibrated quantiles (ref ``:554-624``).

        A ``jax.Array`` input stays resident: the calibrated quantiles (or the
        classifier probability tensor) come back as a ``jax.Array`` with no host
        round-trip (see :meth:`_predict_quantiles_device`).
        """
        check_is_fitted(self, ["γ_"])
        if _is_device_array(X):
            return self._predict_quantiles_device(X, np.asarray(quantiles), priority)
        X_df = X
        X = _check_n_features(self, check_array(X, dtype=(np.float64, np.float32)))
        # One fused chunk pass computes both conformal inputs (ŷ and σ), so X is
        # uploaded once (VERDICT r3 #6 follow-up; previously two separate uploads).
        both = self._decision_var_in_chunks(X, device_out=False)
        yhat = both[:, 0]
        X_cqr = np.sqrt(np.maximum(both[:, 1], 0.0))[:, np.newaxis]
        if self._estimator_type == "regressor":
            X_cqr = np.hstack([X_cqr, np.abs(yhat[:, np.newaxis])])
        self._fit_conformal_pair(quantiles)
        cqr_abs, bias_abs = self._lazily_fit_conformal_predictor("Δŷ", quantiles)
        cqr_rel, bias_rel = self._lazily_fit_conformal_predictor("Δŷ/ŷ", quantiles)
        quantiles = np.asarray(quantiles)
        bias_abs, bias_rel = _coverage_clamped_biases(bias_abs, bias_rel, quantiles, priority)
        delta_quantiles = np.dstack(
            [
                cqr_abs.predict(X_cqr) + bias_abs[np.newaxis, :],
                np.abs(yhat[:, np.newaxis]) * (cqr_rel.predict(X_cqr) + bias_rel[np.newaxis, :]),
            ]
        )
        # Per-row choice between absolute and relative conformal corrections: pick the
        # one with the least dispersion across quantiles (ref :584-589).
        dispersion = np.std(delta_quantiles, axis=1)
        delta_quantiles = delta_quantiles[
            np.arange(delta_quantiles.shape[0]), :, np.argmin(dispersion, axis=-1)
        ]
        yhat_quantiles: npt.NDArray = _rearranged(yhat[:, np.newaxis] + delta_quantiles, quantiles)
        if self._estimator_type == "classifier":
            yhat_quantiles = np.hstack(
                [
                    self.predict_proba_calibrator_.transform(yhat_quantiles[:, j])[:, np.newaxis]
                    for j in range(yhat_quantiles.shape[1])
                ]
            )
            yhat_quantiles = np.dstack([1 - yhat_quantiles[:, ::-1], yhat_quantiles])
        if self._estimator_type == "regressor" and not np.issubdtype(self.y_dtype_, np.integer):
            yhat_quantiles = yhat_quantiles.astype(self.y_dtype_)
        if is_pandas(X_df):
            try:
                import pandas as pd
            except ImportError:
                return yhat_quantiles
            if self._estimator_type == "regressor":
                out = pd.DataFrame(yhat_quantiles, index=X_df.index, columns=quantiles)
            else:
                neg = pd.DataFrame(yhat_quantiles[:, :, 0], index=X_df.index, columns=quantiles)
                pos = pd.DataFrame(yhat_quantiles[:, :, 1], index=X_df.index, columns=quantiles)
                out = pd.concat(
                    [neg, pos], axis=0, keys=self.classes_, names=["class", X_df.index.name]
                )
            out.columns.name = "quantile"
            return out
        return yhat_quantiles

    def predict_interval(
        self, X: "FloatMatrix | pd.DataFrame", *, coverage: float = 0.95
    ) -> "FloatMatrix | FloatTensor | pd.DataFrame":
        """Predict conformally calibrated intervals (ref ``:636-645``)."""
        lb = (1 - coverage) / 2
        return self.predict_quantiles(X, quantiles=(lb, 1 - lb), priority="coverage")
