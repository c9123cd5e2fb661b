"""Supervised affine pre-transform stack.

Re-implements the reference's inheritance chain ``AffineFeatureMap`` →
``AffineNormalizer`` → ``AffineSeparator`` (ref ``_affine_feature_map.py``,
``_affine_normalizer.py``, ``_affine_separator.py``) with a host-fit / device-transform
split: *fitting* is data-dependent-shape host NumPy (target binning produces a variable
number of bins, the separator's SVD rank cut is data-dependent — exactly the parts the
reference runs outside BLAS), while *transforms* are linear maps that fold into the
downstream feature map and run on the device as part of one fused matmul
(see :meth:`AffineFeatureMap.linear_form`).

RNG parity: the separator draws its edge samples from ``np.random.RandomState`` in the
same call order as the reference, so fitted parameters match bit-for-bit for a given
``random_state``.
"""

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import numpy.typing as npt

from neo_ls_svm_jax.ops.quantizer import sample_bins_quantized_ecdf
from neo_ls_svm_jax.ops.weighted_quantile import weighted_quantile
from neo_ls_svm_jax.utils.base import BaseEstimator, TransformerMixin
from neo_ls_svm_jax.utils.validation import (
    check_array,
    check_consistent_length,
    check_random_state,
    check_X_y,
)


def squared_distances(X: npt.NDArray, Y: npt.NDArray) -> npt.NDArray:
    """Pairwise squared Euclidean distances between rows of X and Y (host NumPy).

    Matmul-based expansion as in the reference (``_affine_separator.py:16-21``); the
    on-device counterpart lives in :mod:`neo_ls_svm_jax.ops.kernels`.
    """
    return (
        np.sum(X * X, axis=1, keepdims=True)
        - 2 * X @ Y.T
        + np.sum(Y * Y, axis=1, keepdims=True).T
    )


def nearest_neighbours(X: npt.NDArray, Y: npt.NDArray) -> npt.NDArray:
    """For each row of X, the nearest row of Y (ref ``_affine_separator.py:24-29``)."""
    idx = np.argmin(squared_distances(X, Y), axis=1, keepdims=True)
    return np.take_along_axis(Y, idx, axis=0)


def right_singular_vectors(X: npt.NDArray) -> tuple[npt.NDArray, npt.NDArray]:
    """Singular values and right singular vectors via the smaller-side Gram eigh.

    Equivalent to ``np.linalg.svd(X)[1:]`` transposed, but eigendecomposes whichever of
    XᵀX / XXᵀ is smaller (ref ``_faster_svd``, ``_affine_separator.py:32-51``).
    """
    if X.shape[0] >= X.shape[1]:
        e, V = np.linalg.eigh(X.conj().T @ X)
        s = np.sqrt(np.abs(e))[::-1]
        V = V[:, ::-1]
    else:
        e, U = np.linalg.eigh(X @ X.conj().T)
        s = np.sqrt(np.abs(e))[::-1]
        U = U[:, ::-1]
        keep = s > 0
        s, U = s[keep], U[:, keep]
        V = (X.conj().T @ U) / s[np.newaxis, :]
    return s, V


class AffineFeatureMap(BaseEstimator, TransformerMixin):
    """Parametrised affine feature map ``x ↦ (x - shift) @ diag(1/scale) @ A``.

    With ``append_features=True`` and an ``A``, the transformed features are appended to
    the input features (ref ``_affine_feature_map.py:17-25``).
    """

    def __init__(
        self,
        *,
        scale: Any,
        shift: Any,
        A: npt.NDArray | None = None,
        append_features: bool = False,
    ):
        self.scale = scale
        self.shift = shift
        self.A = A
        self.append_features = append_features

    def _effective_params(self, num_features: int) -> tuple[npt.NDArray, npt.NDArray, Any]:
        scale = np.reshape(getattr(self, "scale_", self.scale), (-1, num_features))
        shift = np.reshape(getattr(self, "shift_", self.shift), (-1, num_features))
        A = getattr(self, "A_", self.A)
        return scale, shift, A

    def fit(
        self,
        X: npt.NDArray,
        y: npt.NDArray | None = None,
        sample_weight: npt.NDArray | None = None,
    ) -> "AffineFeatureMap":
        """Validate the (given or learned) parameters against X; no learning here."""
        X = check_array(X)
        self.n_features_in_ = X.shape[1]
        scale, shift, A = self._effective_params(X.shape[1])
        assert scale.dtype == shift.dtype, "The scale and shift must have the same dtype"
        assert not np.any(scale == 0), "The scale may not be zero"
        assert np.all(np.isfinite(scale)), "The scale must be finite"
        assert np.all(np.isfinite(shift)), "The shift must be finite"
        assert X.shape[1] == scale.shape[1], "The scale must match the number of features"
        assert X.shape[1] == shift.shape[1], "The shift must match the number of features"
        if A is not None:
            assert A.dtype == scale.dtype, "A must share the scale/shift dtype"
            assert X.shape[1] == A.shape[0], "A must have one row per feature of X"
            assert np.all(np.isfinite(A)), "The matrix A must be finite"
        return self

    def linear_form(self, num_features: int) -> tuple[npt.NDArray | None, npt.NDArray, npt.NDArray]:
        """Return ``(M, offset, inv_scale)`` so the map is ``X @ M + offset`` when ``M``
        is not None, else ``(X - shift) * inv_scale``.

        This is what gets folded into the downstream random-features matmul so the whole
        pre-transform rides a single matmul on device.
        """
        scale, shift, A = self._effective_params(num_features)
        if A is None:
            return None, shift, 1.0 / scale
        M = A / scale.T
        offset = -shift @ M
        return M, offset, 1.0 / scale

    def transform(self, X: npt.NDArray) -> npt.NDArray:
        """Apply the affine map (host path; the device path uses ``linear_form``)."""
        X = check_array(X)
        scale, shift, A = self._effective_params(X.shape[1])
        if A is None:
            out = (X - shift) / scale
        elif A.shape[1] < A.shape[0]:
            # Tall A: scale/shift folded into A to avoid materialising (X - shift).
            out = X @ (A / scale.T) - shift @ (A / scale.T)
        else:
            out = (X - shift) @ (A / scale.T)
        out = out.astype(X.dtype)
        if self.append_features and A is not None:
            out = np.hstack((X, out))
        return out

    @property
    def pseudo_inverse(self) -> npt.NDArray | None:
        """Pseudo-inverse of the effective transformation matrix A (lazily cached)."""
        A = getattr(self, "A_", self.A)
        if A is None:
            return None
        cached = getattr(self, "_pseudo_inverse_cache", None)
        if cached is None or cached[0] is not A:
            cached = (A, np.linalg.pinv(A))
            self._pseudo_inverse_cache = cached
        return cached[1]

    def inverse_transform(self, X_transformed: npt.NDArray) -> npt.NDArray:
        """Approximately invert this transformation."""
        X = check_array(X_transformed)
        A = getattr(self, "A_", self.A)
        num_features = X.shape[1] if A is None else A.shape[0]
        scale, shift, A = self._effective_params(num_features)
        if self.append_features and A is not None:
            return X[:, : A.shape[0]]
        if A is not None:
            X = X @ self.pseudo_inverse
        return (X * scale + shift).astype(X.dtype)

    def get_feature_names_out(
        self, input_features: npt.ArrayLike | None = None
    ) -> npt.NDArray[np.object_]:
        """Get output feature names for the transformation."""
        A = getattr(self, "A_", self.A)
        if input_features is None:
            n = getattr(self, "n_features_in_", A.shape[0] if A is not None else 1)
            input_features = [f"x{j}" for j in range(n)]
        feats = np.asarray(input_features, dtype=object)
        if A is None:
            out = np.array([f"{f}_shifted_scaled" for f in feats], dtype=object)
        else:
            joined = ",".join(str(f) for f in feats)
            out = np.array([f"{joined}_affine_map"] * A.shape[1], dtype=object)
        if self.append_features and A is not None:
            out = np.hstack((feats, out))
        return out


class AffineNormalizer(AffineFeatureMap):
    """Supervised affine normalizer: learns per-feature shift and scale so that the
    difference between samples from two target bins equals the bins' separability.

    For every pair of target bins (i, j) with weighted-median centres μ and weighted
    mean-absolute-deviations σ, the optimal threshold ``μᵢ + α(μⱼ-μᵢ)`` with
    ``α = clip(σᵢ/(σᵢ+σⱼ))`` and the spread ``σᵢ+σⱼ`` are accumulated with weight
    ``√((nᵢ+nⱼ)(0.5 + |μⱼ-μᵢ|/(σᵢ+σⱼ)))`` (ref ``_affine_normalizer.py:50-117``).
    """

    def __init__(self, *, append_features: bool = False) -> None:
        self.shift = 0.0
        self.scale = 1.0
        self.A = None
        self.append_features = append_features

    def fit(
        self,
        X: npt.NDArray,
        y: npt.NDArray | None = None,
        sample_weight: npt.NDArray | None = None,
    ) -> "AffineFeatureMap":
        """Learn the shift and scale from binned targets."""
        X, y = check_X_y(X, y)
        y = np.ravel(np.asarray(y)).astype(X.dtype)
        weights = (
            np.ones(y.shape) if sample_weight is None else np.ravel(np.asarray(sample_weight))
        ).astype(y.dtype)
        check_consistent_length(y, weights)
        bins, bin_weights, bin_probs, codes = _bin_by_target(y, weights)
        if getattr(self, "_want_bin_cache", False):
            # Hand the binning to the subclass fit (the separator) so the target is
            # quantized once per fit, not once per class in the inheritance chain.
            self._bin_cache = (bins, bin_weights, bin_probs, codes)
        d = X.shape[1]
        if len(bins) <= 1:
            self.shift_ = np.zeros((1, d), dtype=X.dtype)
            self.scale_ = np.ones((1, d), dtype=X.dtype)
            super().fit(X, y, weights)
            return self
        device_hint = getattr(self, "_device_X_hint", None)
        # _stats_host_only: set by callers that manage device placement themselves
        # (e.g. the estimator's mesh route stages X *sharded*; uploading the full
        # matrix to one chip here would duplicate the transfer and the memory).
        use_device = (
            not getattr(self, "_stats_host_only", False)
            and X.shape[0] >= _device_stats_threshold(hinted=device_hint is not None)
        )
        if use_device:
            self.shift_, self.scale_ = _normalizer_fit_device(
                X, bin_weights, weights, codes, X_device=device_hint
            )
            super().fit(X, y, weights)
            return self
        centers = []
        spreads = []
        for mask, probs in zip(bins, bin_probs):
            X_bin = X[mask]  # gather once; both statistics read the same block
            mu = weighted_quantile(X_bin, probs.T, 0.5, axis=0)
            centers.append(mu)
            spreads.append(probs @ np.abs(X_bin - mu))
        sign = np.zeros((1, d), dtype=X.dtype)
        total_w = np.zeros((1, d), dtype=X.dtype)
        self.shift_ = np.zeros((1, d), dtype=X.dtype)
        self.scale_ = np.zeros((1, d), dtype=X.dtype)
        for i in range(len(centers) - 1):
            for j in range(i + 1, len(centers)):
                diff_mu = centers[j] - centers[i]
                sum_sigma = np.maximum(spreads[i] + spreads[j], np.finfo(X.dtype).eps)
                separability = np.abs(diff_mu) / sum_sigma
                w = np.sqrt((bin_weights[i] + bin_weights[j]) * (0.5 + separability))
                alpha = np.clip(spreads[i] / sum_sigma, 1e-6, 1.0 - 1e-6)
                self.shift_ = self.shift_ + w * (centers[i] + alpha * diff_mu)
                self.scale_ = self.scale_ + w * sum_sigma
                sign += w * np.sign(diff_mu)
                total_w += w
        sign /= total_w
        self.shift_ = self.shift_ / total_w
        self.scale_ = self.scale_ / total_w
        flip = np.sign(sign) < 0
        self.scale_[flip] = -self.scale_[flip]
        super().fit(X, y, weights)
        return self


def _bin_by_target(
    y: npt.NDArray, weights: npt.NDArray
) -> tuple[list[npt.NDArray], list[np.floating], list[npt.NDArray], npt.NDArray]:
    """Quantize y into bins; return per-bin masks, total weights, normalised weights,
    and the dense 0-based bin codes."""
    y_quantized = sample_bins_quantized_ecdf(y)
    lo = np.min(y_quantized)
    masks = [y_quantized == i for i in range(lo, np.max(y_quantized) + 1)]
    totals = [np.sum(weights[m]) for m in masks]
    probs = [weights[np.newaxis, m] / np.sum(weights[m]) for m in masks]
    return masks, totals, probs, (y_quantized - lo).astype(np.int32)


# Above this row count the normalizer computes its per-bin statistics on device even
# when it has to upload X itself (the upload then costs less than the host argsorts it
# replaces). When the estimator has *already* staged X on device for the solver, the
# hinted threshold applies instead and the device path kicks in much earlier. The
# device path is numerically equivalent but not bit-identical to the host path
# (summation order), so parity tests and small fits always take the host path.
DEVICE_STATS_MIN_ROWS = 1_000_000
DEVICE_STATS_HINTED_MIN_ROWS = 65_536


def _device_stats_threshold(hinted: bool) -> float:
    return DEVICE_STATS_HINTED_MIN_ROWS if hinted else DEVICE_STATS_MIN_ROWS


def _float_to_ordered_int(x: jax.Array) -> jax.Array:
    """Map finite floats to integers with the same total order (IEEE-754 bit trick).

    Non-negative floats compare like their (sign-preserving) bit patterns; negative
    floats compare in reverse, fixed by reflecting them below zero. ±0.0 collide —
    which is correct, they are equal as floats.
    """
    int_dtype = jnp.int64 if x.dtype == jnp.float64 else jnp.int32
    bits = jax.lax.bitcast_convert_type(x, int_dtype)
    return jnp.where(bits >= 0, bits, jnp.iinfo(int_dtype).min - bits)


def _ordered_int_to_float(o: jax.Array, dtype: Any) -> jax.Array:
    int_dtype = jnp.int64 if dtype == jnp.float64 else jnp.int32
    bits = jnp.where(o >= 0, o, jnp.iinfo(int_dtype).min - o)
    return jax.lax.bitcast_convert_type(bits, dtype)


def grouped_weighted_median(
    X: jax.Array,  # (n, d)
    w: jax.Array,  # (n,) nonnegative; 0 excludes a row
    codes: jax.Array,  # (n,) int32 bin codes; codes >= num_bins are excluded
    num_bins: int,
) -> jax.Array:
    """(num_bins, d) weighted medians per (bin, column) — sort-free.

    Same averaged lower/upper ECDF convention as :func:`weighted_quantile` (ref
    ``_weighted_quantile.py:56-75``), reconstructed from run-boundary masses instead
    of per-entry cumulative sums: a ~34-step bisection in float-bit space finds, per
    (bin, column), the smallest member value v_hi whose cumulative weight reaches half
    the bin mass; the two ECDF interpolations then only need mass(<v_hi), mass(≤v_hi),
    the run count at v_hi, and the neighbouring member values. All bin-grouped masses
    are one-hot matmuls, so the whole computation is O(iters·n·d) elementwise
    work plus tiny (B×n)@(n×d) contractions — no O(B·n_max·d) padded gather and no
    device sort. Within a tie run the entry weight is taken as the run average, which
    coincides with any sort order for uniform weights (sort tie order is unspecified
    in both the host and previous device paths anyway).
    """
    n, d = X.shape
    compute = X.dtype
    onehot = (codes[:, None] == jnp.arange(num_bins, dtype=codes.dtype)[None, :]).astype(compute)
    w_oh = onehot * w[:, None].astype(compute)  # (n, B) per-bin weighted indicator
    W = jnp.sum(w_oh, axis=0)  # (B,)
    t = 0.5 * W
    xo = _float_to_ordered_int(X)  # (n, d) ordered ints, same width as the dtype
    int_dtype = xo.dtype
    lo = jnp.full((num_bins, d), jnp.iinfo(int_dtype).min, int_dtype)
    hi = jnp.full((num_bins, d), jnp.iinfo(int_dtype).max, int_dtype)
    num_iters = 65 if X.dtype == jnp.float64 else 33

    def body(_, state):
        lo, hi = state
        # Overflow-safe floor average: the ordered ints span the full integer range.
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        mid_rows = mid[jnp.clip(codes, 0, num_bins - 1)]  # (n, d); invalid rows w=0
        le = (xo <= mid_rows).astype(compute)
        mass = jax.lax.dot_general(
            w_oh,
            le,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=compute,
        )  # (B, d)
        ge = mass >= t[:, None]
        return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

    lo, hi = jax.lax.fori_loop(0, num_iters, body, (lo, hi))
    v_hi = _ordered_int_to_float(hi, X.dtype)  # (B, d) crossing member value

    # Final boundary masses in f64: mass_le - mass_lt is a single entry's weight, a
    # catastrophic cancellation of two ~W/2-sized sums in f32 at large n.
    acc = jnp.float64 if jax.config.read("jax_enable_x64") else compute
    hi_rows = hi[jnp.clip(codes, 0, num_bins - 1)]
    le = (xo <= hi_rows).astype(acc)
    lt = (xo < hi_rows).astype(acc)
    w_oh_acc = w_oh.astype(acc)
    dims = (((0,), (0,)), ((), ()))
    mass_le = jax.lax.dot_general(w_oh_acc, le, dims, preferred_element_type=acc)
    mass_lt = jax.lax.dot_general(w_oh_acc, lt, dims, preferred_element_type=acc)
    cnt_run = jax.lax.dot_general(
        onehot.astype(acc), le - lt, dims, preferred_element_type=acc
    )
    # Neighbouring member values around the v_hi run, per bin (B is small: unrolled
    # masked reductions instead of scatter).
    neg_inf = jnp.asarray(-jnp.inf, compute)
    pos_inf = jnp.asarray(jnp.inf, compute)

    def neighbours(b, state):
        v_lo_all, v_next_all = state
        in_bin = (codes == b) & (w > 0)
        below = in_bin[:, None] & (xo < hi[b][None, :])
        above = in_bin[:, None] & (xo > hi[b][None, :])
        v_lo_b = jnp.max(jnp.where(below, X, neg_inf), axis=0)
        v_next_b = jnp.min(jnp.where(above, X, pos_inf), axis=0)
        return v_lo_all.at[b].set(v_lo_b), v_next_all.at[b].set(v_next_b)

    v_lo, v_next = jax.lax.fori_loop(
        0,
        num_bins,
        neighbours,
        (jnp.full((num_bins, d), neg_inf), jnp.full((num_bins, d), pos_inf)),
    )
    t_acc = t.astype(acc)[:, None]
    w_edge = (mass_le - mass_lt) / jnp.maximum(cnt_run, 1.0)
    safe_edge = jnp.maximum(w_edge, jnp.finfo(acc).tiny)
    has_lower = mass_lt > 0
    has_next = (W.astype(acc)[:, None] - mass_le) > 0
    v_hi_acc = v_hi.astype(acc)
    # interp(t, p_upper, v): crossing interval is (mass_lt, mass_lt + w_edge] between
    # the last member below the run and the run's first entry; beyond it → v_hi.
    frac_u = (t_acc - mass_lt) / safe_edge
    upper = jnp.where(
        (~has_lower) | (frac_u >= 1.0),
        v_hi_acc,
        v_lo.astype(acc) + frac_u * (v_hi_acc - v_lo.astype(acc)),
    )
    # interp(t, p_lower, v): crossing interval is (mass_le - w_edge, mass_le] between
    # the run's last entry and the next member above; before it → v_hi.
    frac_l = (t_acc - (mass_le - w_edge)) / safe_edge
    lower = jnp.where(
        (~has_next) | (frac_l <= 0.0),
        v_hi_acc,
        v_hi_acc + frac_l * (v_next.astype(acc) - v_hi_acc),
    )
    return (0.5 * (upper + lower)).astype(X.dtype)


@partial(jax.jit, static_argnames=("num_bins",))
def _normalizer_stats_device(
    X_dev: jax.Array,  # (n_pad, d_pad) feature rows (padding rows/cols are zeros)
    w_dev: jax.Array,  # (n_pad,) sample weights, 0 on padding rows
    codes_dev: jax.Array,  # (n_pad,) int32 bin codes; padding rows carry code >= num_bins
    bin_totals: jax.Array,  # (num_bins,) total bin weights (0 for padded bins)
    *,
    num_bins: int,
) -> tuple[jax.Array, jax.Array]:
    """Per-bin weighted medians/MADs and the pairwise shift/scale accumulation.

    Device counterpart of the host loop in :meth:`AffineNormalizer.fit` (itself
    mirroring ref ``_affine_normalizer.py:80-114``): medians come from the sort-free
    bisection in :func:`grouped_weighted_median`, the mean absolute deviations from
    one one-hot matmul, and the O(B²) bin-pair accumulation is a masked broadcast.
    Only ``num_bins`` is a compile-time shape (bucketed by the caller).
    """
    eps = jnp.finfo(X_dev.dtype).eps
    bin_valid = bin_totals > 0  # (B,)
    med = grouped_weighted_median(X_dev, w_dev, codes_dev, num_bins)  # (B, d)
    med = jnp.where(bin_valid[:, None], med, 0.0)  # scrub empty-bin values before reuse
    codes_safe = jnp.clip(codes_dev, 0, num_bins - 1)
    onehot = (
        codes_dev[:, None] == jnp.arange(num_bins, dtype=codes_dev.dtype)[None, :]
    ).astype(X_dev.dtype)
    w_oh = onehot * w_dev[:, None]
    w_sum = jnp.maximum(jnp.sum(w_oh, axis=0), eps)  # (B,)
    abs_dev = jnp.abs(X_dev - med[codes_safe])  # (n, d)
    sigma = jax.lax.dot_general(
        w_oh,
        abs_dev,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=X_dev.dtype,
    )
    sigma = sigma / w_sum[:, None]
    # Pairwise accumulation over valid bins i < j.
    B = med.shape[0]
    diff = med[None, :, :] - med[:, None, :]  # (i, j, d): μⱼ - μᵢ
    sum_sigma = jnp.maximum(sigma[:, None, :] + sigma[None, :, :], eps)
    separability = jnp.abs(diff) / sum_sigma
    pair_tot = bin_totals[:, None, None] + bin_totals[None, :, None]
    w_pair = jnp.sqrt(pair_tot * (0.5 + separability))
    alpha = jnp.clip(sigma[:, None, :] / sum_sigma, 1e-6, 1.0 - 1e-6)
    pair_valid = (
        (jnp.arange(B)[:, None] < jnp.arange(B)[None, :])
        & bin_valid[:, None]
        & bin_valid[None, :]
    )[:, :, None]
    w_pair = jnp.where(pair_valid, w_pair, 0.0)
    shift = jnp.sum(w_pair * (med[:, None, :] + alpha * diff), axis=(0, 1))
    scale = jnp.sum(w_pair * sum_sigma, axis=(0, 1))
    sign = jnp.sum(w_pair * jnp.sign(diff), axis=(0, 1))
    total_w = jnp.sum(w_pair, axis=(0, 1))
    shift = shift / total_w
    scale = scale / total_w
    scale = jnp.where(jnp.sign(sign / total_w) < 0, -scale, scale)
    return shift, scale


def _normalizer_fit_device(
    X: npt.NDArray,
    bin_totals: "list[np.floating] | npt.NDArray",
    weights: npt.NDArray,
    codes: npt.NDArray,
    X_device: jax.Array | None = None,
) -> tuple[npt.NDArray, npt.NDArray]:
    """Stage the bin codes/weights and run the device statistics.

    ``bin_totals`` are the per-bin weight sums the caller already computed during
    binning (recomputing them from masks would be a redundant O(B·n) host pass on
    the critical path). ``X_device`` reuses an already-staged device copy of X
    (possibly row/column padded with zeros) so no second host→device transfer of the
    feature matrix is needed; only the O(n) codes/weights ride up, in one batched
    transfer. The bin count is the only compile-time shape (bucketed to a multiple
    of 4).
    """
    n, d = X.shape
    bin_totals = np.asarray(bin_totals, dtype=X.dtype)
    B = len(bin_totals)
    B_pad = -(-B // 4) * 4
    totals_pad = np.zeros(B_pad, dtype=X.dtype)
    totals_pad[:B] = bin_totals
    if X_device is None:
        X_device = jnp.asarray(X)
    n_dev = X_device.shape[0]
    codes_p = np.full(n_dev, B_pad, dtype=np.int32)
    codes_p[:n] = codes
    w_p = np.zeros(n_dev, dtype=X.dtype)
    w_p[:n] = weights
    # One batched transfer for the three O(n) operands.
    w_d, codes_d, totals_d = jax.device_put((w_p, codes_p, totals_pad))
    shift, scale = _normalizer_stats_device(
        X_device,
        w_d,
        codes_d,
        totals_d,
        num_bins=B_pad,
    )
    shift_np, scale_np = jax.device_get((shift, scale))
    return (
        shift_np[:d].reshape(1, -1).astype(X.dtype),
        scale_np[:d].reshape(1, -1).astype(X.dtype),
    )


class AffineSeparator(AffineNormalizer):
    """Affine separator: learns the matrix A that optimally separates target bins.

    After normalising with the inherited shift/scale, each bin's edge is located by two
    rounds of nearest-neighbour search between weighted samples of the bin and its
    complement; the leading right singular vectors of the edge differences become that
    bin's block of A, and a global rescale λ = √(2·log(f/g)/(f−g)) tunes A for Gaussian
    kernels, where f/g are mean inter-/intra-bin edge distances
    (ref ``_affine_separator.py:54-210``; λ derivation at ``:75-87``).
    """

    def __init__(
        self,
        *,
        append_features: bool = False,
        rank_threshold: float = 2e-2,
        edge_sample_size: int = 384,
        edge_search_multiplier: int = 4,
        random_state: Any = 42,
    ) -> None:
        self.shift = 0.0
        self.scale = 1.0
        self.A = None
        self.append_features = append_features
        self.rank_threshold = rank_threshold
        self.edge_sample_size = edge_sample_size
        self.edge_search_multiplier = edge_search_multiplier
        self.random_state = random_state

    def fit(
        self,
        X: npt.NDArray,
        y: npt.NDArray | None = None,
        sample_weight: npt.NDArray | None = None,
    ) -> "AffineFeatureMap":
        """Learn shift, scale, and the separating matrix A."""
        assert y is not None
        X, y = check_X_y(X, y)
        y = np.ravel(np.asarray(y)).astype(X.dtype)
        # Learn the shift/scale (reusing its target binning), then work on the
        # normalised features.
        self._want_bin_cache = True
        try:
            AffineNormalizer.fit(self, X, y, sample_weight)
        finally:
            del self._want_bin_cache
        masks, bin_weights, bin_probs, _codes = self.__dict__.pop("_bin_cache")
        weights = (
            np.ones(y.shape) if sample_weight is None else np.ravel(np.asarray(sample_weight))
        ).astype(y.dtype)
        check_consistent_length(y, weights)
        if len(masks) <= 1:
            return self
        # Gather-then-normalize: the separator only ever touches O(B·ess) sampled rows,
        # so the shift/scale map is applied to those rows instead of materialising the
        # full normalised n×d matrix on the host (bitwise-identical per element).
        shift = np.reshape(self.shift_, (1, -1)).astype(X.dtype)
        scale = np.reshape(self.scale_, (1, -1)).astype(X.dtype)

        def _normalized_rows(rows: npt.NDArray) -> npt.NDArray:
            return ((X[rows, :] - shift) / scale).astype(X.dtype)
        # With only two bins each bin's complement is the other bin; spend the sample
        # budget accordingly (ref _affine_separator.py:138-139). Unlike the reference we
        # do not mutate the constructor parameter.
        ess = self.edge_sample_size
        if len(masks) == 2:
            ess = int(ess * 4 / 3)
        generator = check_random_state(self.random_state)
        blocks: list[npt.NDArray] = []
        edges_in: list[npt.NDArray] = []
        edges_out: list[npt.NDArray] = []
        # Bin-major row-index maps let bin and complement samples be gathered without
        # ever materialising the stacked per-bin matrices (O(n·B·d) copying in the
        # reference, ref _affine_separator.py:150; RNG draws are unchanged because the
        # population sizes and weight vectors are identical).
        bin_rows = [np.flatnonzero(m) for m in masks]
        for i in range(len(bin_rows)):
            idx = generator.choice(len(bin_rows[i]), size=ess, p=np.ravel(bin_probs[i]))
            bin_sample = _normalized_rows(bin_rows[i][idx])
            complement_rows = np.concatenate(
                [rows for j, rows in enumerate(bin_rows) if j != i]
            )
            complement_w = weights[complement_rows]
            idx = generator.choice(
                len(complement_rows),
                size=ess * self.edge_search_multiplier,
                p=np.ravel(complement_w) / np.sum(complement_w),
            )
            complement_sample = _normalized_rows(complement_rows[idx])
            # Round 1: complement points nearest to the bin sample = the complement edge.
            complement_edge = nearest_neighbours(bin_sample, complement_sample)
            edges_out.append(complement_edge)
            # Round 2: bin points nearest to the complement edge = the bin's own edge.
            idx = generator.choice(
                len(bin_rows[i]), size=ess * self.edge_search_multiplier, p=np.ravel(bin_probs[i])
            )
            bin_edge = nearest_neighbours(complement_edge, _normalized_rows(bin_rows[i][idx]))
            edges_in.append(bin_edge)
            # Directions that separate the two edges: leading right singular vectors.
            s, V = right_singular_vectors(bin_edge - complement_edge)
            rank = int(np.sum(s > self.rank_threshold * s[0]))
            blocks.append(V[:, :rank])
        self.A_ = np.hstack(blocks)
        # Rescale A for Gaussian-kernel methods from mean inter/intra-bin edge distances.
        inter, intra = 0.0, 0.0
        num_inter_pairs = ess * (ess + 1) / 2
        num_intra_pairs = ess * (ess - 1) / 2
        for bin_edge, complement_edge, n_bin in zip(edges_in, edges_out, bin_weights):
            proj_in = bin_edge @ self.A_
            proj_out = complement_edge @ self.A_
            inter += n_bin * np.sum(np.tril(squared_distances(proj_in, proj_out), k=0)) / num_inter_pairs
            intra += n_bin * np.sum(np.tril(squared_distances(proj_in, proj_in), k=-1)) / num_intra_pairs
        inter /= sum(bin_weights)
        intra /= sum(bin_weights)
        scale_factor = np.sqrt(2 * np.log(inter / intra) / (inter - intra)) if intra > 0 else 1
        self.A_ = self.A_ * scale_factor
        return self
