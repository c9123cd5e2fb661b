"""Adaptive quantisation of numerical features by piecewise-linear ECDF approximation.

Behavioural re-implementation of the reference quantizer (``_quantizer.py``): a greedy
double-sided knot search approximates a vector's empirical CDF with a piecewise-linear
function whose per-bin error and size are bounded; the knots become variable-width
histogram bins. The target-binning entry point ``sample_bins_quantized_ecdf`` is what
turns regression targets into "class bins" for the supervised affine pre-transform.

The reference compiles the sequential knot searches with numba (``_quantizer.py:18-73``).
They are inherently sequential scans over the *unique* values of one vector, run once per
fit on the target only — host CPU is the right place for them (they gate no device math);
a native C++ scan kernel is provided in ``neo_ls_svm_jax/native`` when built, with this
pure-Python fallback kept behaviourally identical.
"""

from typing import Any

import numpy as np
import numpy.typing as npt

from neo_ls_svm_jax.utils.base import BaseEstimator, TransformerMixin
from neo_ls_svm_jax.utils.validation import check_array

_native_knot_scan = None
try:  # pragma: no cover - exercised only when the native extension is built.
    from neo_ls_svm_jax.native import knot_scan as _native_knot_scan  # type: ignore[no-redef]
except ImportError:
    _native_knot_scan = None


def _scan_knot(
    x: npt.NDArray[np.floating],
    y: npt.NDArray[np.integer],
    knot: int,
    max_bin_error: int,
    max_bin_size: int,
    direction: int,
) -> tuple[int, int]:
    """Greedy knot scan with a tangent-cone error bound (ref ``_quantizer.py:18-73``).

    Walks from ``knot`` in ``direction`` (+1 forward / -1 backward) and stops at the first
    index where either the accumulated bin count exceeds ``max_bin_size`` or the secant
    tangent leaves the feasible cone implied by ``max_bin_error``.
    """
    lo_tangent, hi_tangent = 0.0, np.inf
    candidate = knot + direction
    bin_count = 0
    stop = len(x) if direction > 0 else -1
    while candidate != stop:
        if direction > 0:
            left, right = knot, candidate
        else:
            left, right = candidate, knot
        bin_count = int(y[right - 1] - (y[left - 1] if left > 0 else 0))
        if bin_count > max_bin_size:
            break
        if right != left + 1:
            dx = float(x[right - 1] - x[left])
            dy = float(y[right - 1] - y[left])
            hi_tangent = min(hi_tangent, (dy + max_bin_error) / dx)
            lo_tangent = max(lo_tangent, (dy - max_bin_error) / dx)
            tangent = dy / dx
            if not lo_tangent <= tangent <= hi_tangent:
                break
        candidate += direction
    else:
        candidate = stop - direction
    return candidate, bin_count


def hist_quantized_ecdf(
    x: npt.NDArray[np.number],
    *,
    density: bool = False,
    max_bin_error: float = 0.0125,
    max_bin_size: float = 0.125,
    merge_bin_size: float = 0.025,
) -> tuple[npt.NDArray[Any], npt.NDArray[np.floating]]:
    """Compute a vector's histogram by quantizing its empirical CDF.

    Greedy knot placement proceeds simultaneously from both ends of the sorted unique
    values (ref ``_quantizer.py:98-171``), with a middle-merge termination when the two
    frontiers come within ``merge_bin_size`` of each other.
    """
    abs_bin_error = int(max_bin_error * len(x))
    abs_bin_size = int(max_bin_size * len(x))
    abs_merge_size = int(merge_bin_size * len(x))
    uniq, counts = np.unique(x, return_counts=True)
    cum = np.cumsum(counts)
    # Sentinel-extended arrays: the scans may run off either end. Scans run in
    # float64/int64 (cast once here — the native kernel and the Python fallback share
    # the representation).
    xs = np.concatenate(([-np.inf], uniq.astype(np.float64), [np.inf]))
    ys = np.concatenate(([0], cum.astype(np.int64), [np.iinfo(np.int64).max]))
    left, right = 1, len(xs) - 1
    edges_left: list[float] = [float(uniq[0])]
    edges_right: list[float] = [float(uniq[-1])]
    hist_left: list[int] = []
    hist_right: list[int] = []
    hist: list[int] = []
    edges: list[float] = []
    scan = _native_knot_scan if _native_knot_scan is not None else _scan_knot
    while left < right:
        prev_left, prev_right = left, right
        left, count_left = scan(xs, ys, left, abs_bin_error, abs_bin_size, +1)
        right, count_right = scan(xs, ys, right, abs_bin_error, abs_bin_size, -1)
        hist_left.append(count_left)
        hist_right.insert(0, count_right)
        edges_left.append(float((xs[left] + xs[left - 1]) / 2) if left > 0 else float(xs[left]))
        edges_right.insert(
            0, float((xs[right] + xs[right - 1]) / 2) if right > 0 else float(xs[right])
        )
        if left == right:
            edges = edges_left + edges_right[1:]
            hist = hist_left + hist_right
            break
        if left > right:
            hist = (
                hist_left[:-1]
                + [int(cum[-1] - np.sum(hist_left[:-1]) - np.sum(hist_right[1:]))]
                + hist_right[1:]
            )
            edges = edges_left[:-1] + edges_right[1:]
            break
        if ys[right - 1] - ys[left - 1] <= abs_merge_size:
            center_left = int(np.floor((left + right) / 2))
            center_right = int(np.ceil((left + right) / 2))
            center_edge = float((xs[center_left] + xs[center_right]) / 2)
            hist = (
                hist_left[:-1]
                + [int(ys[center_left] - ys[prev_left - 1])]
                + [int(ys[prev_right - 1] - ys[center_right - 1])]
                + hist_right[1:]
            )
            edges = edges_left[:-1] + [center_edge] + edges_right[1:]
            break
    float_dtype: npt.DTypeLike = uniq.dtype if np.issubdtype(uniq.dtype, np.floating) else np.float64
    hist_arr = (np.array(hist) / cum[-1]).astype(float_dtype) if density else np.array(hist)
    edges_arr = np.array(edges).astype(float_dtype)
    return hist_arr, edges_arr


class Quantizer(BaseEstimator, TransformerMixin):
    """Quantizing encoder for numerical features.

    Maps numerical features to ``[0, num_bins)`` by quantizing them into dynamically
    sized bins (ref ``_quantizer.py:174-243``).
    """

    def __init__(
        self,
        *,
        max_bin_error: float = 0.0125,
        max_bin_size: float = 0.125,
        append_invfreq: bool = False,
        dtype: npt.DTypeLike = np.intp,
    ):
        self.max_bin_error = max_bin_error
        self.max_bin_size = max_bin_size
        self.append_invfreq = append_invfreq
        self.dtype = dtype
        if append_invfreq and not np.issubdtype(dtype, np.floating):
            self.dtype = np.float32

    def fit(self, X: npt.NDArray[np.number], y: Any = None) -> "Quantizer":
        """Learn per-column variable-width histogram bins."""
        X = check_array(X, dtype=None)
        self.n_features_in_ = X.shape[1]
        self.X_hist_: list[npt.NDArray[np.int64]] = []
        self.X_bin_edges_: list[npt.NDArray[np.floating]] = []
        for j in range(X.shape[1]):
            hist_j, edges_j = hist_quantized_ecdf(
                X[:, j],
                density=False,
                max_bin_error=self.max_bin_error,
                max_bin_size=self.max_bin_size,
            )
            self.X_hist_.append(hist_j)
            self.X_bin_edges_.append(edges_j)
        return self

    def transform(self, X: npt.NDArray[np.number]) -> npt.NDArray[Any]:
        """Map each value to its bin index (and optionally its inverse bin frequency)."""
        X = np.asarray(X)
        out = np.empty((X.shape[0], (1 + self.append_invfreq) * X.shape[1]), dtype=self.dtype)
        for j in range(X.shape[1]):
            bin_idx = np.clip(
                np.searchsorted(self.X_bin_edges_[j], X[:, j], side="right") - 1,
                0,
                len(self.X_bin_edges_[j]) - 2,
            )
            out[:, j] = bin_idx
            if self.append_invfreq:
                out[:, X.shape[1] + j] = 1 / len(self.X_hist_[j]) / self.X_hist_[j][bin_idx]
        return out

    def get_feature_names_out(
        self, input_features: npt.ArrayLike | None = None
    ) -> npt.NDArray[np.object_]:
        """Get output feature names for the transformation."""
        if input_features is None:
            input_features = [f"x{j}" for j in range(self.n_features_in_)]
        names = np.array([f"{f}_quantized" for f in np.asarray(input_features)], dtype=object)
        if self.append_invfreq:
            invfreq = np.array([f"{f}_invfreq" for f in np.asarray(input_features)], dtype=object)
            names = np.hstack((names, invfreq))
        return names


def sample_bins_quantized_ecdf(x: npt.NDArray[Any], **kwargs: Any) -> npt.NDArray[np.intp]:
    """Compute optimal sample bins of a vector by quantizing its ECDF.

    Targets with few unique values (≤ ⌈√n⌉) are used as bins directly via their unique
    codes; otherwise the *codes* are quantized (ref ``_quantizer.py:246-253``).
    """
    uniq, codes = np.unique(x, return_inverse=True)
    if len(uniq) <= np.ceil(np.sqrt(len(codes))):
        return codes.astype(np.intp)
    quantizer = Quantizer(dtype=np.intp, **kwargs)
    bins: npt.NDArray[np.intp] = quantizer.fit_transform(codes[:, np.newaxis]).ravel()
    return bins


def sample_weights_quantized_ecdf(x: npt.NDArray[Any], **kwargs: Any) -> npt.NDArray[np.floating]:
    """Compute optimal sample weights of a vector by quantizing its ECDF.

    Kept for API parity with the reference (``_quantizer.py:256-264``; unused by the
    estimator there as well).
    """
    dtype: npt.DTypeLike = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64
    uniq, codes, counts = np.unique(x, return_inverse=True, return_counts=True)
    if len(uniq) <= np.ceil(np.sqrt(len(codes))):
        return counts[codes] / np.sum(counts)
    quantizer = Quantizer(append_invfreq=True, dtype=dtype, **kwargs)
    weights: npt.NDArray[np.floating] = quantizer.fit_transform(codes[:, np.newaxis])[:, 1]
    return weights
