"""Weighted quantiles.

JAX counterpart of the reference's weighted quantile (``_weighted_quantile.py:35-77``).
The reference parallelises the batched 1-D interpolation with a numba ``prange`` kernel
(``_weighted_quantile.py:13-18``); here the same computation exists twice:

* ``weighted_quantile`` — host NumPy, bit-compatible with the reference. Used by the
  host-side supervised pre-transform fit, where exact parity matters.
* ``weighted_quantile_jax`` — a fully vectorised ``jnp.sort`` + ``vmap(jnp.interp)``
  version for on-device use at scale.

Both use the reference's averaged lower/upper ECDF convention
``(interp(q, p_lower, a) + interp(q, p_upper, a)) / 2`` (rationale at
``_weighted_quantile.py:69-71``: it yields 0.5 for a=(0,1,1), w=(2,1,1), q=0.5 where the
standard midpoint convention does not).
"""

import jax
import jax.numpy as jnp
import numpy as np

from neo_ls_svm_jax.utils.typing import FloatTensor, FloatVector


def _batched_interp(q: np.ndarray, p: np.ndarray, a: np.ndarray) -> np.ndarray:
    # Equivalent of the reference's numba ``_parallel_interp``: row-wise np.interp.
    out = np.empty((a.shape[0], len(q)), dtype=a.dtype)
    for i in range(a.shape[0]):
        out[i, :] = np.interp(q, p[i, :], a[i, :])
    return out


# Tests flip this off to compare the O(n) uniform-weight fast path against the
# general argsort path on identical inputs (they must agree BIT-exactly).
_ENABLE_UNIFORM_FAST_PATH = True


def _uniform_weight_quantile_2d(a: np.ndarray, w0: np.ndarray, q: float) -> np.ndarray:
    """Bit-exact fast path of :func:`weighted_quantile` for UNIFORM weights, 2-D a,
    ``axis=0``, one quantile.

    With equal weights the sorted-weight vector — hence both ECDF position arrays —
    is data-independent, so the full O(n log n) argsort reduces to an O(n)
    ``np.partition`` for the 2×2 bracketing order statistics. Exactness: the p
    arrays are reconstructed with the same cumsum arithmetic the general path uses,
    the bracket index is ``np.interp``'s own choice (largest j with p[j] ≤ q, i.e.
    ``searchsorted(..., 'right') - 1``), and the final interpolation reuses
    ``np.interp`` on the bracketing pair — identical floating-point operations to
    the general path, which reads only those two entries anyway.

    One caveat: among tied ±0.0 values, partition and argsort may select a
    differently-SIGNED zero representative (both paths' tie order is arbitrary);
    the results compare equal (−0.0 == +0.0) but can differ in the sign bit.
    """
    n, d = a.shape
    # The p arrays carry the WEIGHT dtype in the general path (cumsum of the sorted
    # weights), independent of a's dtype — reproduce that exactly.
    w_vec = np.full(n, w0, dtype=w0.dtype)
    cw = np.cumsum(w_vec)
    total = cw[-1]
    p_lower = (cw - w_vec) / total
    p_upper = cw / total

    def bracket(p_vec: np.ndarray) -> tuple[int, int]:
        j = int(np.searchsorted(p_vec, q, side="right")) - 1
        if j < 0:
            return 0, 0  # q below p[0]: np.interp clamps to fp[0]
        if j >= n - 1:
            return n - 1, n - 1  # q at/above p[-1]: clamps to fp[-1]
        return j, j + 1

    lo0, lo1 = bracket(p_lower)
    up0, up1 = bracket(p_upper)
    kth = sorted({lo0, lo1, up0, up1})
    at = np.ascontiguousarray(a.T)  # (d, n): partition along the contiguous axis
    part = np.partition(at, kth, axis=1)
    result = np.empty((1, d), dtype=a.dtype)
    for col in range(d):
        vals = {k: part[col, k] for k in kth}
        lower = np.interp(q, p_lower[[lo0, lo1]], [vals[lo0], vals[lo1]])
        upper = np.interp(q, p_upper[[up0, up1]], [vals[up0], vals[up1]])
        result[0, col] = (np.asarray(lower, a.dtype) + np.asarray(upper, a.dtype)) / 2
    return result


def weighted_quantile(
    a: FloatTensor,
    w: FloatTensor,
    q: float | FloatVector,
    axis: int | None = None,
) -> np.ndarray:
    """Compute the weighted q'th quantile of the data along the specified axis."""
    a = np.ascontiguousarray(np.asarray(a))
    w = np.ascontiguousarray(np.asarray(w))
    assert a.ndim == w.ndim, "Array and weights must have the same number of dimensions"
    assert axis is None or (0 <= axis < a.ndim), "Axis must be one of the array's dimensions"
    assert np.all(w >= 0), "Weights must be nonnegative"
    # Uniformity is checked on the PRE-broadcast weights (O(n), not O(n·d) over the
    # broadcast view, and non-uniform callers skip straight to the general path).
    uniform_w = w.size > 0 and np.ptp(w) == 0 and float(w.flat[0]) > 0
    w = np.broadcast_to(w, a.shape)
    q_arr = np.ravel(np.asarray([q])).astype(a.dtype)
    if (
        _ENABLE_UNIFORM_FAST_PATH
        and uniform_w
        and axis == 0
        and a.ndim == 2
        and q_arr.size == 1
        and a.shape[0] >= 64
    ):
        return _uniform_weight_quantile_2d(a, w.flat[0], float(q_arr[0]))
    if axis is None:
        a_flat, w_flat = np.ravel(a), np.ravel(w)
        order = np.argsort(a_flat)
        a_sorted, w_sorted = a_flat[order], w_flat[order]
        cw = np.cumsum(w_sorted)
        p_lower = (cw - w_sorted) / cw[-1]
        p_upper = cw / cw[-1]
        result = (
            0.5 * np.interp(q_arr, p_lower, a_sorted) + 0.5 * np.interp(q_arr, p_upper, a_sorted)
        ).astype(a.dtype)
        return result
    # Move the reduction axis last and flatten the leading axes into rows.
    a_moved, w_moved = np.moveaxis(a, axis, -1), np.moveaxis(w, axis, -1)
    lead_shape = a_moved.shape
    rows_a = np.reshape(a_moved, (-1, lead_shape[-1]))
    rows_w = np.reshape(w_moved, (-1, lead_shape[-1]))
    order = np.argsort(rows_a, axis=1)
    rows_a = np.take_along_axis(rows_a, order, axis=1)
    rows_w = np.take_along_axis(rows_w, order, axis=1)
    cw = np.cumsum(rows_w, axis=1)
    total = cw[:, [-1]].copy()
    p_lower = (cw - rows_w) / total
    p_upper = cw / total
    result = (_batched_interp(q_arr, p_lower, rows_a) + _batched_interp(q_arr, p_upper, rows_a)) / 2
    result = np.reshape(result, lead_shape[:-1] + (len(q_arr),))
    result = np.moveaxis(result, -1, axis)
    return result


def _interp_row(q: jax.Array, p: jax.Array, a: jax.Array) -> jax.Array:
    return jnp.interp(q, p, a)


def weighted_quantile_jax(
    a: jax.Array,
    w: jax.Array,
    q: jax.Array,
    axis: int = 0,
) -> jax.Array:
    """On-device weighted quantile along ``axis``; jit/vmap friendly.

    Same averaged lower/upper ECDF convention as :func:`weighted_quantile`.
    """
    a = jnp.moveaxis(a, axis, -1)
    w = jnp.broadcast_to(jnp.moveaxis(w, axis, -1), a.shape)
    lead_shape = a.shape
    rows_a = a.reshape(-1, lead_shape[-1])
    rows_w = w.reshape(-1, lead_shape[-1])
    order = jnp.argsort(rows_a, axis=1)
    rows_a = jnp.take_along_axis(rows_a, order, axis=1)
    rows_w = jnp.take_along_axis(rows_w, order, axis=1)
    cw = jnp.cumsum(rows_w, axis=1)
    total = cw[:, -1:]
    p_lower = (cw - rows_w) / total
    p_upper = cw / total
    q = jnp.atleast_1d(jnp.asarray(q, dtype=a.dtype))
    lower = jax.vmap(_interp_row, in_axes=(None, 0, 0))(q, p_lower, rows_a)
    upper = jax.vmap(_interp_row, in_axes=(None, 0, 0))(q, p_upper, rows_a)
    result = 0.5 * (lower + upper)
    result = result.reshape(lead_shape[:-1] + (q.shape[0],))
    return jnp.moveaxis(result, -1, axis)
