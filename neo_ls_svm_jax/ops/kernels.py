"""On-device kernel matrices.

Replaces the reference's sklearn ``rbf_kernel`` / ``euclidean_distances`` calls
(ref ``_neo_ls_svm.py:11,257-261,321,474,669``) with jitted XLA ops: a squared-distance
expansion that rides one matmul plus rank-1 corrections, with sklearn's exact
numerical conventions (negative clamp; zeroed self-distance diagonal) so kernel-path
results are comparable at tight tolerances.
"""

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("same", "precision"))
def squared_distances(
    X: jax.Array,
    Y: jax.Array,
    *,
    same: bool = False,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """Pairwise squared Euclidean distances; ``same=True`` zeroes the diagonal
    (sklearn ``euclidean_distances`` convention for X vs X)."""
    xx = jnp.sum(X * X, axis=1, keepdims=True)
    yy = jnp.sum(Y * Y, axis=1, keepdims=True).T
    sq = xx - 2.0 * jnp.dot(X, Y.T, precision=precision) + yy
    sq = jnp.maximum(sq, 0.0)
    if same:
        sq = sq * (1.0 - jnp.eye(X.shape[0], dtype=X.dtype))
    return sq


@partial(jax.jit, static_argnames=("same", "precision"))
def rbf_kernel(
    X: jax.Array,
    Y: jax.Array,
    gamma: float = 0.5,
    *,
    same: bool = False,
    precision: jax.lax.Precision = jax.lax.Precision.HIGHEST,
) -> jax.Array:
    """K(x, y) = exp(-γ·‖x-y‖²); γ = 0.5 throughout the reference's dual/std paths."""
    return jnp.exp(-gamma * squared_distances(X, Y, same=same, precision=precision))
