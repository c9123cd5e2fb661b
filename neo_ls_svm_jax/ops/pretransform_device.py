"""Fully on-device supervised pre-transform — ``NeoLSSVM(pre_transform="device")``.

The default (host) pre-transform reproduces the reference bit-for-bit: NumPy RNG in
the reference's call order, adaptive quantized-ECDF target binning, host argsorts for
the normalizer statistics (ref ``_affine_normalizer.py:50-117``,
``_affine_separator.py:107-210``, ``_feature_maps.py:206-223``). That parity contract
pins the *default* path to the host, and its host-side binning and argsorts grow with
n into seconds at a million rows.

This module is the on-device redesign of the same pipeline: ONE jitted program
that runs target binning, the normalizer's per-bin statistics, the separator's edge
sampling / SVD / λ rescale, and the ORFF draw entirely on device with JAX RNG. A fit
then issues zero mid-fit host round-trips: X/y/weights ride up in one batched
transfer, and the solver consumes the feature-map operands without the data ever
returning to the host.

Deliberate deviations from the bit-parity path (statistically equivalent, documented):

- **Binning**: equal-weighted-mass quantile bins (static count, default 8) instead of
  the adaptive quantized-ECDF knots. The reference's ECDF binning targets bins of at
  most 12.5% mass (``_quantizer.py:98-104``); equal-mass-1/8 bins are its limit case
  with a compile-time shape. Classifiers use the two label bins exactly as the
  reference does.
- **RNG**: ``jax.random`` (threefry) instead of NumPy MT19937, so edge samples, the
  ORFF Gaussian, its blockwise QR, and the χ rescale differ sample-for-sample but not
  in distribution.
- **Ties/summation order**: medians come from the sort-free bisection of
  :func:`~neo_ls_svm_jax.ops.affine.grouped_weighted_median` (already the device-stats
  path of the default mode).
"""

from functools import partial

import jax
import jax.numpy as jnp

from neo_ls_svm_jax.ops.affine import _normalizer_stats_device
from neo_ls_svm_jax.ops.weighted_quantile import weighted_quantile_jax

# Every product here is small (d-, D- or edge-sample-sized), so all run at full float32
# precision: at the default precision NVIDIA GPUs round float32 operands to TF32.
_HI = jax.lax.Precision.HIGHEST

DEVICE_PRETRANSFORM_BINS = 8  # Equal-mass target bins for regression (see module doc).


def _target_codes(
    y: jax.Array, w: jax.Array, *, num_bins: int, is_classifier: bool
) -> tuple[jax.Array, jax.Array]:
    """Per-row bin codes and per-bin total weights, on device.

    Device counterpart of ``sample_bins_quantized_ecdf`` (ref ``_quantizer.py:246-253``)
    under the equal-mass redesign: regression targets are cut at the weighted
    ``k/num_bins`` quantiles; classifiers (y ∈ {−1, +1}) use the two label bins.
    Zero-weight (padding) rows receive code ``num_bins`` and are excluded everywhere.
    """
    if is_classifier:
        codes = (y > 0).astype(jnp.int32)
    else:
        probs = jnp.arange(1, num_bins, dtype=y.dtype) / num_bins
        edges = weighted_quantile_jax(y, w, probs)  # monotone in q → sorted
        codes = jnp.searchsorted(edges, y, side="right").astype(jnp.int32)
    codes = jnp.where(w > 0, codes, num_bins)
    onehot = (codes[:, None] == jnp.arange(num_bins, dtype=jnp.int32)[None, :]).astype(y.dtype)
    totals = jnp.sum(onehot * w[:, None], axis=0)
    return codes, totals


def _sample_rows(key: jax.Array, cum_mass: jax.Array, num: int) -> jax.Array:
    """``num`` row indices drawn with replacement ∝ the masses behind ``cum_mass``.

    Inverse-CDF sampling (one cumsum + searchsorted) replaces the reference's
    ``RandomState.choice`` (ref ``_affine_separator.py:142-167``): a categorical draw
    over n=10⁶ rows would materialise an (num × n) Gumbel field; this is O(n + num·log n).
    """
    u = jax.random.uniform(key, (num,), dtype=cum_mass.dtype) * cum_mass[-1]
    return jnp.clip(jnp.searchsorted(cum_mass, u, side="left"), 0, cum_mass.shape[0] - 1)


def _sq_dists(A: jax.Array, B: jax.Array) -> jax.Array:
    """Pairwise squared Euclidean distances (rows of A × rows of B)."""
    return (
        jnp.sum(A * A, axis=1, keepdims=True)
        - 2.0 * jnp.dot(A, B.T, precision=_HI)
        + jnp.sum(B * B, axis=1, keepdims=True).T
    )


@partial(
    jax.jit,
    static_argnames=(
        "num_bins",
        "num_features",
        "edge_sample_size",
        "edge_search_multiplier",
        "is_classifier",
        "orthogonal",
    ),
)
def device_pre_transform(
    X: jax.Array,  # (n_pad, d) feature rows; padding rows have weight 0
    y: jax.Array,  # (n_pad,) targets (±1 for classifiers)
    w: jax.Array,  # (n_pad,) sample weights, 0 on padding rows
    key: jax.Array,  # JAX PRNG key
    *,
    num_bins: int,
    num_features: int,  # D — the ORFF feature count
    edge_sample_size: int,
    edge_search_multiplier: int,
    rank_threshold: float,
    is_classifier: bool,
    orthogonal: bool = True,
) -> dict[str, jax.Array]:
    """One device program: binning → normalizer stats → separator → ORFF fold.

    Returns the solver operands ``M`` (d×D) and ``b`` (1×D) with U = X@M + b the
    feature phases, plus the fitted pre-transform state (shift/scale/A/Z and the
    folded A@Z) for the host observability API. Mirrors the host pipeline
    ``AffineSeparator.fit`` → ``OrthogonalRandomFourierFeatures.fit``
    (ref ``_affine_separator.py:107-210``, ``_feature_maps.py:206-223``) with the
    deviations documented in the module docstring.
    """
    n, d = X.shape
    dtype = X.dtype
    tiny = jnp.finfo(dtype).tiny

    codes, totals = _target_codes(y, w, num_bins=num_bins, is_classifier=is_classifier)
    valid = totals > 0
    num_valid = jnp.sum(valid.astype(jnp.int32))

    shift, scale = _normalizer_stats_device(X, w, codes, totals, num_bins=num_bins)
    degenerate = num_valid < 2
    shift = jnp.where(degenerate, jnp.zeros_like(shift), shift)
    scale = jnp.where(degenerate, jnp.ones_like(scale), scale)
    inv_scale = 1.0 / scale

    def norm_rows(idx: jax.Array) -> jax.Array:
        return (X[idx] - shift[None, :]) * inv_scale[None, :]

    # With exactly two bins each bin's complement is the other bin; spend the sample
    # budget accordingly (ref _affine_separator.py:138-139). The classifier case is
    # static; the regression bin count is a compile-time constant > 2.
    ess = edge_sample_size
    if is_classifier:
        ess = int(ess * 4 / 3)
    m = ess * edge_search_multiplier

    keys = jax.random.split(key, 3 * num_bins + 2)
    blocks = []
    edges_in = []
    edges_out = []
    kept_rank = jnp.zeros((), dtype)
    for b_idx in range(num_bins):
        in_bin = (codes == b_idx).astype(dtype)
        in_comp = ((codes != b_idx) & (codes < num_bins)).astype(dtype)
        cum_bin = jnp.cumsum(w * in_bin)
        cum_comp = jnp.cumsum(w * in_comp)
        bin_sample = norm_rows(_sample_rows(keys[3 * b_idx], cum_bin, ess))
        comp_sample = norm_rows(_sample_rows(keys[3 * b_idx + 1], cum_comp, m))
        # Round 1: complement points nearest the bin sample = the complement edge.
        comp_edge = comp_sample[jnp.argmin(_sq_dists(bin_sample, comp_sample), axis=1)]
        # Round 2: bin points nearest the complement edge = the bin's own edge.
        bin_pool = norm_rows(_sample_rows(keys[3 * b_idx + 2], cum_bin, m))
        bin_edge = bin_pool[jnp.argmin(_sq_dists(comp_edge, bin_pool), axis=1)]
        edges_in.append(bin_edge)
        edges_out.append(comp_edge)
        # Leading right singular vectors of the edge differences, via the d×d Gram
        # (ref _faster_svd, _affine_separator.py:32-51). The data-dependent rank cut
        # becomes a column mask: dropped directions are zeroed, not removed, so the
        # block width stays the compile-time constant d.
        Ediff = bin_edge - comp_edge
        e, V = jnp.linalg.eigh(jnp.dot(Ediff.T, Ediff, precision=_HI))
        s = jnp.sqrt(jnp.abs(e))[::-1]
        V = V[:, ::-1]
        keep = (s > rank_threshold * s[0]) & valid[b_idx]
        blocks.append(V * keep[None, :].astype(dtype))
        # Effective post-rank-cut column count: the host/reference ORFF draws its χ
        # degrees of freedom from A.shape[1] AFTER dropped directions are removed
        # (ref _feature_maps.py:221-222 with A_ from _affine_separator.py:173-176);
        # here dropped directions are zeroed (static shapes), so the χ df must count
        # only the kept columns or feature norms inflate with every dropped direction.
        kept_rank = kept_rank + jnp.sum(keep.astype(dtype))
    A_sep = jnp.concatenate(blocks, axis=1)  # (d, num_bins·d)

    # Global rescale λ = √(2·log(f/g)/(f−g)) from mean inter-/intra-bin edge distances
    # (ref _affine_separator.py:178-209). Empty bins contribute weight 0.
    num_inter_pairs = ess * (ess + 1) / 2
    num_intra_pairs = ess * (ess - 1) / 2
    inter = jnp.zeros((), dtype)
    intra = jnp.zeros((), dtype)
    for b_idx in range(num_bins):
        proj_in = jnp.dot(edges_in[b_idx], A_sep, precision=_HI)
        proj_out = jnp.dot(edges_out[b_idx], A_sep, precision=_HI)
        inter = inter + totals[b_idx] * jnp.sum(
            jnp.tril(_sq_dists(proj_in, proj_out), k=0)
        ) / num_inter_pairs
        intra = intra + totals[b_idx] * jnp.sum(
            jnp.tril(_sq_dists(proj_in, proj_in), k=-1)
        ) / num_intra_pairs
    total_mass = jnp.maximum(jnp.sum(totals), tiny)
    inter = inter / total_mass
    intra = intra / total_mass
    gap = inter - intra
    # As inter → intra the exact expression 2·log(f/g)/(f−g) tends to 2/g.
    ratio = jnp.where(
        jnp.abs(gap) > 1e3 * tiny,
        2.0 * jnp.log(jnp.maximum(inter, tiny) / jnp.maximum(intra, tiny)) / gap,
        2.0 / jnp.maximum(intra, tiny),
    )
    lam = jnp.where(intra > 0, jnp.sqrt(jnp.maximum(ratio, 0.0)), 1.0)
    A_sep = A_sep * lam

    # Fewer than two populated bins: the separator is undefined — degrade to the
    # unsupervised identity metric (shift 0 / scale 1 set above), mirroring the host
    # path's 1-bin early exit (ref _affine_separator.py:135-136).
    width = num_bins * d
    ident = jnp.zeros((d, width), dtype).at[:, :d].set(jnp.eye(d, dtype=dtype))
    A_final = jnp.where(degenerate, ident, A_sep)

    # Random Fourier draw. ``orthogonal`` (OrthogonalRandomFourierFeatures, the
    # default) applies blockwise QR orthogonalisation with χ-rescaled column norms
    # (ref _feature_maps.py:206-223, following Yu et al. 2016); a plain
    # RandomFourierFeatures map keeps the i.i.d. N(0,1) draw it was configured
    # with (ref _feature_maps.py:120-127).
    D = num_features
    Z = jax.random.normal(keys[-2], (width, D), dtype)
    if orthogonal:
        for j in range(0, D, width):
            block = Z[:, j : j + width]
            Z = Z.at[:, j : j + width].set(jnp.linalg.qr(block)[0])
        # χ df = the effective (post-rank-cut, non-degenerate-fallback) column
        # count of A, matching the host draw's A.shape[1].
        chi_df = jnp.maximum(jnp.where(degenerate, jnp.asarray(float(d), dtype), kept_rank), 1.0)
        chi = jax.random.chisquare(keys[-1], chi_df, shape=(1, D), dtype=dtype)
        Z = Z * jnp.sqrt(chi)

    folded = jnp.dot(A_final, Z, precision=_HI)  # (d, D)
    M = folded * inv_scale[:, None]
    b = jnp.dot(-(shift * inv_scale)[None, :], folded, precision=_HI)
    return {
        "M": M,
        "b": b,
        "pt_shift": shift[None, :],
        "pt_scale": scale[None, :],
        "pt_A": A_final,
        "pt_Z": Z,
        "pt_folded": folded,
    }
