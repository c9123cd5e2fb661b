"""Device-mesh sharding for multi-chip fits.

The reference has no distributed code of any kind (SURVEY.md §5.8); the scaling story
this build adds is row-sharded data parallelism over a device mesh:

* rows of X (hence of the feature matrix W) are sharded across the ``data`` axis;
* the D×D-scale Gram reduction WᵀS²W becomes a sharded matmul whose partial sums XLA
  combines with one ``psum`` over the device interconnect (NVLink between the cards
  of one host);
* the tiny 2M×2M eigh and γ-selection are replicated on every chip;
* per-row outputs (LOO residuals, leverage, std) come back row-sharded.

No hand-written collectives on the in-memory route: shardings are declared on the jit
boundary and GSPMD inserts the all-reduces. The streaming route
(:func:`sharded_primal_fit_streaming`) additionally implements tensor parallelism over
the second ``feature`` mesh axis for the three O(n·(2M)²) contractions that dominate
at large D: pass-1 Gram columns (one tiled ``all_gather`` reassembles the square
before the replicated eigh), and the pass-2/pass-3 eigenbasis contractions (each
feature-chip owns a block of eigenvector columns; num/lev partials ``psum`` over
``feature`` before the nonlinear LOO step). ``make_mesh`` defaults to a 1-D data mesh;
pass ``num_feature > 1`` to trade data-axis width for per-chip contraction width.
"""

import math
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from neo_ls_svm_jax.models.primal import (
    _clip_classifier_residuals,
    _eigendecompose,
    _features_real_pair,
    _sweep_objective,
    embed_from_gram_blocks,
    primal_fit,
    trim_per_row,
)


def make_mesh(
    num_data: int | None = None,
    num_feature: int = 1,
    devices: Any = None,
) -> Mesh:
    """Create a ("data", "feature") mesh over the available devices.

    A flat reshape of the device list: every card of a host reaches every other at
    the same rate (NVLink all to all), so the device order carries no topology.
    """
    devices = jax.devices() if devices is None else devices
    if num_data is None:
        num_data = len(devices) // num_feature
    device_grid = np.asarray(devices[: num_data * num_feature]).reshape(num_data, num_feature)
    return Mesh(device_grid, axis_names=("data", "feature"))


def _pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    remainder = arr.shape[0] % multiple
    if remainder == 0:
        return arr
    pad = multiple - remainder
    pad_width = ((0, pad),) + ((0, 0),) * (arr.ndim - 1)
    return np.pad(arr, pad_width)


def _stage_rows(mesh: Mesh, arr: Any, spec: P, mult: int) -> jax.Array:
    """Pad rows to ``mult`` and shard over the mesh — or pass a pre-staged device
    array through (the device-pre-transform route stages X/y/w ONCE, already
    padded; re-sharding an identically-sharded array is a no-op)."""
    if isinstance(arr, jax.Array):
        if arr.shape[0] % mult:
            # Device-resident inputs pad on device (zero rows are inert: their
            # weights are zero-padded in lockstep) — never via a host hop.
            pad = mult - arr.shape[0] % mult
            pad_width = ((0, pad),) + ((0, 0),) * (arr.ndim - 1)
            arr = jnp.pad(arr, pad_width)
        return jax.device_put(arr, NamedSharding(mesh, spec))
    return jax.device_put(_pad_rows(np.asarray(arr), mult), NamedSharding(mesh, spec))


def _stage_replicated(mesh: Mesh, arr: Any) -> jax.Array:
    """Replicate an operand on every chip (device arrays reshard without a host hop)."""
    if isinstance(arr, jax.Array):
        return jax.device_put(arr, NamedSharding(mesh, P()))
    return jax.device_put(np.asarray(arr), NamedSharding(mesh, P()))


def sharded_primal_fit(
    mesh: Mesh,
    X: "np.ndarray | jax.Array",
    M_map: "np.ndarray | jax.Array",
    b_map: "np.ndarray | jax.Array",
    y: "np.ndarray | jax.Array",
    sample_weight: "np.ndarray | jax.Array",
    gammas: np.ndarray,
    C_emb: np.ndarray | None = None,
    *,
    is_classifier: bool,
    gamma_chunk: int = 128,
    sweep_precision: "jax.lax.Precision | None" = None,
    num_samples: int | None = None,
) -> dict[str, jax.Array]:
    """Run ``primal_fit`` with rows sharded over the mesh's ``data`` axis.

    Rows are zero-weight-padded to a multiple of the data-axis size (padding provably
    does not perturb the solution: padded rows carry s=0, and the c₀ normalisation uses
    the true row count). Per-row outputs are returned unpadded. Pre-staged device
    arrays (already padded + sharded, e.g. by the device-pre-transform route) pass
    through without a host hop; ``num_samples`` then carries the true row count.
    """
    n = num_samples if num_samples is not None else X.shape[0]
    num_data = mesh.shape["data"]
    row_spec = P("data")
    X_d = _stage_rows(mesh, X, P("data", None), num_data)
    y_d = _stage_rows(mesh, y, row_spec, num_data)
    s_d = _stage_rows(mesh, sample_weight, row_spec, num_data)
    M_d = _stage_replicated(mesh, M_map)
    b_d = _stage_replicated(mesh, b_map)
    g_d = _stage_replicated(mesh, gammas)
    C_d = None if C_emb is None else _stage_replicated(mesh, C_emb)
    result = primal_fit(
        X_d,
        M_d,
        b_d,
        y_d,
        s_d,
        g_d,
        C_d,
        is_classifier=is_classifier,
        gamma_chunk=gamma_chunk,
        num_samples=n,
        sweep_precision=sweep_precision,
    )
    return trim_per_row(result, n)


def required_padding(n: int, num_data: int) -> int:
    """Rows of zero-weight padding needed to align ``n`` to the data axis."""
    return (math.ceil(n / num_data) * num_data) - n


def streaming_row_chunk(n: int, num_data: int, row_chunk: int = 16384) -> int:
    """The per-chip scan chunk the sharded streaming fit will actually use
    (callers pre-staging rows must pad to ``num_data * streaming_row_chunk(...)``)."""
    return min(row_chunk, math.ceil(n / num_data))


def sharded_primal_fit_device_pt(
    mesh: Mesh,
    X: np.ndarray,
    y: np.ndarray,
    sample_weight: np.ndarray,
    key: jax.Array,
    gammas: np.ndarray,
    *,
    is_classifier: bool,
    num_bins: int,
    num_features: int,
    edge_sample_size: int,
    edge_search_multiplier: int,
    rank_threshold: float,
    orthogonal: bool,
    stream: bool,
    row_chunk: int = 16384,
    sweep_precision: "jax.lax.Precision | None" = None,
) -> dict[str, jax.Array]:
    """Mesh fit with the fully on-device pre-transform (VERDICT r3 #3).

    Composes the two fast paths that round 3 kept mutually exclusive: X/y/weights
    are staged sharded ONCE (rows over the ``data`` axis), the jitted
    :func:`~neo_ls_svm_jax.ops.pretransform_device.device_pre_transform` runs as a
    GSPMD program over the sharded rows — its reductions (quantile cuts, bisection
    medians, one-hot Gram masses, edge-difference Grams) are exactly the
    matmul/reduction shapes XLA knows how to psum across chips, so no hand-written
    collectives are needed — and the resulting feature-map operands feed the
    sharded solver directly. Multi-chip fits therefore no longer pay the host
    pre-transform wall (round 3 forced ``mesh`` fits back to host stats,
    ``models/estimator.py`` r3 ``:404-405``).

    Returns the solver result plus the fitted pre-transform state (``pt_*`` keys),
    matching the single-chip device-pre-transform contract.
    """
    from neo_ls_svm_jax.ops.pretransform_device import (  # noqa: PLC0415 - cycle-free lazy
        device_pre_transform,
    )

    n = X.shape[0]
    num_data = mesh.shape["data"]
    mult = num_data * streaming_row_chunk(n, num_data, row_chunk) if stream else num_data
    row_spec = P("data")
    X_d = _stage_rows(mesh, X, P("data", None), mult)
    y_d = _stage_rows(mesh, y, row_spec, mult)
    s_d = _stage_rows(mesh, sample_weight, row_spec, mult)
    pt = device_pre_transform(
        X_d,
        y_d,
        s_d,
        key,
        num_bins=num_bins,
        num_features=num_features,
        edge_sample_size=edge_sample_size,
        edge_search_multiplier=edge_search_multiplier,
        rank_threshold=rank_threshold,
        is_classifier=is_classifier,
        orthogonal=orthogonal,
    )
    fit_kwargs: dict[str, Any] = {
        "is_classifier": is_classifier,
        "sweep_precision": sweep_precision,
        "num_samples": n,
    }
    sharded_fit = sharded_primal_fit
    if stream:
        sharded_fit = sharded_primal_fit_streaming
        fit_kwargs.update(row_chunk=row_chunk)
    result = sharded_fit(mesh, X_d, pt["M"], pt["b"], y_d, s_d, gammas, None, **fit_kwargs)
    return {
        **result,
        "pt_M": pt["M"],
        "pt_b": pt["b"],
        **{k: pt[k] for k in ("pt_shift", "pt_scale", "pt_A", "pt_Z", "pt_folded")},
    }


# Compiled sharded-streaming fits, keyed on everything the closure bakes in. Without
# this, every call would wrap a fresh `body` closure in jax.jit and retrace/recompile
# the whole sharded program (seconds per cold compile); with it, repeated fits on
# the same mesh/shape/config hit jax's executable cache like the in-memory path does.
_STREAMING_FIT_CACHE: dict[Any, Any] = {}
_STREAMING_FIT_CACHE_MAX = 16


def _shard_map(fn: Any, mesh: Mesh, in_specs: Any, out_specs: Any) -> Any:
    """``jax.shard_map`` with replication checking off (the body mixes manual psums
    with locally-replicated linear algebra, which the vma checker cannot type)."""
    try:
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=False)
    except TypeError:  # older JAX spells the flag check_rep
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_rep=False)


def sharded_primal_fit_streaming(
    mesh: Mesh,
    X: "np.ndarray | jax.Array",
    M_map: "np.ndarray | jax.Array",
    b_map: "np.ndarray | jax.Array",
    y: "np.ndarray | jax.Array",
    sample_weight: "np.ndarray | jax.Array",
    gammas: np.ndarray,
    C_emb: np.ndarray | None = None,
    *,
    is_classifier: bool,
    row_chunk: int = 16384,
    num_samples: int | None = None,
    precision: "jax.lax.Precision" = jax.lax.Precision.HIGHEST,
    sweep_precision: "jax.lax.Precision | None" = None,
) -> dict[str, jax.Array]:
    """Row-sharded *streaming* primal fit: O(row_chunk·2M) memory **per chip**.

    Composes the two scale axes that ``sharded_primal_fit`` and
    ``primal_fit_streaming`` cover separately: rows are sharded over the mesh's
    ``data`` axis AND each chip streams its local rows in chunks, so neither the
    full X block nor the n×2M eigenbasis projection ever materialises per chip.
    Communication is three collectives total:

    * one ``psum`` of the local scalar weight mass,
    * one ``psum`` of the (2M+1)² augmented Gram after the local pass-1 scans,
    * one ``psum`` of the γ-grid objective after the local pass-2 sweeps.

    The 2M×2M eigh, γ selection, and Cholesky re-solve replicate on every chip
    (D³ is tiny); pass-3 per-row statistics are purely local and return sharded.

    """
    if sweep_precision is None:
        sweep_precision = precision
    n = num_samples if num_samples is not None else X.shape[0]
    num_data = mesh.shape["data"]
    # Each chip's local rows must tile into row_chunk-sized scan steps.
    row_chunk = streaming_row_chunk(n, num_data, row_chunk)
    mult = num_data * row_chunk
    X_d = _stage_rows(mesh, X, P("data", None), mult)
    y_d = _stage_rows(mesh, y, P("data"), mult)
    s_d = _stage_rows(mesh, sample_weight, P("data"), mult)
    dtype = jax.dtypes.canonicalize_dtype(X_d.dtype)
    D = M_map.shape[1]
    M = D + 1
    M2 = 2 * M
    inv_c0_in = float(n * M)
    # The (replicated, constant) complexity matrix rides as a closure constant — a None
    # argument would not match shard_map's in_specs pytree.
    C_d = None if C_emb is None else jnp.asarray(np.asarray(C_emb))

    # Tensor parallelism over the "feature" axis: the three O(n·(2M)²) contractions
    # (pass-1 Gram columns, pass-2 sweep, pass-3 stats) split the 2M eigen/column
    # dimension across the axis. The eigh and Cholesky stay replicated (D³ is tiny).
    num_feature = mesh.shape.get("feature", 1)
    # Column/eigen padding so each feature-chip owns an equal block (zero-padded
    # eigenvector columns give Gu = W@0 = 0 and padded k/r entries are 0, so the
    # padded blocks contribute exactly nothing to any contraction).
    gram_cols = -(-(M2 + 1) // num_feature) * num_feature
    eig_cols = -(-M2 // num_feature) * num_feature

    def body(X_l, M_d, b_d, y_l, w_l, g_d):
        total_w = jax.lax.psum(jnp.sum(w_l), "data")
        s_l = w_l / total_w
        s2_l = s_l * s_l
        nb = X_l.shape[0] // row_chunk
        Xc = X_l.reshape(nb, row_chunk, -1)
        yc = y_l.reshape(nb, row_chunk)
        sc = s_l.reshape(nb, row_chunk)
        s2c = s2_l.reshape(nb, row_chunk)
        sign = jnp.concatenate([jnp.ones((M,), dtype), -jnp.ones((M,), dtype)])

        # Pass 1: local augmented Gram scan, then ONE cross-chip psum.
        if num_feature > 1:
            # Feature-sharded pass 1: each feature-chip contracts the full row
            # block against ITS column slice of Y (a (2M+1) × (2M+1)/F partial of
            # the augmented Gram), then one tiled all_gather over "feature"
            # reassembles the square before the replicated eigh. The W features
            # are recomputed per feature-chip — chunk·d·D FLOPs against the
            # chunk·(2M)²/F the slice saves, a ~d/(2M·F) overhead.
            f_idx = jax.lax.axis_index("feature")
            cols_g = gram_cols // num_feature
            zero = jnp.zeros((), jnp.int32)
            col0_g = (f_idx * cols_g).astype(jnp.int32)

            def gram_step(acc, chunk):
                X_b, y_b, s2_b = chunk
                W_b = _features_real_pair(X_b, M_d, b_d, precision=precision)
                Y_b = jnp.concatenate([W_b, y_b[:, None]], axis=1)
                Y_pad = jnp.pad(Y_b, ((0, 0), (0, gram_cols - (M2 + 1))))
                Y_loc = jax.lax.dynamic_slice(
                    Y_pad, (zero, col0_g), (Y_b.shape[0], cols_g)
                )
                return acc + jnp.dot(Y_b.T * s2_b[None, :], Y_loc, precision=precision), None

            G_cols_local, _ = jax.lax.scan(
                gram_step, jnp.zeros((M2 + 1, cols_g), dtype), (Xc, yc, s2c)
            )
            G_cols = jax.lax.psum(G_cols_local, "data")
            G_aug = jax.lax.all_gather(G_cols, "feature", axis=1, tiled=True)[
                :, : M2 + 1
            ]
            G = G_aug[:M2, :M2]
            b_vec = G_aug[:M2, M2]
        else:

            def gram_step(acc, chunk):
                X_b, y_b, s2_b = chunk
                W_b = _features_real_pair(X_b, M_d, b_d, precision=precision)
                Y_b = jnp.concatenate([W_b, y_b[:, None]], axis=1)
                return acc + jnp.dot(Y_b.T * s2_b[None, :], Y_b, precision=precision), None

            G_aug_local, _ = jax.lax.scan(
                gram_step, jnp.zeros((M2 + 1, M2 + 1), dtype), (Xc, yc, s2c)
            )
            G_aug = jax.lax.psum(G_aug_local, "data")
            G = G_aug[:M2, :M2]
            b_vec = G_aug[:M2, M2]
        B = embed_from_gram_blocks(G, M)
        lam, Qs, inv_c0 = _eigendecompose(
            B, C_d, jnp.asarray(inv_c0_in, dtype), sign
        )
        k = jnp.dot(Qs.T, b_vec, precision=precision)
        r_all = 1.0 / (g_d[None, :] + lam[:, None])
        if num_feature > 1:
            # Feature-sharded passes 2/3: each feature-chip owns a contiguous block
            # of eigenvector columns (zero-padded to divide evenly — padded columns
            # contribute exactly nothing, see above). The num/lev partials are
            # psummed over "feature" BEFORE the nonlinear LOO residual forms.
            f_idx = jax.lax.axis_index("feature")
            cols_e = eig_cols // num_feature
            zero_e = jnp.zeros((), jnp.int32)
            col0_e = (f_idx * cols_e).astype(jnp.int32)
            eig_pad = eig_cols - M2
            Qs_loc = jax.lax.dynamic_slice(
                jnp.pad(Qs, ((0, 0), (0, eig_pad))), (zero_e, col0_e), (M2, cols_e)
            )
            k_loc = jax.lax.dynamic_slice(jnp.pad(k, (0, eig_pad)), (col0_e,), (cols_e,))
            r_loc = jax.lax.dynamic_slice(
                jnp.pad(r_all, ((0, eig_pad), (0, 0))),
                (col0_e, zero_e),
                (cols_e, r_all.shape[1]),
            )
        else:
            Qs_loc, k_loc, r_loc = Qs, k, r_all

        # Pass 2: local γ-sweep partials, then ONE psum of the grid objective.
        def sweep_step(acc, chunk):
            X_b, y_b, s_b, s2_b = chunk
            W_b = _features_real_pair(X_b, M_d, b_d, precision=precision)
            Gu_b = jnp.dot(W_b, Qs_loc, precision=sweep_precision)
            num = inv_c0 * jnp.dot(Gu_b * k_loc[None, :], r_loc, precision=sweep_precision)
            lev = inv_c0 * s2_b[:, None] * jnp.dot(
                Gu_b * Gu_b, r_loc, precision=sweep_precision
            )
            if num_feature > 1:
                num = jax.lax.psum(num, "feature")
                lev = jax.lax.psum(lev, "feature")
            e = (num - y_b[:, None]) / (1.0 - lev)
            e = _clip_classifier_residuals(e, y_b, is_classifier)
            loo_err_b, obj_b = _sweep_objective(e, s_b, is_classifier)
            return (acc[0] + loo_err_b, acc[1] + obj_b), None

        zeros_g = jnp.zeros(g_d.shape[0], dtype)
        (loo_err_local, obj_local), _ = jax.lax.scan(
            sweep_step, (zeros_g, zeros_g), (Xc, yc, sc, s2c)
        )
        loo_errors_gs = jax.lax.psum(loo_err_local, "data")
        objective = jax.lax.psum(obj_local, "data")
        optimum = jnp.argmin(objective)
        gamma_opt = g_d[optimum]

        # Replicated Cholesky re-solve at the optimum.
        if C_d is None:
            B_reg = B + (gamma_opt / inv_c0_in) * jnp.eye(M2, dtype=dtype)
        else:
            B_reg = B + gamma_opt * C_d
        L = jax.scipy.linalg.cholesky(B_reg, lower=True)
        beta_emb = jax.scipy.linalg.cho_solve((L, True), sign * b_vec)

        # Pass 3: local per-row statistics at the optimum.
        r_opt = (1.0 / (gamma_opt + lam))[:, None]
        kr_opt = (k * r_opt[:, 0])[:, None]
        beta_j = sign * beta_emb
        if num_feature > 1:
            r_opt_loc = jax.lax.dynamic_slice(
                jnp.pad(r_opt, ((0, eig_pad), (0, 0))), (col0_e, zero_e), (cols_e, 1)
            )
            kr_opt_loc = jax.lax.dynamic_slice(
                jnp.pad(kr_opt, ((0, eig_pad), (0, 0))), (col0_e, zero_e), (cols_e, 1)
            )
        else:
            r_opt_loc, kr_opt_loc = r_opt, kr_opt

        def stats_step(_, chunk):
            X_b, y_b, s2_b = chunk
            W_b = _features_real_pair(X_b, M_d, b_d, precision=precision)
            Gu_b = jnp.dot(W_b, Qs_loc, precision=precision)
            num = inv_c0 * jnp.dot(Gu_b, kr_opt_loc, precision=precision)[:, 0]
            sig2 = inv_c0 * jnp.dot(Gu_b * Gu_b, r_opt_loc, precision=precision)[:, 0]
            if num_feature > 1:
                num = jax.lax.psum(num, "feature")
                sig2 = jax.lax.psum(sig2, "feature")
            lev = s2_b * sig2
            e_raw = (num - y_b) / (1.0 - lev)
            resid = jnp.dot(W_b, beta_j, precision=precision) - y_b
            return None, (e_raw, lev, sig2, resid)

        _, (e_raw_c, lev_c, sig2_c, resid_c) = jax.lax.scan(stats_step, None, (Xc, yc, s2c))
        e_raw = e_raw_c.reshape(-1)
        lev_opt = lev_c.reshape(-1)
        sigma2 = sig2_c.reshape(-1)
        residuals = _clip_classifier_residuals(resid_c.reshape(-1), y_l, is_classifier)
        e_clipped = _clip_classifier_residuals(e_raw, y_l, is_classifier)
        if is_classifier:
            correct = (jnp.sign(y_l + e_raw) == y_l).astype(dtype)
            loo_score = jax.lax.psum(s_l @ correct, "data")
        else:
            y_mean = jax.lax.psum(s_l @ y_l, "data")
            ss_res = jax.lax.psum(s_l @ (e_raw * e_raw), "data")
            dy = y_l - y_mean
            # Padding rows carry s=0, so they do not perturb the weighted moments.
            ss_tot = jax.lax.psum(s_l @ (dy * dy), "data")
            loo_score = 1.0 - ss_res / ss_tot
        loo_sigma2 = sigma2 + (s_l * sigma2) ** 2 / (1.0 - lev_opt)
        return {
            "beta_emb": beta_emb,
            "gamma": gamma_opt,
            "optimum_index": optimum,
            "lam": lam,
            "Qs": Qs,
            "loo_errors_gammas": loo_errors_gs,
            "loo_residuals": e_clipped,
            "loo_yhat": y_l + e_clipped,
            "loo_leverage": lev_opt,
            "loo_error": loo_errors_gs[optimum],
            "loo_score": loo_score,
            "loo_std": jnp.sqrt(loo_sigma2),
            "residuals": residuals,
        }

    row_spec = P("data")
    rep = P()
    out_specs = {
        "beta_emb": rep,
        "gamma": rep,
        "optimum_index": rep,
        "lam": rep,
        "Qs": rep,
        "loo_errors_gammas": rep,
        "loo_residuals": row_spec,
        "loo_yhat": row_spec,
        "loo_leverage": row_spec,
        "loo_error": rep,
        "loo_score": rep,
        "loo_std": row_spec,
        "residuals": row_spec,
    }
    in_specs = (P("data", None), rep, rep, row_spec, row_spec, rep)
    c_fingerprint = (
        None if C_emb is None else (np.asarray(C_emb).shape, hash(np.asarray(C_emb).tobytes()))
    )
    cache_key = (
        mesh,
        np.dtype(dtype).str,
        D,
        row_chunk,
        is_classifier,
        precision,
        sweep_precision,
        inv_c0_in,
        c_fingerprint,
    )
    fit_fn = _STREAMING_FIT_CACHE.get(cache_key)
    if fit_fn is None:
        if len(_STREAMING_FIT_CACHE) >= _STREAMING_FIT_CACHE_MAX:
            _STREAMING_FIT_CACHE.pop(next(iter(_STREAMING_FIT_CACHE)))
        fit_fn = jax.jit(_shard_map(body, mesh, in_specs, out_specs))
        _STREAMING_FIT_CACHE[cache_key] = fit_fn
    result = fit_fn(
        X_d,
        _stage_replicated(mesh, M_map),
        _stage_replicated(mesh, b_map),
        y_d,
        s_d,
        _stage_replicated(mesh, gammas),
    )
    return trim_per_row(result, n)
