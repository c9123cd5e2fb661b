"""Parity tests for the supervised affine pre-transform stack."""

import numpy as np
import pytest

from neo_ls_svm_jax.ops.affine import (
    AffineFeatureMap,
    AffineNormalizer,
    AffineSeparator,
    nearest_neighbours,
    right_singular_vectors,
    squared_distances,
)

from .conftest import make_classification_dataset, make_regression_dataset
from .reference_shim import import_reference

import_reference()
from neo_ls_svm._affine_feature_map import AffineFeatureMap as RefAffineFeatureMap  # noqa: E402
from neo_ls_svm._affine_normalizer import AffineNormalizer as RefAffineNormalizer  # noqa: E402
from neo_ls_svm._affine_separator import (  # noqa: E402
    AffineSeparator as RefAffineSeparator,
    _faster_svd,
    pairwise_distances as ref_pairwise_distances,
)


def test_affine_feature_map_matches_reference(rng) -> None:
    X = rng.randn(100, 5)
    scale = rng.rand(5) + 0.5
    shift = rng.randn(5)
    A = rng.randn(5, 7)
    for kwargs in (
        {"scale": scale, "shift": shift, "A": None},
        {"scale": scale, "shift": shift, "A": A},
        {"scale": scale, "shift": shift, "A": A, "append_features": True},
        {"scale": scale, "shift": shift, "A": rng.randn(5, 3)},  # tall branch
    ):
        ours = AffineFeatureMap(**kwargs).fit(X)
        theirs = RefAffineFeatureMap(**kwargs).fit(X)
        np.testing.assert_allclose(ours.transform(X), theirs.transform(X), rtol=1e-12)


def test_affine_feature_map_inverse_roundtrip(rng) -> None:
    X = rng.randn(60, 4)
    fmap = AffineFeatureMap(scale=rng.rand(4) + 0.5, shift=rng.randn(4), A=rng.randn(4, 4))
    fmap.fit(X)
    np.testing.assert_allclose(fmap.inverse_transform(fmap.transform(X)), X, rtol=1e-8)


def test_affine_feature_map_linear_form(rng) -> None:
    X = rng.randn(50, 5)
    fmap = AffineFeatureMap(scale=rng.rand(5) + 0.5, shift=rng.randn(5), A=rng.randn(5, 9))
    fmap.fit(X)
    M, offset, _ = fmap.linear_form(5)
    np.testing.assert_allclose(X @ M + offset, fmap.transform(X), rtol=1e-10)


def test_helpers_match_reference(rng) -> None:
    X, Y = rng.randn(40, 6), rng.randn(30, 6)
    np.testing.assert_allclose(squared_distances(X, Y), ref_pairwise_distances(X, Y), rtol=1e-10)
    tall, fat = rng.randn(50, 6), rng.randn(6, 50)
    for m in (tall, fat):
        s_ours, v_ours = right_singular_vectors(m)
        s_ref, v_ref = _faster_svd(m)
        np.testing.assert_allclose(s_ours, s_ref, rtol=1e-10)
        np.testing.assert_allclose(np.abs(v_ours), np.abs(v_ref), rtol=1e-8, atol=1e-10)
    nn = nearest_neighbours(X, Y)
    assert nn.shape == X.shape


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_affine_normalizer_matches_reference(task) -> None:
    if task == "regression":
        X, y = make_regression_dataset(n=1500, seed=1)
    else:
        X, y_raw = make_classification_dataset(n=1500, seed=1)
        y = np.where(y_raw == "pos", 1.0, -1.0)
    ours = AffineNormalizer().fit(X, y)
    theirs = RefAffineNormalizer().fit(X, y)
    np.testing.assert_allclose(ours.shift_, theirs.shift_, rtol=1e-10)
    np.testing.assert_allclose(ours.scale_, theirs.scale_, rtol=1e-10)


@pytest.mark.parametrize("task", ["regression", "classification"])
@pytest.mark.parametrize("weighted", [False, True])
def test_affine_separator_matches_reference(task, weighted) -> None:
    if task == "regression":
        X, y = make_regression_dataset(n=1500, seed=2)
    else:
        X, y_raw = make_classification_dataset(n=1500, seed=2)
        y = np.where(y_raw == "pos", 1.0, -1.0)
    w = np.random.RandomState(3).rand(len(y)) + 0.1 if weighted else None
    ours = AffineSeparator().fit(X, y, sample_weight=w)
    theirs = RefAffineSeparator().fit(X, y, sample_weight=None if w is None else w.copy())
    np.testing.assert_allclose(ours.shift_, theirs.shift_, rtol=1e-9)
    np.testing.assert_allclose(ours.scale_, theirs.scale_, rtol=1e-9)
    np.testing.assert_allclose(ours.A_, theirs.A_, rtol=1e-7, atol=1e-10)
    X_new = np.random.RandomState(4).randn(100, X.shape[1])
    np.testing.assert_allclose(ours.transform(X_new), theirs.transform(X_new), rtol=1e-7, atol=1e-10)


def test_affine_separator_single_bin() -> None:
    X = np.random.RandomState(0).randn(200, 3)
    y = np.ones(200)
    sep = AffineSeparator().fit(X, y)
    # Identity pre-transform: no A learned, zero shift, unit scale.
    assert getattr(sep, "A_", None) is None
    np.testing.assert_array_equal(sep.shift_, np.zeros((1, 3)))
    np.testing.assert_array_equal(sep.scale_, np.ones((1, 3)))


def test_device_normalizer_stats_match_host(monkeypatch) -> None:
    """The device fast path for normalizer statistics is numerically equivalent."""
    import neo_ls_svm_jax.ops.affine as aff

    gen = np.random.RandomState(9)
    n, d = 5000, 6
    X = gen.randn(n, d) * np.logspace(-1, 1, d)
    y = np.sin(X[:, 0]) + 0.3 * gen.randn(n)
    w = gen.rand(n) + 0.2
    host = aff.AffineNormalizer().fit(X, y, w)
    monkeypatch.setattr(aff, "DEVICE_STATS_MIN_ROWS", 1)
    dev = aff.AffineNormalizer().fit(X, y, w)
    np.testing.assert_allclose(dev.shift_, host.shift_, rtol=1e-10)
    np.testing.assert_allclose(dev.scale_, host.scale_, rtol=1e-10)


def test_device_normalizer_stats_with_staged_padded_x(monkeypatch) -> None:
    """The hinted device path gathers from an already-staged, row/column-padded X."""
    import jax.numpy as jnp

    import neo_ls_svm_jax.ops.affine as aff

    gen = np.random.RandomState(10)
    n, d = 4000, 5
    X = gen.randn(n, d) * np.logspace(-1, 1, d)
    y = np.sin(X[:, 0]) + 0.3 * gen.randn(n)
    w = gen.rand(n) + 0.2
    host = aff.AffineNormalizer().fit(X, y, w)
    monkeypatch.setattr(aff, "DEVICE_STATS_HINTED_MIN_ROWS", 1)
    dev = aff.AffineNormalizer()
    dev._device_X_hint = jnp.asarray(np.pad(X, ((0, 96), (0, 3))))  # solver-style padding
    dev.fit(X, y, w)
    np.testing.assert_allclose(dev.shift_, host.shift_, rtol=1e-10)
    np.testing.assert_allclose(dev.scale_, host.scale_, rtol=1e-10)


def test_separator_device_hint_matches_host_end_to_end(monkeypatch) -> None:
    """A hinted separator fit (device normalizer stats inside) matches the host fit to
    float tolerance, and the hint does not leak into the fitted object."""
    import jax.numpy as jnp

    import neo_ls_svm_jax.ops.affine as aff

    gen = np.random.RandomState(11)
    n, d = 3000, 4
    X = gen.randn(n, d)
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] + 0.1 * gen.randn(n)
    host = aff.AffineSeparator().fit(X, y)
    monkeypatch.setattr(aff, "DEVICE_STATS_HINTED_MIN_ROWS", 1)
    dev = aff.AffineSeparator()
    dev._device_X_hint = jnp.asarray(X)
    dev.fit(X, y)
    del dev._device_X_hint
    np.testing.assert_allclose(dev.shift_, host.shift_, rtol=1e-9)
    np.testing.assert_allclose(dev.scale_, host.scale_, rtol=1e-9)
    # Same RNG draws downstream → A_ agrees to float tolerance.
    assert dev.A_.shape == host.A_.shape
    np.testing.assert_allclose(dev.A_, host.A_, rtol=1e-6, atol=1e-9)
    # No device buffers may leak onto the fitted attributes (jax.Array IS picklable,
    # so a pickle smoke test cannot catch this — inspect the object directly).
    import jax

    leaked = [k for k, v in dev.__dict__.items() if isinstance(v, jax.Array)]
    assert not leaked, f"device arrays left on the fitted separator: {leaked}"
    for name in ("shift_", "scale_", "A_"):
        assert isinstance(getattr(dev, name), np.ndarray)


def test_grouped_weighted_median_semantics() -> None:
    """The sort-free grouped median reproduces weighted_quantile's averaged
    lower/upper ECDF convention (ref _weighted_quantile.py:56-75), including the
    reference's canonical tie example and dummy (heavily tied) columns."""
    import jax.numpy as jnp

    from neo_ls_svm_jax.ops.affine import grouped_weighted_median
    from neo_ls_svm_jax.ops.weighted_quantile import weighted_quantile

    # Canonical example: a=(0,1,1), w=(2,1,1) → 0.5 (not the midpoint convention).
    X = np.array([[0.0], [1.0], [1.0]])
    w = np.array([2.0, 1.0, 1.0])
    codes = np.zeros(3, np.int32)
    med = np.asarray(grouped_weighted_median(jnp.asarray(X), jnp.asarray(w), jnp.asarray(codes), 1))
    assert med[0, 0] == 0.5

    # Random continuous + dummy columns, multiple bins, uniform weights.
    gen = np.random.RandomState(12)
    n = 4001
    Xc = np.column_stack(
        [gen.randn(n), np.exp(gen.randn(n)), (gen.rand(n) < 0.3).astype(float), gen.randn(n) * 1e-3]
    )
    codes = gen.randint(0, 3, n).astype(np.int32)
    w = np.ones(n)
    med = np.asarray(grouped_weighted_median(jnp.asarray(Xc), jnp.asarray(w), jnp.asarray(codes), 3))
    for b in range(3):
        m = codes == b
        expected = weighted_quantile(Xc[m], np.broadcast_to(w[m][:, None], Xc[m].shape), 0.5, axis=0)
        np.testing.assert_allclose(med[b], np.ravel(expected), rtol=1e-12, atol=1e-15)

    # Non-uniform weights on untied continuous data.
    w2 = gen.rand(n) + 0.1
    med2 = np.asarray(grouped_weighted_median(jnp.asarray(Xc[:, :2]), jnp.asarray(w2), jnp.asarray(codes), 3))
    for b in range(3):
        m = codes == b
        expected = weighted_quantile(Xc[m, :2], np.broadcast_to(w2[m][:, None], (m.sum(), 2)), 0.5, axis=0)
        np.testing.assert_allclose(med2[b], np.ravel(expected), rtol=1e-12, atol=1e-15)

    # Zero-weight rows are excluded; out-of-range codes are excluded.
    w3 = np.ones(n); w3[Xc[:, 0] > 0] = 0.0
    med3 = np.asarray(grouped_weighted_median(jnp.asarray(Xc[:, :1]), jnp.asarray(w3), jnp.asarray(codes), 3))
    for b in range(3):
        m = (codes == b) & (w3 > 0)
        expected = weighted_quantile(Xc[m, :1], np.ones((m.sum(), 1)), 0.5, axis=0)
        np.testing.assert_allclose(med3[b], np.ravel(expected), rtol=1e-12)
