"""Parity tests for the random Fourier feature maps."""

import numpy as np
import pytest

from neo_ls_svm_jax.ops.orff import (
    OrthogonalRandomFourierFeatures,
    RandomFourierFeatures,
    complexity_sinc_matrix,
)

from .conftest import make_regression_dataset
from .reference_shim import import_reference

import_reference()
from neo_ls_svm._feature_maps import (  # noqa: E402
    OrthogonalRandomFourierFeatures as RefORFF,
    RandomFourierFeatures as RefRFF,
    _ztz_prod_sinc_zmz,
)


@pytest.mark.parametrize("cls_pair", [(RandomFourierFeatures, RefRFF), (OrthogonalRandomFourierFeatures, RefORFF)])
def test_feature_map_matches_reference(cls_pair) -> None:
    ours_cls, ref_cls = cls_pair
    X, y = make_regression_dataset(n=1500, seed=5)
    ours = ours_cls(num_features=64).fit(X, y)
    theirs = ref_cls(num_features=64).fit(X, y)
    np.testing.assert_allclose(ours.Z_, theirs.Z_, rtol=1e-12)
    X_new = np.random.RandomState(6).randn(200, X.shape[1])
    np.testing.assert_allclose(ours.transform(X_new), theirs.transform(X_new), rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(ours.complexity_matrix, theirs.complexity_matrix)


def test_orff_approximates_gaussian_kernel() -> None:
    # φ(x)ᴴφ(y) ≈ exp(-‖A(x-y)‖²/2) for an explicit metric A (fit folds Z into the
    # affine map, so the metric must be fixed up front to compare against the kernel).
    from neo_ls_svm_jax.ops.affine import AffineFeatureMap

    gen = np.random.RandomState(7)
    d = 6
    X = gen.randn(1200, d)
    A_metric = 0.5 * gen.randn(d, d)
    fmap = OrthogonalRandomFourierFeatures(
        affine_feature_map=AffineFeatureMap(scale=np.ones(d), shift=np.zeros(d), A=A_metric.copy()),
        num_features=4096,
    ).fit(X)
    X_s = X[:50]
    phi = fmap.transform(X_s)[:, :-1]  # Drop the bias column.
    approx = np.real(phi @ phi.conj().T)
    V = X_s @ A_metric
    sq = np.sum(V * V, axis=1, keepdims=True) - 2 * V @ V.T + np.sum(V * V, axis=1, keepdims=True).T
    exact = np.exp(-np.maximum(sq, 0) / 2)
    assert np.max(np.abs(approx - exact)) < 0.1
    assert np.mean(np.abs(approx - exact)) < 0.02


def test_linear_map_matches_transform() -> None:
    X, y = make_regression_dataset(n=1300, seed=8)
    fmap = OrthogonalRandomFourierFeatures(num_features=32).fit(X, y)
    M, b = fmap.linear_map()
    U = X @ M + b
    phi_expected = fmap.transform(X)
    np.testing.assert_allclose(
        np.exp(-1j * U) / np.sqrt(32), phi_expected[:, :-1], rtol=1e-9, atol=1e-12
    )


def test_complexity_sinc_matrix_matches_reference(rng) -> None:
    Z = rng.randn(6, 40)
    ours = np.asarray(complexity_sinc_matrix(Z, fast_approx=False))
    theirs = _ztz_prod_sinc_zmz(Z, fast_approx=False)
    np.testing.assert_allclose(ours, theirs, rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(
        np.asarray(complexity_sinc_matrix(Z, fast_approx=True)),
        _ztz_prod_sinc_zmz(Z, fast_approx=True),
    )


def test_set_params_num_features_is_respected() -> None:
    """set_params(num_features=...) must change the drawn feature count (sklearn
    grid-search clones then set_params — the reference desynchronises D here)."""
    X, y = make_regression_dataset(n=1300, seed=9)
    fmap = OrthogonalRandomFourierFeatures()
    fmap.set_params(num_features=128)
    fmap.fit(X, y)
    assert fmap.Z_.shape[1] == 128
    assert fmap.transform(X[:5]).shape == (5, 129)


def test_refit_is_idempotent_with_plain_affine_map() -> None:
    """Refitting on identical data must reproduce the identical transform — a plain
    AffineFeatureMap's fit validates but does not re-learn A_, so the fold must not
    compound into A @ Z @ Z2 (a silent corruption the reference shares)."""
    from neo_ls_svm_jax.ops.affine import AffineFeatureMap

    gen = np.random.RandomState(41)
    X = gen.randn(300, 5)
    y = gen.randn(300)
    A0 = gen.randn(5, 4)
    fmap = OrthogonalRandomFourierFeatures(
        affine_feature_map=AffineFeatureMap(
            scale=np.ones((1, 5)), shift=np.zeros((1, 5)), A=A0.copy()
        ),
        num_features=16,
    )
    fmap.fit(X, y, np.ones_like(y))
    first = fmap.transform(X[:10])
    assert fmap.affine_feature_map.A_.shape == (5, 16)
    fmap.fit(X, y, np.ones_like(y))
    second = fmap.transform(X[:10])
    assert fmap.affine_feature_map.A_.shape == (5, 16)
    np.testing.assert_array_equal(first, second)


def test_complexity_matrix_tracks_num_features_across_refits() -> None:
    """set_params(num_features=...) + refit must not serve a stale-shaped matrix."""
    gen = np.random.RandomState(42)
    X, y = gen.randn(300, 4), gen.randn(300)
    fmap = OrthogonalRandomFourierFeatures(num_features=16).fit(X, y, np.ones_like(y))
    assert fmap.complexity_matrix.shape == (17, 17)
    fmap.set_params(num_features=32)
    fmap.fit(X, y, np.ones_like(y))
    assert fmap.complexity_matrix.shape == (33, 33)
    np.testing.assert_array_equal(fmap.complexity_matrix, np.eye(33))


def test_refit_idempotent_after_pickle_roundtrip() -> None:
    """The fold-undo guard must survive serialization: a restored feature map with a
    plain (non-relearning) affine component must refit without double-folding."""
    import pickle

    from neo_ls_svm_jax.ops.affine import AffineFeatureMap

    gen = np.random.RandomState(43)
    X = gen.randn(300, 5)
    y = gen.randn(300)
    fmap = OrthogonalRandomFourierFeatures(
        affine_feature_map=AffineFeatureMap(
            scale=np.ones((1, 5)), shift=np.zeros((1, 5)), A=gen.randn(5, 4)
        ),
        num_features=16,
    ).fit(X, y, np.ones_like(y))
    first = fmap.transform(X[:10])
    restored = pickle.loads(pickle.dumps(fmap))
    restored.fit(X, y, np.ones_like(y))
    assert restored.affine_feature_map.A_.shape == (5, 16)
    np.testing.assert_array_equal(restored.transform(X[:10]), first)
