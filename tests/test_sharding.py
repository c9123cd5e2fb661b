"""Multi-chip sharding tests on the 8-virtual-device CPU mesh."""

import jax
import numpy as np
import pytest

from neo_ls_svm_jax.models.primal import gamma_grid, primal_fit
from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures
from neo_ls_svm_jax.parallel.mesh import (
    make_mesh,
    required_padding,
    sharded_primal_fit,
    sharded_primal_fit_streaming,
)

from .conftest import make_regression_dataset


def test_virtual_device_count() -> None:
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sharded_primal_fit_matches_single_device(mesh_shape) -> None:
    X, y = make_regression_dataset(n=1500, seed=41)  # 1500 % 8 != 0 → exercises padding
    s = np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures(num_features=64).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)

    import jax.numpy as jnp

    single = primal_fit(
        jnp.asarray(X),
        jnp.asarray(M_map),
        jnp.asarray(b_map),
        jnp.asarray(y),
        jnp.asarray(s),
        jnp.asarray(gammas),
        is_classifier=False,
    )
    mesh = make_mesh(num_data=mesh_shape[0], num_feature=mesh_shape[1])
    sharded = sharded_primal_fit(
        mesh, X, M_map, b_map, y, s, gammas, is_classifier=False
    )
    assert float(sharded["gamma"]) == pytest.approx(float(single["gamma"]), rel=1e-12)
    np.testing.assert_allclose(
        np.asarray(sharded["loo_residuals"]), np.asarray(single["loo_residuals"]), rtol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(sharded["beta_emb"]), np.asarray(single["beta_emb"]), rtol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(sharded["loo_std"]), np.asarray(single["loo_std"]), rtol=1e-7
    )


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sharded_streaming_fit_matches_single_device(mesh_shape) -> None:
    """Sharding × streaming compose: per-chip row chunks, one Gram psum."""
    X, y = make_regression_dataset(n=1500, seed=43)
    s = np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures(num_features=64).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)

    import jax.numpy as jnp

    single = primal_fit(
        jnp.asarray(X),
        jnp.asarray(M_map),
        jnp.asarray(b_map),
        jnp.asarray(y),
        jnp.asarray(s),
        jnp.asarray(gammas),
        is_classifier=False,
    )
    mesh = make_mesh(num_data=mesh_shape[0], num_feature=mesh_shape[1])
    # row_chunk far below n/num_data → every chip runs a multi-step local scan.
    sharded = sharded_primal_fit_streaming(
        mesh, X, M_map, b_map, y, s, gammas, is_classifier=False, row_chunk=64
    )
    assert float(sharded["gamma"]) == pytest.approx(float(single["gamma"]), rel=1e-12)
    for key in ("loo_residuals", "beta_emb", "loo_std", "residuals", "loo_errors_gammas"):
        np.testing.assert_allclose(
            np.asarray(sharded[key]), np.asarray(single[key]), rtol=1e-6, atol=1e-12
        )
    assert float(sharded["loo_score"]) == pytest.approx(float(single["loo_score"]), rel=1e-9)


def test_sharded_streaming_feature_axis_partitions_contractions(monkeypatch) -> None:
    """The ``feature`` mesh axis must actually partition the O(n·(2M)²) contractions
    (VERDICT r4 #5): on a 2×4 mesh the traced program contains the pass-1 Gram
    all_gather and the pass-2/3 num/lev psums over "feature", the per-chip eigen
    block is 2M/4 wide (with zero-padding: D=64 → 2M+1=131 gram columns pad to 132),
    and the result still matches the single-chip oracle."""
    import jax.numpy as jnp

    from neo_ls_svm_jax.parallel import mesh as mesh_mod

    X, y = make_regression_dataset(n=1504, seed=47)
    s = np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures(num_features=64).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)
    single = primal_fit(
        jnp.asarray(X),
        jnp.asarray(M_map),
        jnp.asarray(b_map),
        jnp.asarray(y),
        jnp.asarray(s),
        jnp.asarray(gammas),
        is_classifier=False,
    )
    feature_psums = []
    feature_gathers = []
    real_psum, real_all_gather = jax.lax.psum, jax.lax.all_gather

    def spy_psum(x, axis_name, **kw):
        if axis_name == "feature":
            feature_psums.append(np.shape(x))
        return real_psum(x, axis_name, **kw)

    def spy_all_gather(x, axis_name, **kw):
        if axis_name == "feature":
            feature_gathers.append(np.shape(x))
        return real_all_gather(x, axis_name, **kw)

    monkeypatch.setattr(jax.lax, "psum", spy_psum)
    monkeypatch.setattr(jax.lax, "all_gather", spy_all_gather)
    mesh_mod._STREAMING_FIT_CACHE.clear()  # force a fresh trace under the spies
    mesh = make_mesh(num_data=2, num_feature=4)
    sharded = sharded_primal_fit_streaming(
        mesh, X, M_map, b_map, y, s, gammas, is_classifier=False, row_chunk=94
    )
    # Pass-1 Gram columns reassemble with one all_gather of a (131, 33) block.
    assert feature_gathers == [(131, 33)]
    # Pass-2 sweep num+lev and pass-3 num+sig2 psum over "feature" (4 sites).
    assert len(feature_psums) == 4
    # The sweep partials are (row_chunk, |γ-grid|): the contraction really ran on
    # the 2M/4-wide local eigen block before the collective.
    assert feature_psums[0] == (94, gammas.shape[0])
    assert float(sharded["gamma"]) == pytest.approx(float(single["gamma"]), rel=1e-12)
    for key in ("loo_residuals", "beta_emb", "loo_std", "residuals", "loo_errors_gammas"):
        np.testing.assert_allclose(
            np.asarray(sharded[key]), np.asarray(single[key]), rtol=1e-6, atol=1e-12
        )



def test_estimator_mesh_auto_streams_when_working_set_large(monkeypatch) -> None:
    """NeoLSSVM(mesh=...) routes to the sharded streaming fit above the per-chip
    working-set threshold."""
    import neo_ls_svm_jax.models.estimator as est_mod
    from neo_ls_svm_jax import NeoLSSVM

    X, y = make_regression_dataset(n=1500, seed=44)
    single = NeoLSSVM().fit(X, y)
    monkeypatch.setattr(est_mod, "STREAMING_BYTES_THRESHOLD", 1)  # force streaming
    mesh = make_mesh(num_data=8, num_feature=1)
    sharded = NeoLSSVM(mesh=mesh).fit(X, y)
    assert sharded.γ_ == pytest.approx(single.γ_, rel=1e-12)
    np.testing.assert_allclose(sharded.loo_residuals_, single.loo_residuals_, rtol=1e-6)
    np.testing.assert_allclose(sharded.predict(X[:100]), single.predict(X[:100]), rtol=1e-6)


def test_multihost_mesh_helpers_single_process() -> None:
    """Single-process behaviour of the multi-process scaffolding: init is a no-op and
    the mesh factory lays every visible device out as a flat ("data", "feature") grid."""
    from neo_ls_svm_jax.parallel.distributed import initialize_distributed

    assert initialize_distributed() is False
    mesh = make_mesh(num_feature=2)
    assert mesh.shape == {"data": 4, "feature": 2}


def test_required_padding() -> None:
    assert required_padding(1500, 8) == 4
    assert required_padding(1600, 8) == 0


def test_estimator_mesh_fit_matches_single_device() -> None:
    """NeoLSSVM(mesh=...) runs the multi-chip primal fit through the public API."""
    from neo_ls_svm_jax import NeoLSSVM

    X, y = make_regression_dataset(n=1500, seed=42)
    single = NeoLSSVM().fit(X, y)
    mesh = make_mesh(num_data=8, num_feature=1)
    sharded = NeoLSSVM(mesh=mesh).fit(X, y)
    assert sharded.γ_ == single.γ_
    np.testing.assert_allclose(sharded.loo_residuals_, single.loo_residuals_, rtol=1e-7)
    np.testing.assert_allclose(
        sharded.predict(X[:100]), single.predict(X[:100]), rtol=1e-7
    )


def test_mesh_fit_conformal_serving_matches_single_device() -> None:
    """Conformal serving composes with mesh fits: the calibration split and the CQR
    planes are functions of the fit result only, so a mesh fit must produce the same
    calibrated quantiles/intervals as the single-device fit it parity-matches."""
    from neo_ls_svm_jax import NeoLSSVM

    X, y = make_regression_dataset(n=1500, seed=45)
    y = np.abs(y) + 10.0  # price-like positive target (conformal coverage convention)
    single = NeoLSSVM().fit(X, y)
    sharded = NeoLSSVM(mesh=make_mesh(num_data=8, num_feature=1)).fit(X, y)
    q_s = np.asarray(sharded.predict_quantiles(X[:100]))
    q_1 = np.asarray(single.predict_quantiles(X[:100]))
    np.testing.assert_allclose(q_s, q_1, rtol=1e-6, atol=1e-9)
    iv = np.asarray(sharded.predict_interval(X[:100], coverage=0.9))
    np.testing.assert_allclose(
        iv, np.asarray(single.predict_interval(X[:100], coverage=0.9)), rtol=1e-6, atol=1e-9
    )
    assert np.all(np.diff(q_s, axis=1) >= -1e-9)


def test_mesh_route_keeps_normalizer_stats_on_host(monkeypatch) -> None:
    """The mesh route stages X sharded inside the sharded fit; the normalizer must not
    duplicate the full matrix onto one chip for its statistics."""
    import neo_ls_svm_jax.ops.affine as affine_mod
    from neo_ls_svm_jax import NeoLSSVM

    monkeypatch.setattr(affine_mod, "DEVICE_STATS_MIN_ROWS", 1)  # would trigger unhinted
    calls = {"n": 0}
    real = affine_mod._normalizer_fit_device

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(affine_mod, "_normalizer_fit_device", counting)
    X, y = make_regression_dataset(n=1500, seed=44)
    mesh = make_mesh(num_data=8, num_feature=1)
    model = NeoLSSVM(mesh=mesh).fit(X, y)
    assert calls["n"] == 0, "mesh fits must take the host statistics path"
    assert model.loo_score_ > 0.5


def test_sharded_streaming_fit_compiles_once() -> None:
    """Repeated sharded-streaming fits with the same config must reuse the compiled
    program instead of retracing a fresh closure every call."""
    from neo_ls_svm_jax.parallel import mesh as mesh_mod

    X, y = make_regression_dataset(n=1024, seed=51)
    s = np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures(num_features=32).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)
    mesh = make_mesh(num_data=8, num_feature=1)
    mesh_mod._STREAMING_FIT_CACHE.clear()
    r1 = sharded_primal_fit_streaming(
        mesh, X, M_map, b_map, y, s, gammas, is_classifier=False
    )
    assert len(mesh_mod._STREAMING_FIT_CACHE) == 1
    r2 = sharded_primal_fit_streaming(
        mesh, X, M_map, b_map, y, s, gammas, is_classifier=False
    )
    assert len(mesh_mod._STREAMING_FIT_CACHE) == 1  # cache hit, no new entry
    np.testing.assert_allclose(
        np.asarray(r1["loo_residuals"]), np.asarray(r2["loo_residuals"]), rtol=0
    )



def test_mesh_device_pretransform_matches_single_chip_device_pt() -> None:
    """mesh + pre_transform='device' composes (VERDICT r3 #3): the pre-transform runs
    as a GSPMD program over the row shards and feeds the sharded solver; scores must
    match the single-chip device-pre-transform fit (same JAX RNG seed → same draw)."""
    from neo_ls_svm_jax import NeoLSSVM

    X, y = make_regression_dataset(n=1500, seed=45)
    single = NeoLSSVM(pre_transform="device").fit(X, y)
    mesh = make_mesh(num_data=8, num_feature=1)
    sharded = NeoLSSVM(pre_transform="device", mesh=mesh).fit(X, y)
    assert sharded.pre_transform_ == "device"
    assert float(sharded.loo_score_) == pytest.approx(float(single.loo_score_), abs=2e-2)
    # Same seed → same on-device draw; only cross-chip reduction order may differ.
    np.testing.assert_allclose(
        sharded.predict(X[:100]), single.predict(X[:100]), rtol=1e-4, atol=1e-6
    )


def test_mesh_device_pretransform_streaming_route() -> None:
    """The sharded streaming solver also composes with the device pre-transform."""
    import neo_ls_svm_jax.models.estimator as est_mod
    from neo_ls_svm_jax import NeoLSSVM

    X, y = make_regression_dataset(n=1500, seed=46)
    mesh = make_mesh(num_data=8, num_feature=1)
    single = NeoLSSVM(pre_transform="device").fit(X, y)
    import pytest as _pytest

    mp = _pytest.MonkeyPatch()
    try:
        mp.setattr(est_mod, "STREAMING_BYTES_THRESHOLD", 1)  # force per-chip streaming
        sharded = NeoLSSVM(pre_transform="device", mesh=mesh).fit(X, y)
    finally:
        mp.undo()
    assert float(sharded.loo_score_) == pytest.approx(float(single.loo_score_), abs=2e-2)
    assert np.isfinite(sharded.loo_std_).all()


def test_mesh_auto_matches_explicit_mesh() -> None:
    """NeoLSSVM(mesh='auto') builds the device mesh itself (VERDICT r3 #7)."""
    from neo_ls_svm_jax import NeoLSSVM

    X, y = make_regression_dataset(n=1500, seed=47)
    explicit = NeoLSSVM(mesh=make_mesh()).fit(X, y)
    auto = NeoLSSVM(mesh="auto").fit(X, y)
    assert auto.mesh_.shape == explicit.mesh_.shape
    assert auto.γ_ == explicit.γ_
    np.testing.assert_allclose(auto.loo_residuals_, explicit.loo_residuals_, rtol=1e-12)


def test_invalid_mesh_value_raises() -> None:
    from neo_ls_svm_jax import NeoLSSVM

    X, y = make_regression_dataset(n=1500, seed=48)
    with pytest.raises(ValueError, match="mesh"):
        NeoLSSVM(mesh="all-devices").fit(X, y)


def test_mesh_auto_single_device_falls_back_to_single_chip(
    monkeypatch: pytest.MonkeyPatch,
) -> None:
    """mesh='auto' with one visible device resolves to the single-chip route
    (mesh_=None): 'auto' means best-available, and single-chip keeps the
    narrow-wire transfer lanes a degenerate 1-chip mesh would forbid."""
    import jax

    import neo_ls_svm_jax.models.estimator as est_mod
    from neo_ls_svm_jax import NeoLSSVM

    X, y = make_regression_dataset(n=1500, seed=49)
    one_device = jax.devices()[:1]
    monkeypatch.setattr(est_mod.jax, "devices", lambda *a: one_device)
    model = NeoLSSVM(mesh="auto").fit(X, y)
    assert model.mesh_ is None
    assert model.score(X, y) > 0.5
