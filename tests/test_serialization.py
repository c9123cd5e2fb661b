"""Checkpoint/resume: state-dict and pickle round-trips preserve predictions."""

import pickle

import numpy as np
import pytest

from neo_ls_svm_jax import NeoLSSVM

from .conftest import make_classification_dataset, make_regression_dataset


@pytest.mark.parametrize("task,n", [("regression", 1500), ("classification", 1500),
                                    ("regression", 700), ("classification", 700)])
def test_state_dict_roundtrip(task, n) -> None:
    if task == "regression":
        X, y = make_regression_dataset(n=n, seed=51)
    else:
        X, y = make_classification_dataset(n=n, seed=51)
    model = NeoLSSVM().fit(X[:-200], y[:-200])
    X_test = X[-200:]
    # Fit a conformal predictor so the lazy caches round-trip too.
    iv_before = np.asarray(model.predict_interval(X_test, coverage=0.9))
    state = model.to_state_dict()
    restored = NeoLSSVM.from_state_dict(state)
    np.testing.assert_array_equal(restored.predict(X_test), model.predict(X_test))
    np.testing.assert_array_equal(
        np.asarray(restored.decision_function(X_test)), np.asarray(model.decision_function(X_test))
    )
    np.testing.assert_array_equal(
        np.asarray(restored.predict_std(X_test)), np.asarray(model.predict_std(X_test))
    )
    np.testing.assert_array_equal(np.asarray(restored.predict_interval(X_test, coverage=0.9)), iv_before)
    if task == "classification":
        np.testing.assert_array_equal(
            np.asarray(restored.predict_proba(X_test)), np.asarray(model.predict_proba(X_test))
        )
    np.testing.assert_array_equal(restored.loo_residuals_, model.loo_residuals_)
    assert restored.γ_ == model.γ_


def test_state_dict_is_arrays_and_scalars() -> None:
    X, y = make_regression_dataset(n=1300, seed=52)
    model = NeoLSSVM().fit(X, y)
    state = model.to_state_dict()

    def walk(node, path=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (tuple, list)):
            # Containers must hold serialisable leaves too (a tuple wrapping a
            # device handle would otherwise slip through).
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        else:
            assert (
                node is None
                or isinstance(node, (str, bool, int, float, np.generic, np.ndarray, np.dtype))
            ), f"non-serialisable leaf at {path}: {type(node)}"

    walk(state)


def test_pickle_roundtrip() -> None:
    X, y = make_classification_dataset(n=1400, seed=53)
    model = NeoLSSVM().fit(X[:-100], y[:-100])
    blob = pickle.dumps(model)
    restored = pickle.loads(blob)
    np.testing.assert_array_equal(restored.predict(X[-100:]), model.predict(X[-100:]))


def test_state_dict_warns_on_dropped_mesh_param() -> None:
    """A fitted-with-mesh model round-trips with an explicit warning that the mesh
    param restores as None (it is a live device resource, not state)."""
    import pytest

    from neo_ls_svm_jax.parallel.mesh import make_mesh

    X, y = make_regression_dataset(n=1500, seed=54)
    model = NeoLSSVM(mesh=make_mesh(num_data=8)).fit(X, y)
    with pytest.warns(UserWarning, match="mesh"):
        state = model.to_state_dict()
    restored = NeoLSSVM.from_state_dict(state)
    assert restored.mesh is None
    np.testing.assert_allclose(restored.predict(X[:50]), model.predict(X[:50]), rtol=1e-12)


class _SincORFF:
    """Deliberately defined OUTSIDE the serialization registry (module-level so the
    restore path can import it by module+qualname)."""


def test_state_dict_roundtrip_with_custom_feature_map_subclass() -> None:
    from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures

    global _SincORFF

    class _SincORFFImpl(OrthogonalRandomFourierFeatures):
        pass

    # Re-point the module-level name so module+qualname restore resolves.
    _SincORFFImpl.__qualname__ = "_SincORFF"
    _SincORFFImpl.__name__ = "_SincORFF"
    _SincORFF = _SincORFFImpl

    X, y = make_regression_dataset(n=1500, seed=55)
    model = NeoLSSVM(primal_feature_map=_SincORFF(num_features=64)).fit(X, y)
    state = model.to_state_dict()
    restored = NeoLSSVM.from_state_dict(state)
    assert type(restored.primal_feature_map_).__name__ == "_SincORFF"
    np.testing.assert_allclose(restored.predict(X[:50]), model.predict(X[:50]), rtol=1e-12)


def test_state_dict_restore_unimportable_class_raises_helpfully() -> None:
    X, y = make_regression_dataset(n=1500, seed=56)
    model = NeoLSSVM().fit(X, y)
    state = model.to_state_dict()
    state["components"]["primal_feature_map_"]["class"] = "NoSuchMap"
    state["components"]["primal_feature_map_"]["module"] = "no.such.module"
    state["components"]["primal_feature_map_"]["qualname"] = "NoSuchMap"
    import pytest

    with pytest.raises(ValueError, match="NoSuchMap"):
        NeoLSSVM.from_state_dict(state)


def test_dual_route_predict_std_and_interval_after_restore() -> None:
    """The dual route's train-state (X_, chol) must survive a restore and re-stage on
    device on first use (ref predict_std dual path _neo_ls_svm.py:470-475)."""
    X, y = make_regression_dataset(n=700, seed=57)
    model = NeoLSSVM().fit(X[:-100], y[:-100])
    assert model.dual_
    iv = np.asarray(model.predict_interval(X[-100:], coverage=0.9))
    restored = pickle.loads(pickle.dumps(model))
    np.testing.assert_array_equal(
        np.asarray(restored.predict_std(X[-100:])), np.asarray(model.predict_std(X[-100:]))
    )
    np.testing.assert_array_equal(np.asarray(restored.predict_interval(X[-100:], coverage=0.9)), iv)
