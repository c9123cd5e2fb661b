"""Checkpoint/resume: fitted models ⇄ nested dicts of plain arrays.

The reference persists models only through sklearn-style pickling of fitted attributes
(SURVEY.md §5.4). This module adds an explicit ``to_state_dict``/``from_state_dict``
protocol producing a nested dict of NumPy arrays and scalars — directly storable with
``orbax.checkpoint`` (PyTreeCheckpointer), np.savez, or JSON+arrays — while pickle
keeps working as before.
"""

import importlib
import warnings
from typing import Any

import numpy as np

from neo_ls_svm_jax.utils.base import BaseEstimator


def _component_state(obj: BaseEstimator) -> dict[str, Any]:
    """Constructor params + fitted ``*_`` attributes of a leaf component."""
    fitted = {}
    for name, value in vars(obj).items():
        if name.endswith("_") and not name.startswith("_"):
            fitted[name] = value
    params = {
        # Nested estimator params are carried as separate component states.
        k: (None if isinstance(v, BaseEstimator) else v)
        for k, v in obj.get_params(deep=False).items()
    }
    return {
        "class": type(obj).__name__,
        # Module/qualname let non-registry subclasses (e.g. a custom feature map)
        # round-trip, provided their defining module is importable at restore time.
        "module": type(obj).__module__,
        "qualname": type(obj).__qualname__,
        "params": params,
        "fitted": fitted,
    }


def _restore_component(state: dict[str, Any], registry: dict[str, type]) -> BaseEstimator:
    cls = registry.get(state["class"])
    if cls is None:
        module, qualname = state.get("module"), state.get("qualname")
        try:
            target: Any = importlib.import_module(module)
            for part in qualname.split("."):
                target = getattr(target, part)
            cls = target
        except (ImportError, AttributeError, TypeError) as error:
            msg = (
                f"Cannot restore component {state['class']!r}: not in the built-in "
                f"registry and {module}.{qualname} is not importable. Make the class's "
                f"defining module importable, or restore via pickle instead."
            )
            raise ValueError(msg) from error
    obj = cls(**state["params"])
    for name, value in state["fitted"].items():
        setattr(obj, name, value)
    return obj


def _registry() -> dict[str, type]:
    from neo_ls_svm_jax.models.cqr import CoherentLinearQuantileRegressor
    from neo_ls_svm_jax.models.isotonic import IsotonicCalibrator
    from neo_ls_svm_jax.ops.affine import AffineFeatureMap, AffineNormalizer, AffineSeparator
    from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures, RandomFourierFeatures

    return {
        c.__name__: c
        for c in (
            AffineFeatureMap,
            AffineNormalizer,
            AffineSeparator,
            OrthogonalRandomFourierFeatures,
            RandomFourierFeatures,
            CoherentLinearQuantileRegressor,
            IsotonicCalibrator,
        )
    }


def model_to_state_dict(model: Any) -> dict[str, Any]:
    """Serialise a fitted ``NeoLSSVM`` into a nested dict of arrays/scalars."""
    materialize = getattr(model, "_materialize_result", None)
    if callable(materialize):
        materialize()  # lazily-held device results must land in vars(model) first
    def _storable(v: Any) -> bool:
        return v is None or isinstance(v, (str, bool, int, float, np.generic, np.ndarray, tuple))

    # Ephemeral resources (e.g. a device Mesh) are not part of the persisted state;
    # restored models default them (re-attach a mesh by setting the param afterwards).
    simple_params = {}
    dropped = []
    for k, v in model.get_params(deep=False).items():
        if isinstance(v, BaseEstimator):
            continue
        simple_params[k] = v if _storable(v) else None
        if not _storable(v):
            dropped.append(k)
    if dropped:
        warnings.warn(
            f"Parameters {dropped} are not storable in a state dict and will restore "
            f"as None (e.g. re-attach a device mesh with set_params after restoring).",
            UserWarning,
            stacklevel=2,
        )
    component_params = {
        k: _component_state(v)
        for k, v in model.get_params(deep=False).items()
        if isinstance(v, BaseEstimator)
    }
    state: dict[str, Any] = {
        "format_version": 1,
        "params": simple_params,
        "component_params": component_params,
        "meta": {
            "estimator_type": model._estimator_type,
            "y_dtype": np.dtype(model.y_dtype_).str,
        },
        "attrs": {},
        "components": {},
        "conformal": {"l1": {}, "l2": {}},
    }
    skip = {"conformal_l1_", "conformal_l2_", "primal_feature_map_", "dual_feature_map_",
            "predict_proba_calibrator_", "y_dtype_",
            # A device Mesh is an ephemeral runtime resource, not model state;
            # restored models re-resolve it from the (string/None) `mesh` param.
            "mesh_"}
    private_state = ("_M_map", "_b_map", "_eig_Qs", "_eig_lam", "_inv_c0", "_chol")
    for name, value in vars(model).items():
        keep = (name.endswith("_") and not name.startswith("__")) or name in private_state
        if name in skip or not keep:
            continue
        state["attrs"][name] = value
    for comp in ("primal_feature_map_", "dual_feature_map_", "predict_proba_calibrator_"):
        if hasattr(model, comp):
            obj = getattr(model, comp)
            state["components"][comp] = _component_state(obj)
            if comp.endswith("feature_map_") and hasattr(obj, "affine_feature_map"):
                state["components"][comp]["affine"] = _component_state(obj.affine_feature_map)
    for target_type, fitted in getattr(model, "conformal_l1_", {}).items():
        for key, cqr in fitted.items():
            state["conformal"]["l1"][f"{target_type}|{','.join(map(str, key))}"] = (
                _component_state(cqr)
            )
    for target_type, biases in getattr(model, "conformal_l2_", {}).items():
        for key, bias in biases.items():
            state["conformal"]["l2"][f"{target_type}|{','.join(map(str, key))}"] = bias
    return state


def model_from_state_dict(state: dict[str, Any]) -> Any:
    """Reconstruct a fitted ``NeoLSSVM`` from :func:`model_to_state_dict` output."""
    from neo_ls_svm_jax.models.estimator import NeoLSSVM

    registry = _registry()
    params = dict(state["params"])
    for k, comp_state in state.get("component_params", {}).items():
        params[k] = _restore_component(comp_state, registry)
    model = NeoLSSVM(**params)
    model._estimator_type = state["meta"]["estimator_type"]
    model.y_dtype_ = np.dtype(state["meta"]["y_dtype"])
    for name, value in state["attrs"].items():
        setattr(model, name, value)
    for comp, comp_state in state["components"].items():
        obj = _restore_component(comp_state, registry)
        if "affine" in comp_state:
            obj.affine_feature_map = _restore_component(comp_state["affine"], registry)
        setattr(model, comp, obj)
    model.conformal_l1_ = {"Δŷ": {}, "Δŷ/ŷ": {}}
    model.conformal_l2_ = {"Δŷ": {}, "Δŷ/ŷ": {}}
    for joint_key, cqr_state in state["conformal"]["l1"].items():
        target_type, _, quantile_str = joint_key.partition("|")
        key = tuple(float(q) for q in quantile_str.split(","))
        model.conformal_l1_[target_type][key] = _restore_component(cqr_state, registry)
    for joint_key, bias in state["conformal"]["l2"].items():
        target_type, _, quantile_str = joint_key.partition("|")
        key = tuple(float(q) for q in quantile_str.split(","))
        model.conformal_l2_[target_type][key] = bias
    return model
