"""Auto routing of pre_transform / transfer (VERDICT r3 #3).

The default configuration must take the fast lane by itself: large eligible fits
route to the on-device pre-transform. ``transfer="auto"`` always keeps the lossless
float32 upload; the lossy modes are explicit opt-ins. ``pre_transform="host"``
remains the explicit bit-parity escape hatch, and small fits stay on it by default.
"""

import numpy as np
import pytest

import neo_ls_svm_jax.models.routing as routing_mod
from neo_ls_svm_jax import NeoLSSVM
from neo_ls_svm_jax.models.routing import AUTO_DEVICE_PT_MIN_BYTES, _resolve_fit_plan


# n=2000 keeps every fit on the primal route (threshold 1024) at ~half the
# fit wall of the old n=3000 (suite-wall budget, VERDICT r4 #7).
def _make_reg(n: int = 2000, d: int = 6, seed: int = 0):
    gen = np.random.RandomState(seed)
    X = gen.randn(n, d).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.5 * X[:, 1] + 0.1 * gen.randn(n)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("pre_transform", ["auto", "device"])
@pytest.mark.parametrize(
    "payload_bytes",
    [0, 1 << 20, AUTO_DEVICE_PT_MIN_BYTES, 128 * 1024**2, 4 * 1024**3],
)
def test_auto_transfer_always_resolves_float32(pre_transform, payload_bytes) -> None:
    """transfer='auto' never narrows the upload, whatever the payload size."""
    _, tr = _resolve_fit_plan(
        pre_transform, "auto", payload_bytes=payload_bytes, device_pt_eligible=True
    )
    assert tr == "float32"


class TestResolveFitPlan:
    def test_small_payload_stays_host(self) -> None:
        pt, tr = _resolve_fit_plan(
            "auto", "auto", payload_bytes=1 << 20, device_pt_eligible=True
        )
        assert (pt, tr) == ("host", "float32")

    def test_large_eligible_payload_routes_device(self) -> None:
        pt, tr = _resolve_fit_plan(
            "auto", "auto", payload_bytes=AUTO_DEVICE_PT_MIN_BYTES, device_pt_eligible=True
        )
        assert (pt, tr) == ("device", "float32")

    def test_ineligible_fit_stays_host_even_when_large(self) -> None:
        pt, tr = _resolve_fit_plan(
            "auto", "auto", payload_bytes=4 * AUTO_DEVICE_PT_MIN_BYTES, device_pt_eligible=False
        )
        assert (pt, tr) == ("host", "float32")

    def test_explicit_values_pass_through(self) -> None:
        pt, tr = _resolve_fit_plan(
            "host", "float32", payload_bytes=4 * AUTO_DEVICE_PT_MIN_BYTES, device_pt_eligible=True
        )
        assert (pt, tr) == ("host", "float32")
        for lossy in ("bfloat16", "int8"):
            pt, tr = _resolve_fit_plan(
                "device", lossy, payload_bytes=0, device_pt_eligible=True
            )
            assert (pt, tr) == ("device", lossy)


def test_default_small_fit_resolves_to_host_parity_path() -> None:
    X, y = _make_reg()
    model = NeoLSSVM().fit(X, y)
    assert model.pre_transform_ == "host"
    assert model.transfer_ == "float32"
    # Bit-parity invariant: the auto default at small n is exactly the host path.
    explicit = NeoLSSVM(pre_transform="host", transfer="float32").fit(X, y)
    np.testing.assert_array_equal(model.loo_residuals_, explicit.loo_residuals_)


def test_auto_routes_device_above_threshold(monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setattr(routing_mod, "AUTO_DEVICE_PT_MIN_BYTES", 1024)
    X, y = _make_reg()
    model = NeoLSSVM().fit(X, y)
    assert model.pre_transform_ == "device"
    assert model.transfer_ == "float32"
    assert model.score(X, y) > 0.5


def test_explicit_lossy_transfer_with_auto_host_resolution_raises() -> None:
    X, y = _make_reg()  # small payload: auto pre-transform resolves to host
    with pytest.raises(ValueError, match="on-device pre-transform"):
        NeoLSSVM(transfer="int8").fit(X, y)


def test_dual_route_resolves_host_float32() -> None:
    X, y = _make_reg(n=600)
    model = NeoLSSVM().fit(X, y)
    assert model.dual_
    assert (model.pre_transform_, model.transfer_) == ("host", "float32")


def test_resolved_plan_survives_state_dict_roundtrip(
    monkeypatch: pytest.MonkeyPatch,
) -> None:
    from neo_ls_svm_jax.utils.serialization import (
        model_from_state_dict,
        model_to_state_dict,
    )

    monkeypatch.setattr(routing_mod, "AUTO_DEVICE_PT_MIN_BYTES", 1024)
    X, y = _make_reg()
    model = NeoLSSVM().fit(X, y)
    restored = model_from_state_dict(model_to_state_dict(model))
    assert restored.pre_transform_ == model.pre_transform_ == "device"
    assert restored.transfer_ == model.transfer_
    np.testing.assert_allclose(restored.predict(X[:32]), model.predict(X[:32]), rtol=1e-5)


def test_pre_0_4_restored_model_predicts_without_transfer_attr() -> None:
    """Models fitted before the resolved-plan attributes existed (pre-0.4 pickles)
    lack ``transfer_``; host-path serving must fall back to the lossless f32 wire
    they were fitted with instead of raising AttributeError."""
    X, y = _make_reg()
    model = NeoLSSVM().fit(X, y)
    expected = np.asarray(model.predict(X[:32]))
    del model.transfer_  # simulate a pre-0.4 restore
    np.testing.assert_array_equal(np.asarray(model.predict(X[:32])), expected)


def test_explicit_device_on_ineligible_fit_reports_host() -> None:
    """An explicit pre_transform='device' on a fit that cannot take the device
    route (custom complexity matrix) falls back to host — and the fitted
    ``pre_transform_`` attribute must record the route actually taken."""
    from neo_ls_svm_jax.ops.orff import RandomFourierFeatures

    class CustomComplexity(RandomFourierFeatures):
        @property
        def complexity_matrix(self):
            return 2.0 * np.eye(self.D + 1, dtype=self.Z_.dtype)

    X, y = _make_reg()
    model = NeoLSSVM(
        pre_transform="device", primal_feature_map=CustomComplexity()
    ).fit(X, y)
    assert model.pre_transform_ == "host"
    assert model.score(X, y) > 0.5
