"""Quickstart: classification, regression, and conformal prediction.

Mirrors the reference README's usage examples (ref README.md:28-135) on synthetic data
so it runs offline. On a machine with an NVIDIA GPU, the solver runs there
automatically; on CPU it runs under XLA just the same.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # run from a checkout

import jax  # noqa: E402

# Some environments pre-register an accelerator platform before env vars apply;
# honor an explicit CPU request by switching the backend in-process.
if os.environ.get("JAX_PLATFORMS", "") == "cpu":
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass

from neo_ls_svm_jax import NeoLSSVM  # noqa: E402


def main() -> None:
    gen = np.random.RandomState(0)

    # --- Binary classification ---------------------------------------------------
    scales = np.logspace(-1, 2, 10)  # heterogeneous feature scales
    X = gen.randn(4000, 10) * scales
    signal = X[:, 0] / scales[0] + np.sin(X[:, 1] / scales[1]) + X[:, 2] / scales[2] * X[:, 3] / scales[3]
    churn = np.where(signal + 0.4 * gen.randn(4000) > 0, "yes", "no")
    X_train, X_test = X[:3400], X[3400:]
    y_train, y_test = churn[:3400], churn[3400:]

    clf = NeoLSSVM().fit(X_train, y_train)
    print(f"classification accuracy: {clf.score(X_test, y_test):.1%}")
    print(f"free leave-one-out estimate (no extra work): {clf.loo_score_:.1%}")
    proba = clf.predict_proba(X_test)  # isotonically calibrated
    print(f"P(churn=yes) for the first row: {proba[0, 1]:.2f}")

    # --- Regression with conformal uncertainty -----------------------------------
    area = np.exp(gen.randn(5000) * 0.4 + 7)
    quality = gen.randint(1, 11, 5000).astype(float)
    Xr = np.column_stack([area, quality, gen.randn(5000, 4)])
    price = area * (25 + 4 * quality) + 5000 * gen.randn(5000)
    Xr_train, Xr_test = Xr[:4250], Xr[4250:]
    yr_train, yr_test = price[:4250], price[4250:]

    reg = NeoLSSVM().fit(Xr_train, yr_train)
    print(f"\nregression R²: {reg.score(Xr_test, yr_test):.1%}")

    # Conformally calibrated quantiles and intervals:
    quantiles = reg.predict_quantiles(Xr_test, quantiles=(0.025, 0.5, 0.975))
    interval = reg.predict_interval(Xr_test, coverage=0.95)
    covered = np.mean((interval[:, 0] <= yr_test) & (yr_test <= interval[:, 1]))
    print(f"95% interval empirical coverage: {covered:.1%}")
    print(f"median prediction for the first row: {quantiles[0, 1]:,.0f}")

    # Bayesian nonconformity score:
    print(f"predict_std head: {np.round(np.asarray(reg.predict_std(Xr_test[:3])), 1)}")

    # Checkpoint and restore:
    restored = NeoLSSVM.from_state_dict(reg.to_state_dict())
    assert np.array_equal(restored.predict(Xr_test), reg.predict(Xr_test))
    print("checkpoint round-trip: OK")

    # Device-resident serving: a jax.Array input stays on the accelerator — the
    # prediction comes back as a jax.Array with zero host round-trips.
    import jax.numpy as jnp

    on_device = reg.predict(jnp.asarray(Xr_test))
    print(f"device-resident predict: {type(on_device).__name__}, shape {on_device.shape}")


if __name__ == "__main__":
    main()
