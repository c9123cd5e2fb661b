"""Serving: device-resident prediction and the opt-in narrow uploads.

The reference serves predictions through NumPy on the host
(ref _neo_ls_svm.py:719-762); on an accelerator a host-path predict also pays
for moving X on and off the device. This example shows the two answers:

1. **Device-resident serving**: pass a ``jax.Array`` to any predict-family
   method and the result stays on the accelerator (zero host round-trips),
   composable with the caller's own jitted pipeline stages.
2. **The opt-in `transfer` modes**: models fit with
   ``pre_transform="device", transfer="bfloat16"|"int8"`` upload features at
   half/quarter width — during fit AND for NumPy/pandas prediction batches.

Runs offline on CPU; on a machine with an NVIDIA GPU the same code runs there
unchanged.
"""

import os
import sys
import time

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

import jax.numpy as jnp  # noqa: E402

from neo_ls_svm_jax import NeoLSSVM  # noqa: E402


def main() -> None:
    gen = np.random.RandomState(0)
    n, d = 20_000, 16
    X = gen.randn(n, d).astype(np.float32)
    y = (X[:, :4] @ gen.randn(4) + 0.3 * np.sin(3 * X[:, 4]) + 0.1 * gen.randn(n)).astype(
        np.float32
    )
    X_train, X_serve = X[: n // 2], X[n // 2 :]
    y_train = y[: n // 2]

    model = NeoLSSVM().fit(X_train, y_train)

    # --- 1. Device-resident serving ----------------------------------------------
    # A serving pipeline keeps its feature batches on the accelerator; predictions
    # come back as jax.Array on the same backend with no host round-trip.
    X_dev = jax.device_put(X_serve)
    yhat_dev = model.predict(X_dev)
    assert isinstance(yhat_dev, jax.Array)
    # The full conformal stack is device-resident too (planes staged on first call):
    q_dev = model.predict_quantiles(X_dev, quantiles=(0.05, 0.5, 0.95))
    lo_hi = model.predict_interval(X_dev, coverage=0.9)
    # ... and composes with downstream jitted stages without leaving the chip:
    spread = jax.jit(lambda q: q[:, -1] - q[:, 0])(q_dev)
    print(
        f"device-resident: yhat {yhat_dev.shape}, quantiles {q_dev.shape}, "
        f"interval {lo_hi.shape}, median spread {float(jnp.median(spread)):.3f}"
    )

    # --- 2. The transfer wire policy ----------------------------------------------
    # When the upload (not accuracy) is the constraint, opt into a narrow upload:
    # features cross at bf16 (half) or int8 (quarter width, per-column
    # symmetric quantisation, dequantised on device). Fit and host-path predict
    # both honor it; targets/weights stay full precision.
    for transfer in ("float32", "bfloat16", "int8"):
        params = {} if transfer == "float32" else {
            "pre_transform": "device",
            "transfer": transfer,
        }
        m = NeoLSSVM(**params).fit(X_train, y_train)
        m.predict(X_serve)  # warm-up: JIT-compile off the clock
        t0 = time.perf_counter()
        yhat = m.predict(X_serve)  # NumPy in → NumPy out, uploads at the wire width
        dt = time.perf_counter() - t0
        err = float(np.sqrt(np.mean((yhat - y[n // 2 :]) ** 2)))
        print(f"transfer={transfer:9s}: predict {dt * 1e3:7.1f} ms  rmse {err:.4f}")


if __name__ == "__main__":
    main()
