"""End-to-end smoke test of Neo LS-SVM on one NVIDIA GPU (or a four-card mesh).

Runs the library's main path through the entry points a user calls, at the shipped
default deployment (ORFF with D = 512, a 1024-point γ grid, float32 data), and checks
every result against the repository's own references:

1. device: JAX must see a GPU; the card's name and power limit are printed;
2. parity: the primal fit (32,768×32) and the dual fit (n = 1,024) on the card
   against the float64 NumPy oracles of ``benchmark/oracle.py``;
3. regression at full size: ``NeoLSSVM().fit`` at 262,144×32 and 1,048,576×32, then
   every serving entry point from host arrays and from ``jax.Array``s;
4. the streaming solver against the in-memory solver on the same data, and a default
   fit large enough to take the streaming route;
5. classification: ``predict_proba`` is a calibrated, monotone probability;
6. the on-card tests marked ``gpu`` (``tests/test_gpu.py``).

``--four`` runs only the four-card phase instead: a row-sharded fit over a mesh of
four cards (``NeoLSSVM(mesh="auto")``) against a one-card fit of the same data.

Every tolerance is stated below and printed beside its figure. Any failed check ends
the run with a non-zero exit code. The last line of standard output is one JSON
object naming the device, printed only when every phase passed.

Usage (from the repository root, on a machine with an NVIDIA GPU):

    python chip_smoke.py [--seed N] [--four]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO_DIR = os.path.dirname(os.path.abspath(__file__))

# Tolerances. float32 on the card against a float64 oracle: the γ objective is
# smooth and flat near its minimum, so round-off may move the argmin by one grid step,
# or further along a plateau where the oracle's own LOO error is flat to round-off.
GAMMA_INDEX_TOL = 1  # grid steps
GAMMA_REGRET_RTOL = 1e-5  # oracle LOO error at the card's γ over the oracle's minimum, - 1
LOO_ERROR_RTOL = 1e-3  # relative
PREDICT_ATOL_STD = 1e-3  # × std(y)
# Streaming, in-memory and sharded solvers differ only in summation order (which may
# also move γ along a plateau of the LOO objective): ‖Δe‖₂ / ‖e‖₂ of the LOO residuals.
# At the grid's smallest γ the float32 Gram's summation order alone moves the LOO
# residuals by ~9e-4 of their norm on an H100; the bound leaves twice that.
RESID_RTOL = 2e-3
# Synthetic RBF regression (bench.make_dataset): the noise floor leaves LOO R² ≈ 0.75.
LOO_R2_FLOOR = 0.7
CLASSIFIER_LOO_ACCURACY_FLOOR = 0.7

PARITY_ROWS = 32_768
DUAL_ROWS = 1_024
FULL_SIZES = (262_144, 1_048_576)
STREAM_ROWS = 4_194_304
NUM_COLUMNS = 32
TEST_ROWS = 65_536
QUANTILES = (0.05, 0.5, 0.95)


class SmokeFailure(Exception):
    """A check failed; the message says which figure missed which bound."""


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    log(f"{'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        raise SmokeFailure(what)


def within(name: str, value: float, bound: float) -> None:
    check(bool(np.isfinite(value)) and value <= bound, f"{name} = {value:.6g} (bound {bound:.6g})")


def all_finite(name: str, arr) -> None:
    a = np.asarray(arr)
    check(bool(np.all(np.isfinite(a))), f"{name}: shape {a.shape}, all finite")


def timed(fn):
    """(result, seconds), the result ready on the device when the clock stops."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def peak_bytes() -> "int | None":
    """The first device's ``peak_bytes_in_use`` so far (None where not reported)."""
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def require_gpu():
    """Phase 1: the run happens on a GPU or not at all."""
    import jax

    devices = jax.devices()
    platform, backend = devices[0].platform, jax.default_backend()
    if platform != "gpu" or backend != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX's default backend is {backend!r} (first device {platform!r}); "
            "this smoke test runs only on an NVIDIA GPU"
        )
    log(f"device: {devices[0].device_kind}, count {len(devices)}")
    log(f"nvidia-smi name, power.limit: {card_name_and_power_limit()}")
    return devices


def make_data(n: int, seed: int, *, classify: bool = False):
    from bench import make_dataset

    X, y = make_dataset(n, NUM_COLUMNS, seed=seed)
    if classify:
        y = np.where(y > np.median(y), "pos", "neg")
    return X, y


def gamma_check(name: str, index: int, ref_index: int, ref_curve, max_steps: int) -> None:
    """γ index ``index`` is the reference's ``ref_index`` within ``max_steps`` grid steps,
    or lies on the reference's plateau: its LOO-error curve ``ref_curve`` is within
    GAMMA_REGRET_RTOL of its minimum there (a flat objective leaves the argmin to
    round-off)."""
    steps = abs(index - ref_index)
    regret = float(ref_curve[index] / ref_curve[ref_index] - 1.0)
    log(f"{name} γ index: {index} against {ref_index} ({steps} steps, bound {max_steps}); "
        f"reference LOO error there: +{regret:.3g} relative (bound {GAMMA_REGRET_RTOL})")
    check(steps <= max_steps or regret <= GAMMA_REGRET_RTOL, f"{name} γ")


def resid_check(name: str, e, e_ref) -> None:
    e, e_ref = np.asarray(e, np.float64), np.asarray(e_ref, np.float64)
    within(f"{name} LOO residuals ‖Δe‖/‖e‖",
           float(np.linalg.norm(e - e_ref) / np.linalg.norm(e_ref)), RESID_RTOL)


def phase_parity(seed: int, n: int = PARITY_ROWS, n_dual: int = DUAL_ROWS) -> None:
    """Phase 2: the card's float32 fits against the float64 NumPy oracles."""
    import jax.numpy as jnp

    from benchmark import oracle
    from neo_ls_svm_jax import NeoLSSVM
    from neo_ls_svm_jax.models.primal import gamma_grid, primal_decision_function, primal_fit
    from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures

    X, y = make_data(n, seed)
    X_new, _ = make_data(4096, seed + 1)
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    fmap = OrthogonalRandomFourierFeatures().fit(X64, y64, np.ones_like(y64))
    M_map, b_map = fmap.linear_map()
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    ours, fit_s = timed(
        lambda: primal_fit(
            f32(X), f32(M_map), f32(b_map), f32(y), f32(np.ones_like(y)),
            f32(gamma_grid(np.float32)), is_classifier=False,
        )
    )
    t0 = time.perf_counter()
    ref = oracle.numpy_reference_fit(fmap.transform(X64), y64, gamma_grid(np.float64))
    log(f"primal {n}x{NUM_COLUMNS}: card fit {fit_s:.3f}s (cold), "
        f"float64 oracle {time.perf_counter() - t0:.3f}s")
    gamma_check("primal", int(ours["optimum_index"]), ref["optimum_index"], ref["loo_errors"],
                GAMMA_INDEX_TOL)
    within("primal loo_error rel. diff",
           abs(float(ours["loo_error"]) - ref["loo_error"]) / ref["loo_error"], LOO_ERROR_RTOL)
    yhat = np.asarray(primal_decision_function(f32(X_new), f32(M_map), f32(b_map),
                                               ours["beta_emb"]))
    yhat_ref = oracle.primal_predict(fmap.transform(X_new.astype(np.float64)), ref["beta"])
    within("primal predict max|Δ| / std(y)", np.max(np.abs(yhat - yhat_ref)) / np.std(y64),
           PREDICT_ATOL_STD)

    Xd, yd = X[:n_dual], y[:n_dual]
    model = NeoLSSVM().fit(Xd, yd)
    check(bool(model.dual_), f"n = {n_dual} routes to the dual solver")
    X_t = np.asarray(model.X_, np.float64)
    ref_d = oracle.dual_fit(X_t, yd.astype(np.float64), np.asarray(model.γs_, np.float64))
    gamma_check("dual", int(np.argmin(np.abs(np.asarray(model.γs_) - model.γ_))),
                ref_d["optimum_index"], ref_d["loo_errors"], GAMMA_INDEX_TOL)
    within("dual loo_error rel. diff",
           abs(model.loo_error_ - ref_d["loo_error"]) / ref_d["loo_error"], LOO_ERROR_RTOL)
    X_new_t = np.asarray(model.dual_feature_map_.transform(X_new[:1024]), np.float64)
    within("dual predict max|Δ| / std(y)",
           np.max(np.abs(model.predict(X_new[:1024]) - oracle.dual_predict(
               X_new_t, X_t, ref_d["alpha"]))) / np.std(yd), PREDICT_ATOL_STD)


def fit_route(n: int) -> str:
    from neo_ls_svm_jax.models import estimator

    working_set = estimator._primal_working_set_bytes(n, 512, 4)
    threshold = estimator.streaming_bytes_threshold()
    return "streaming" if working_set > threshold else "inmemory"


def serve_and_check(model, X_test) -> None:
    """Every serving entry point from host arrays and from jax.Arrays, cold and warm."""
    import jax

    X_dev = jax.block_until_ready(jax.device_put(X_test))
    calls = {
        "predict": lambda X: model.predict(X),
        "predict_std": lambda X: model.predict_std(X),
        "predict_quantiles": lambda X: model.predict_quantiles(X, quantiles=QUANTILES),
        "predict_interval": lambda X: model.predict_interval(X, coverage=0.9),
    }
    for name, call in calls.items():
        for where, X in (("host", X_test), ("device", X_dev)):
            out, cold_s = timed(lambda: call(X))  # noqa: B023
            out, warm_s = timed(lambda: call(X))  # noqa: B023
            log(f"  {name}[{where}] {X.shape[0]} rows: cold {cold_s:.3f}s, warm {warm_s:.3f}s")
            if where == "device":
                check(isinstance(out, jax.Array), f"{name}[device] returns a jax.Array")
            all_finite(f"{name}[{where}]", out)
            out = np.asarray(out)
            if name == "predict_quantiles":
                check(bool(np.all(np.diff(out, axis=1) >= 0)), "quantiles monotone per row")
            if name == "predict_interval":
                check(bool(np.all(out[:, 1] >= out[:, 0])), "interval upper >= lower")


def phase_regression(seed: int, sizes=FULL_SIZES, n_test: int = TEST_ROWS) -> None:
    """Phase 3: default fits at full size, every serving entry point, the LOO API."""
    from neo_ls_svm_jax import NeoLSSVM

    X_test, _ = make_data(n_test, seed + 2)
    for n in sizes:
        X, y = make_data(n, seed)
        model, cold_s = timed(lambda: NeoLSSVM().fit(X, y))  # noqa: B023
        model, warm_s = timed(lambda: NeoLSSVM().fit(X, y))  # noqa: B023
        log(f"fit {n}x{NUM_COLUMNS}: route {fit_route(n)}, pre_transform "
            f"{model.pre_transform_}, cold {cold_s:.3f}s, warm {warm_s:.3f}s "
            f"(compile ≈ {cold_s - warm_s:.3f}s), peak_bytes_in_use {peak_bytes()}")
        for attr in ("loo_residuals_", "loo_ŷ_", "loo_std_", "loo_leverage_", "residuals_",
                     "loo_errors_γs_"):
            all_finite(attr, getattr(model, attr))
        within(f"1 - LOO R² at {n} rows (LOO R² {model.loo_score_:.4f})",
               1.0 - model.loo_score_, 1.0 - LOO_R2_FLOOR)
        serve_and_check(model, X_test)


def phase_streaming(seed: int, n: int = FULL_SIZES[0], n_stream: int = STREAM_ROWS,
                    row_chunk: int = 32_768) -> None:
    """Phase 4: streaming against in-memory on the same data, then a streaming fit."""
    import jax.numpy as jnp

    from neo_ls_svm_jax import NeoLSSVM
    from neo_ls_svm_jax.models.primal import gamma_grid, primal_fit, primal_fit_streaming
    from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures

    X, y = make_data(n, seed)
    s = np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures().fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    args = tuple(jnp.asarray(np.asarray(a, np.float32))
                 for a in (X, M_map, b_map, y, s, gamma_grid(np.float32)))
    dense, dense_s = timed(lambda: primal_fit(*args, is_classifier=False))
    streamed, stream_s = timed(
        lambda: primal_fit_streaming(*args, is_classifier=False, row_chunk=row_chunk)
    )
    log(f"in-memory {dense_s:.3f}s, streaming {stream_s:.3f}s (cold, {n} rows)")
    gamma_check("streaming vs in-memory", int(streamed["optimum_index"]),
                int(dense["optimum_index"]), np.asarray(dense["loo_errors_gammas"]), 0)
    resid_check("streaming vs in-memory", streamed["loo_residuals"], dense["loo_residuals"])

    X, y = make_data(n_stream, seed)
    check(fit_route(n_stream) == "streaming", f"{n_stream} rows take the streaming route")
    model, fit_s = timed(lambda: NeoLSSVM().fit(X, y))
    log(f"fit {n_stream}x{NUM_COLUMNS} (streaming): {fit_s:.3f}s cold, "
        f"peak_bytes_in_use {peak_bytes()}")
    all_finite("streaming loo_residuals_", model.loo_residuals_)
    within(f"1 - LOO R² at {n_stream} rows (LOO R² {model.loo_score_:.4f})",
           1.0 - model.loo_score_, 1.0 - LOO_R2_FLOOR)
    all_finite("streaming predict", model.predict(X[:TEST_ROWS]))


def phase_classification(seed: int, n: int = FULL_SIZES[0]) -> None:
    """Phase 5: binary classification through NeoLSSVM, calibrated probabilities."""
    import jax

    from neo_ls_svm_jax import NeoLSSVM

    X, y = make_data(n, seed, classify=True)
    model, fit_s = timed(lambda: NeoLSSVM().fit(X, y))
    log(f"classifier fit {n}x{NUM_COLUMNS}: {fit_s:.3f}s cold, LOO accuracy "
        f"{model.loo_score_:.4f}")
    within("1 - LOO accuracy", 1.0 - model.loo_score_, 1.0 - CLASSIFIER_LOO_ACCURACY_FLOOR)
    X_test = X[:TEST_ROWS]
    proba = np.asarray(model.predict_proba(X_test))
    decision = np.asarray(model.decision_function(X_test))
    check(proba.shape == (X_test.shape[0], 2), f"predict_proba shape {proba.shape}")
    check(bool(np.all((proba >= 0) & (proba <= 1))), "predict_proba within [0, 1]")
    order = np.argsort(decision, kind="stable")
    check(bool(np.all(np.diff(proba[order, 1]) >= 0)),
          "P(positive) non-decreasing in the decision function")
    proba_dev = model.predict_proba(jax.device_put(X_test))
    check(isinstance(proba_dev, jax.Array), "predict_proba[device] returns a jax.Array")
    within("predict_proba host vs device max|Δ|",
           float(np.max(np.abs(np.asarray(proba_dev) - proba))), 1e-5)


def phase_gpu_tests() -> None:
    """Phase 6: the tests marked ``gpu``, in this process (one process per card)."""
    import pytest

    os.environ["NEO_LS_SVM_GPU_TESTS"] = "1"
    # The warnings plugin stays off: the repository's warning filters name optional
    # packages (scikit-learn) that a GPU machine need not have.
    class Tally:
        passed = skipped = 0

        def pytest_runtest_logreport(self, report) -> None:
            if report.skipped:
                self.skipped += 1
            elif report.when == "call" and report.passed:
                self.passed += 1

    tally = Tally()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:xdist",
                      "-p", "no:warnings", "-rs",
                      os.path.join(REPO_DIR, "tests", "test_gpu.py")], plugins=[tally])
    check(rc == 0 and tally.passed > 0 and tally.skipped == 0,
          f"pytest -m gpu: exit code {int(rc)}, {tally.passed} passed, {tally.skipped} skipped")


def phase_four(seed: int, n: int = STREAM_ROWS) -> None:
    """Four cards: a row-sharded mesh fit against a one-card fit of the same data."""
    import jax

    from neo_ls_svm_jax import NeoLSSVM

    check(len(jax.devices()) == 4, f"four devices visible ({len(jax.devices())})")
    X, y = make_data(n, seed)
    sharded, mesh_s = timed(lambda: NeoLSSVM(mesh="auto").fit(X, y))
    log(f"mesh fit {n}x{NUM_COLUMNS}: mesh shape {dict(sharded.mesh_.shape)}, "
        f"{mesh_s:.3f}s cold, LOO R² {sharded.loo_score_:.4f}")
    single, single_s = timed(lambda: NeoLSSVM().fit(X, y))
    log(f"one-card fit: route {fit_route(n)}, {single_s:.3f}s cold, "
        f"LOO R² {single.loo_score_:.4f}")
    grid = np.asarray(single.γs_)
    gamma_check("mesh vs one card", int(np.argmin(np.abs(grid - sharded.γ_))),
                int(np.argmin(np.abs(grid - single.γ_))), np.asarray(single.loo_errors_γs_), 0)
    resid_check("mesh vs one card", sharded.loo_residuals_, single.loo_residuals_)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card mesh phase")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(REPO_DIR, "neo_ls_svm_jax")):
        print("[smoke] FAIL: chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO_DIR)
    try:
        devices = require_gpu()
        from neo_ls_svm_jax.utils.compilation_cache import enable_compilation_cache

        log(f"compilation cache: {enable_compilation_cache()}")
        phases = (
            [("four", phase_four)]
            if args.four
            else [
                ("parity", phase_parity),
                ("regression", phase_regression),
                ("streaming", phase_streaming),
                ("classification", phase_classification),
            ]
        )
        for name, phase in phases:
            t0 = time.perf_counter()
            log(f"--- phase {name}")
            phase(args.seed)
            log(f"--- phase {name} passed in {time.perf_counter() - t0:.1f}s")
        if not args.four:
            log("--- phase gpu_tests")
            phase_gpu_tests()
    except SmokeFailure as exc:
        print(f"[smoke] FAIL: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
