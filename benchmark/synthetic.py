"""Offline benchmark suite: NeoLSSVM vs classic SVMs on synthetic tabular tasks.

Mirrors the protocol of the reference's benchmark scripts
(``benchmark/classification.py`` / ``benchmark/regression.py``: 85/15 split, default
hyperparameters, single fit, score + fit wall-clock) on a spread of synthetic datasets
that exercise the regimes the AutoML-Benchmark datasets cover — heterogeneous feature
scales, heteroskedastic noise, redundant features, class imbalance — without requiring
network access to OpenML.

Scoring mirrors the reference exactly: ROC-AUC via ``predict_proba`` for binary tasks
(ref ``benchmark/classification.py:110-112``), R² via ``score`` for regression (ref
``benchmark/regression.py:102``), plus fit wall-clock seconds. Results go to stdout as
a table and to ``--json`` as machine-readable records (model × task). LightGBM, the
reference's third baseline, is not installed in this environment and is skipped.

Usage: python benchmark/synthetic.py [--quick] [--skip-reference] [--json PATH]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root


def _gen(seed):
    return np.random.RandomState(seed)


def make_task(name: str, seed: int = 0):
    g = _gen(seed)
    if name == "scales":  # wildly heterogeneous feature scales (clf)
        X = g.randn(4000, 12) * np.logspace(-3, 3, 12)
        z = X[:, 0] * 1e3 + np.sin(X[:, 6]) + 0.5 * g.randn(4000)
        return X, np.where(z > 0, "a", "b"), "clf"
    if name == "xor":  # interaction-dominated decision boundary (clf)
        X = g.randn(5000, 8)
        z = X[:, 0] * X[:, 1] + 0.3 * g.randn(5000)
        return X, np.where(z > 0, "pos", "neg"), "clf"
    if name == "imbalanced":  # 10:1 class imbalance (clf)
        X = g.randn(6000, 10)
        z = X[:, 0] + 0.7 * X[:, 1] - 1.8 + 0.4 * g.randn(6000)
        return X, np.where(z > 0, "rare", "common"), "clf"
    if name == "small-dual":  # n ≤ 1024 → dual route (clf)
        X = g.randn(800, 6)
        z = np.sin(X[:, 0]) + X[:, 1] * X[:, 2] + 0.3 * g.randn(800)
        return X, np.where(z > 0, "y", "n"), "clf"
    if name == "prices":  # positive skewed target (reg)
        X = g.randn(6000, 10)
        y = np.exp(0.4 * np.sin(X[:, 0]) + 0.2 * X[:, 1] + 0.1 * g.randn(6000)) * 100
        return X, y, "reg"
    if name == "hetero":  # heteroskedastic noise (reg)
        X = g.randn(5000, 8)
        y = 10 + np.sin(X[:, 0]) + 0.5 * X[:, 1] + (0.2 + 0.4 * np.abs(X[:, 5])) * g.randn(5000)
        return X, y, "reg"
    if name == "redundant":  # correlated/redundant features (reg)
        Z = g.randn(4000, 4)
        X = np.hstack([Z, Z @ g.randn(4, 12) + 0.05 * g.randn(4000, 12)])
        y = 5 + Z[:, 0] ** 2 + Z[:, 1] + 0.2 * g.randn(4000)
        return X, y, "reg"
    if name == "small-reg":  # n ≤ 1024 → dual route (reg)
        X = g.randn(900, 5)
        y = 3 + np.abs(X[:, 0]) + 0.5 * X[:, 1] + 0.2 * g.randn(900)
        return X, y, "reg"
    raise ValueError(name)


TASKS = ["scales", "xor", "imbalanced", "small-dual", "prices", "hetero", "redundant", "small-reg"]


def _import_reference():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    from reference_shim import import_reference  # noqa: PLC0415

    import_reference()
    from neo_ls_svm import NeoLSSVM as RefNeoLSSVM  # noqa: PLC0415

    return RefNeoLSSVM


def _evaluate(model_name: str, fit_fn, X_tr, y_tr, X_te, y_te, kind: str) -> dict:
    """Fit + score one model on one task with the reference's metric protocol.

    A warm-up fit precedes the timed fit (the reference's scripts do the same for
    their first dataset, ref benchmark/classification.py:102-105); on the accelerator this keeps
    one-off XLA compilation out of the steady-state timing.
    """
    from neo_ls_svm_jax.utils.metrics import r2_score, roc_auc_score

    fit_fn(X_tr, y_tr)  # warm-up (JIT compile / BLAS warm)
    t0 = time.perf_counter()
    model = fit_fn(X_tr, y_tr)
    fit_s = time.perf_counter() - t0
    record = {"model": model_name, "fit_seconds": round(fit_s, 3)}
    if kind == "clf":
        proba = model.predict_proba(X_te)
        record["roc_auc"] = round(float(roc_auc_score(y_te, np.asarray(proba)[:, 1])), 4)
        record["accuracy"] = round(float(np.mean(model.predict(X_te) == y_te)), 4)
    else:
        record["r2"] = round(float(r2_score(y_te, np.asarray(model.predict(X_te)))), 4)
    return record


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--skip-reference", action="store_true")
    parser.add_argument("--json", default=None, help="write records to this path")
    args = parser.parse_args()

    from sklearn.svm import SVC, SVR

    from neo_ls_svm_jax import NeoLSSVM
    from neo_ls_svm_jax.utils.compilation_cache import enable_compilation_cache

    enable_compilation_cache()  # repeat runs skip the cold XLA compiles entirely
    RefNeoLSSVM = None if args.skip_reference else _import_reference()

    tasks = TASKS[:4] if args.quick else TASKS
    records = []
    for name in tasks:
        X, y, kind = make_task(name)
        split = int(0.85 * len(y))
        X_tr, y_tr, X_te, y_te = X[:split], y[:split], X[split:], y[split:]
        contenders = [("neo-ls-svm-jax", lambda X_, y_: NeoLSSVM().fit(X_, y_))]
        if RefNeoLSSVM is not None:
            contenders.append(("neo-ls-svm (reference)", lambda X_, y_: RefNeoLSSVM().fit(X_, y_)))
        if kind == "clf":
            contenders.append(("SVC", lambda X_, y_: SVC(probability=True).fit(X_, y_)))
        else:
            contenders.append(("SVR", lambda X_, y_: SVR().fit(X_, y_)))
        for model_name, fit_fn in contenders:
            record = {"task": name, "kind": kind, "n": len(y), "d": X.shape[1]}
            record.update(_evaluate(model_name, fit_fn, X_tr, y_tr, X_te, y_te, kind))
            records.append(record)
            print(json.dumps(record))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
