"""AutoML-Benchmark harness — mirrors the reference's benchmark scripts exactly.

The reference's README tables come from ``benchmark/classification.py`` and
``benchmark/regression.py`` (ref ``benchmark/classification.py:22-63,92-98``,
``benchmark/regression.py:22-56``): every AutoML-Benchmark binary-classification /
regression dataset, fetched from OpenML by (name, version), 85/15 split with
``random_state=42``, skrub ``TableVectorizer`` preprocessing, default
hyperparameters, single timed fit, ROC-AUC via ``predict_proba`` (classification,
ref ``:110-112``) or R² (regression, ref ``regression.py:102``).

This module is the shared engine behind this repo's ``benchmark/classification.py``
and ``benchmark/regression.py``. It reproduces the reference's protocol verbatim —
same dataset lists, same skip rules (training matrices over 1M cells are skipped,
ref ``classification.py:92-94``; the SVM baseline is skipped above 10k rows, ref
``:95-98``), same warm-up-the-first-dataset trick (ref ``:102-105``), same
comparison-table format — with three environment adaptations:

* **Network gating**: this build environment has no egress (openml.org does not
  resolve); when OpenML is unreachable the harness either skips cleanly or, with
  ``--smoke``, runs the synthetic fallback suite (``benchmark/synthetic.py``'s
  tasks) through the identical pipeline/scoring/table code path so the harness
  itself is exercised offline.
* **Optional dependencies**: skrub and LightGBM are used when importable and
  skipped (with a note) otherwise; the skrub fallback is a sklearn-only
  median-impute + missing-indicator + one-hot vectorizer mirroring the reference's
  ``TableVectorizer`` configuration (ref ``classification.py:66-68``).
* **Recorded output**: in addition to the reference's printed markdown table,
  records append to ``benchmark/results.json`` in this repo's schema
  (task/kind/n/d/model/fit_seconds/score fields).
"""

import argparse
import json
import os
import socket
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo root

RESULTS_PATH = os.path.join(os.path.dirname(__file__), "results.json")

# AutoML binary-classification suite (ref benchmark/classification.py:22-63; the two
# commented-out datasets are excluded there too).
CLASSIFICATION_TASKS = [
    ("ada", 1),
    ("adult", 4),
    ("airlines", 1),
    ("Amazon_employee_access", 1),
    ("APSFailure", 1),
    ("arcene", 2),
    ("Australian", 4),
    ("bank-marketing", 1),
    ("Bioresponse", 1),
    ("blood-transfusion-service-center", 1),
    ("christine", 1),
    ("churn", 1),
    ("Click_prediction_small", 10),
    ("gina", 1),
    ("guillermo", 1),
    ("Higgs", 3),
    ("Internet-Advertisements", 2),
    ("jasmine", 1),
    ("kc1", 1),
    ("KDDCup09_appetency", 1),
    ("kick", 1),
    ("kr-vs-kp", 1),
    ("madeline", 1),
    ("MiniBooNE", 1),
    ("nomao", 1),
    ("numerai28.6", 2),
    ("ozone-level-8hr", 1),
    ("pc4", 1),
    ("philippine", 1),
    ("PhishingWebsites", 1),
    ("phoneme", 1),
    ("porto-seguro", 3),
    ("qsar-biodeg", 1),
    ("riccardo", 1),
    ("Satellite", 1),
    ("sf-police-incidents", 6),
    ("sylvine", 1),
    ("wilt", 2),
]

# AutoML regression suite (ref benchmark/regression.py:22-56).
REGRESSION_TASKS = [
    ("abalone", 5),
    ("Airlines_DepDelay_10M", 1),
    ("Allstate_Claims_Severity", 1),
    ("black_friday", 1),
    ("boston", 1),
    ("Brazilian_houses", 4),
    ("Buzzinsocialmedia_Twitter", 1),
    ("colleges", 14),
    ("diamonds", 1),
    ("elevators", 1),
    ("house_16H", 1),
    ("house_prices_nominal", 1),
    ("house_sales", 3),
    ("Mercedes_Benz_Greener_Manufacturing", 2),
    ("MIP-2016-regression", 3),
    ("Moneyball", 2),
    ("nyc-taxi-green-dec-2016", 3),
    ("OnlineNewsPopularity", 2),
    ("pol", 1),
    ("QSAR-TID-10980", 1),
    ("QSAR-TID-11", 1),
    ("quake", 2),
    ("Santander_transaction_value", 1),
    ("SAT11-HAND-runtime-regression", 1),
    ("sensory", 1),
    ("socmob", 1),
    ("space_ga", 1),
    ("tecator", 1),
    ("topo_2_1", 1),
    ("us_crime", 2),
    ("wine_quality", 1),
    ("Yolanda", 2),
    ("yprop_4_1", 1),
]

MAX_TRAIN_CELLS = 1_000_000  # ref classification.py:92-94
MAX_SVM_ROWS = 10_000  # ref classification.py:95-98


def online(host: str = "openml.org", timeout: float = 5.0) -> bool:
    """True when OpenML is reachable (same gate as tests/test_real_data.py)."""
    try:
        socket.getaddrinfo(host, 443)
    except OSError:
        return False
    return True


def make_vectorizer():
    """skrub TableVectorizer configured like the reference (ref classification.py:66-68),
    or an sklearn-only equivalent when skrub is unavailable."""
    from sklearn.impute import MissingIndicator, SimpleImputer
    from sklearn.pipeline import make_union
    from sklearn.preprocessing import OneHotEncoder

    num = make_union(
        SimpleImputer(strategy="median"), MissingIndicator(error_on_new=False)
    )
    ohe = OneHotEncoder(drop=None, handle_unknown="infrequent_if_exist")
    try:
        from skrub import TableVectorizer  # noqa: PLC0415

        return TableVectorizer(
            numerical_transformer=num, low_cardinality_transformer=ohe
        )
    except ImportError:
        import pandas as pd  # noqa: PLC0415
        from sklearn.base import BaseEstimator, TransformerMixin  # noqa: PLC0415
        from sklearn.compose import make_column_transformer  # noqa: PLC0415
        from sklearn.pipeline import make_pipeline  # noqa: PLC0415

        class MinimalTableVectorizer(TransformerMixin, BaseEstimator):
            """sklearn-only stand-in: numeric → median-impute + missing indicator,
            non-numeric → most-frequent-impute + one-hot (the reference's
            TableVectorizer configuration, minus skrub's datetime/high-cardinality
            handling)."""

            def fit(self, X, y=None):
                X = pd.DataFrame(X)
                num_cols = list(X.select_dtypes(include=np.number).columns)
                cat_cols = [c for c in X.columns if c not in num_cols]
                self.transformer_ = make_column_transformer(
                    (num, num_cols),
                    (
                        make_pipeline(
                            SimpleImputer(strategy="most_frequent"),
                            OneHotEncoder(
                                handle_unknown="infrequent_if_exist",
                                sparse_output=False,
                            ),
                        ),
                        cat_cols,
                    ),
                )
                self.transformer_.fit(X)
                return self

            def transform(self, X):
                out = self.transformer_.transform(pd.DataFrame(X))
                return np.asarray(out, dtype=np.float64)

        return MinimalTableVectorizer()


def build_models(kind: str) -> list[dict]:
    """The reference's three contenders (ref classification.py:69-74) plus the
    reference implementation itself when importable, each as a fresh-pipeline factory."""
    from sklearn.pipeline import make_pipeline
    from sklearn.svm import SVC, SVR

    from neo_ls_svm_jax import NeoLSSVM

    def ours():
        return make_pipeline(make_vectorizer(), NeoLSSVM())

    models = [{"name": "NeoLSSVM", "factory": ours, "svm_limited": False}]
    tests_dir = os.path.join(os.path.dirname(__file__), "..", "tests")
    try:
        # Scoped insert: tests/ must not stay on sys.path (its module names —
        # conftest, reference_shim — would shadow same-named imports later).
        sys.path.insert(0, tests_dir)
        try:
            from reference_shim import import_reference  # noqa: PLC0415

            import_reference()
        finally:
            sys.path.remove(tests_dir)
        from neo_ls_svm import NeoLSSVM as RefNeoLSSVM  # noqa: PLC0415

        models.append(
            {
                "name": "NeoLSSVM (reference)",
                "factory": lambda: make_pipeline(make_vectorizer(), RefNeoLSSVM()),
                "svm_limited": False,
            }
        )
    except Exception as exc:  # pragma: no cover - optional contender
        print(f"[automl] reference implementation unavailable: {exc}", file=sys.stderr)
    if kind == "clf":
        models.append(
            {
                "name": "SVC",
                "factory": lambda: make_pipeline(make_vectorizer(), SVC(probability=True)),
                "svm_limited": True,
            }
        )
    else:
        models.append(
            {
                "name": "SVR",
                "factory": lambda: make_pipeline(make_vectorizer(), SVR()),
                "svm_limited": True,
            }
        )
    try:
        if kind == "clf":
            from lightgbm import LGBMClassifier  # noqa: PLC0415

            models.append(
                {
                    "name": "LGBMClassifier",
                    "factory": lambda: LGBMClassifier(verbosity=-1),
                    "svm_limited": False,
                }
            )
        else:
            from lightgbm import LGBMRegressor  # noqa: PLC0415

            models.append(
                {
                    "name": "LGBMRegressor",
                    "factory": lambda: LGBMRegressor(verbosity=-1),
                    "svm_limited": False,
                }
            )
    except ImportError:
        print("[automl] LightGBM not installed; skipping that contender", file=sys.stderr)
    return models


def evaluate_task(
    task_name: str,
    X,
    y,
    kind: str,
    models: list[dict],
    *,
    warm_up: bool,
) -> list[dict]:
    """85/15 split, per-model timed fit + score (the reference's inner loop,
    ref classification.py:86-113)."""
    from sklearn.base import clone as sk_clone
    from sklearn.model_selection import train_test_split

    from neo_ls_svm_jax.utils.metrics import r2_score, roc_auc_score

    X_train, X_test, y_train, y_test = train_test_split(
        X, y, test_size=0.15, random_state=42
    )
    records = []
    for model in models:
        n_train = len(X_train)
        size = getattr(X_train, "size", n_train * np.shape(X_train)[-1])
        if size > MAX_TRAIN_CELLS:
            print(f"[automl] {task_name}/{model['name']}: skipped (>1M cells)", file=sys.stderr)
            continue
        if model["svm_limited"] and n_train > MAX_SVM_ROWS:
            print(
                f"[automl] {task_name}/{model['name']}: skipped (>10k rows for SVM)",
                file=sys.stderr,
            )
            continue
        pipeline = model["factory"]()
        if warm_up:  # first dataset warms JIT/BLAS off the clock (ref :102-105)
            try:
                sk_clone(pipeline).fit(X_train, y_train)
            except TypeError:  # non-sklearn pipeline (bare LGBM)
                model["factory"]().fit(X_train, y_train)
        t0 = time.perf_counter()
        pipeline.fit(X_train, y_train)
        fit_s = time.perf_counter() - t0
        record = {
            "task": task_name,
            "kind": kind,
            "n": int(np.shape(X)[0]),
            "d": int(np.shape(X)[1]) if np.ndim(X) > 1 else 1,
            "model": model["name"],
            "fit_seconds": round(fit_s, 3),
        }
        if kind == "clf":
            proba = np.asarray(pipeline.predict_proba(X_test))
            record["roc_auc"] = round(float(roc_auc_score(y_test, proba[:, 1])), 4)
            record["accuracy"] = round(
                float(np.mean(np.asarray(pipeline.predict(X_test)) == np.asarray(y_test))), 4
            )
        else:
            pred = np.asarray(pipeline.predict(X_test), dtype=np.float64)
            record["r2"] = round(float(r2_score(np.asarray(y_test, np.float64), pred)), 4)
        records.append(record)
        print(json.dumps(record), flush=True)
    return records


def comparison_table(records: list[dict], score_key: str) -> str:
    """The reference's medal-annotated markdown comparison table
    (ref classification.py:120-139)."""
    tasks = sorted({r["task"] for r in records})
    model_names = sorted({r["model"] for r in records})
    lines = ["| dataset | " + " | ".join(model_names) + " |"]
    lines.append("|" + "---|" * (len(model_names) + 1))
    for task in tasks:
        row = {r["model"]: r for r in records if r["task"] == task}
        scored = sorted(
            (name for name in row if score_key in row[name]),
            key=lambda name: -row[name][score_key],
        )
        cells = []
        for name in model_names:
            if name not in row or score_key not in row[name]:
                cells.append("/")
                continue
            value = f"{100 * row[name][score_key]:.1f}% ({row[name]['fit_seconds']:.1f}s)"
            if scored and name == scored[0]:
                value = f"🥇 {value}"
            elif len(scored) > 1 and name == scored[1]:
                value = f"🥈 {value}"
            cells.append(value)
        lines.append(f"| {task.lower()} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def append_results(records: list[dict], path: str = RESULTS_PATH) -> None:
    """Merge records into benchmark/results.json (keyed on task+model)."""
    existing: list[dict] = []
    if os.path.exists(path):
        with open(path) as fh:
            existing = json.load(fh)
    keyed = {(r["task"], r["model"]): r for r in existing}
    for r in records:
        keyed[(r["task"], r["model"])] = r
    with open(path, "w") as fh:
        json.dump(list(keyed.values()), fh, indent=1)


def fetch_task(name: str, version: int):
    from sklearn.datasets import fetch_openml

    return fetch_openml(
        name, version=version, return_X_y=True, as_frame=True, parser="auto"
    )


def run_suite(kind: str, args: argparse.Namespace) -> tuple[int, list[dict]]:
    """Run the classification ('clf') or regression ('reg') suite end to end.

    Returns ``(exit_status, records)`` — the CLI wrappers exit with the status;
    tests introspect the records."""
    from neo_ls_svm_jax.utils.compilation_cache import enable_compilation_cache

    enable_compilation_cache()
    score_key = "roc_auc" if kind == "clf" else "r2"
    records: list[dict] = []
    if args.smoke or not online():
        if not args.smoke:
            print(
                "[automl] openml.org unreachable — no network egress in this "
                "environment. Re-run on a networked checkout for the real suite, "
                "or pass --smoke for the offline synthetic fallback.",
                file=sys.stderr,
            )
            return 1, []
        # Offline smoke: the synthetic fallback tasks ride the identical
        # pipeline/scoring/table path, so the harness is exercised without OpenML.
        from benchmark.synthetic import TASKS, make_task  # noqa: PLC0415

        models = build_models(kind)
        if args.skip_reference:
            models = [m for m in models if "reference" not in m["name"]]
        # Materialise each task ONCE (construction is not free on this 1-core
        # host), then filter by kind and sort smallest-first so `--smoke --limit N`
        # stays fast (the SVM baselines are O(n²⁺) and the first-dataset warm-up
        # doubles them).
        made = [(t, *make_task(t)) for t in TASKS]
        tasks = sorted(
            ((t, X, y) for t, X, y, k in made if k == kind), key=lambda item: len(item[2])
        )
        if args.limit:
            tasks = tasks[: args.limit]
        first = True
        for task_name, X, y in tasks:
            import pandas as pd  # noqa: PLC0415

            X_df = pd.DataFrame(X)
            records.extend(
                evaluate_task(task_name, X_df, y, kind, models, warm_up=first)
            )
            first = False
    else:
        tasks = CLASSIFICATION_TASKS if kind == "clf" else REGRESSION_TASKS
        if args.limit:
            tasks = tasks[: args.limit]
        models = build_models(kind)
        if args.skip_reference:
            models = [m for m in models if "reference" not in m["name"]]
        for i, (task_name, version) in enumerate(tasks):
            try:
                X, y = fetch_task(task_name, version)
            except Exception as exc:  # noqa: BLE001 - mirror ref's skip-on-error
                print(f"[automl] skipping {task_name}: {exc}", file=sys.stderr)
                continue
            records.extend(
                evaluate_task(task_name, X, y, kind, models, warm_up=(i == 0))
            )
    if records:
        print(comparison_table(records, score_key))
        if not args.no_record:
            append_results(records)
    return 0, records


def make_parser(kind: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=f"AutoML-Benchmark {kind} suite (reference protocol)"
    )
    parser.add_argument(
        "--smoke",
        action="store_true",
        help="offline synthetic fallback (no OpenML); exercises the full harness",
    )
    parser.add_argument("--limit", type=int, default=None, help="first N datasets only")
    parser.add_argument("--skip-reference", action="store_true")
    parser.add_argument(
        "--no-record", action="store_true", help="don't write benchmark/results.json"
    )
    return parser

if __name__ == "__main__":
    # Direct execution runs BOTH suites (the per-suite CLIs are
    # benchmark/classification.py and benchmark/regression.py); without this,
    # `python benchmark/automl.py --smoke` silently exited 0 having done nothing.
    parser = make_parser("classification+regression")
    cli_args = parser.parse_args()
    status_clf, _ = run_suite("clf", cli_args)
    status_reg, _ = run_suite("reg", cli_args)
    raise SystemExit(status_clf or status_reg)
