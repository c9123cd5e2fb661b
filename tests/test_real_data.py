"""Real OpenML dataset scores (network-gated; skips cleanly offline).

The reference's headline numbers are real-dataset scores: churn 93.1% accuracy and
ames_housing 82.4% R² (ref ``README.md:35-48``, via ``fetch_openml`` + skrub
``TableVectorizer`` + an 85/15 split). This build environment has no network egress
(verified: openml.org does not resolve — see README "Real-dataset scores"), so these
tests SKIP here; on any networked checkout they fetch the actual datasets and gate the
scores against the reference's published numbers.

Preprocessing: skrub's TableVectorizer when available, else a minimal
median-impute + one-hot pipeline (scores with the fallback are gated slightly below
the published numbers, which were produced with skrub).
"""

import socket

import numpy as np
import pytest

from neo_ls_svm_jax import NeoLSSVM


def _online(host: str = "openml.org", timeout: float = 5.0) -> bool:
    try:
        socket.getaddrinfo(host, 443)
    except OSError:
        return False
    return True


pytestmark = pytest.mark.skipif(
    not _online(), reason="no network egress to openml.org in this environment"
)


def _vectorize(X_df):
    try:
        from skrub import TableVectorizer  # same preprocessing as the reference

        return TableVectorizer().fit_transform(X_df), True
    except ImportError:
        import pandas as pd
        from sklearn.compose import make_column_transformer
        from sklearn.impute import SimpleImputer
        from sklearn.pipeline import make_pipeline
        from sklearn.preprocessing import OneHotEncoder

        num_cols = X_df.select_dtypes(include=np.number).columns
        cat_cols = [c for c in X_df.columns if c not in num_cols]
        ct = make_column_transformer(
            (SimpleImputer(strategy="median"), list(num_cols)),
            (
                make_pipeline(
                    SimpleImputer(strategy="most_frequent"),
                    OneHotEncoder(handle_unknown="ignore", sparse_output=False),
                ),
                list(cat_cols),
            ),
        )
        return ct.fit_transform(pd.DataFrame(X_df)), False


def _fetch(name: str, version: int):
    from sklearn.datasets import fetch_openml

    return fetch_openml(name, version=version, return_X_y=True, as_frame=True, parser="auto")


def test_churn_accuracy_matches_reference() -> None:
    """Ref README.md:35-42 — churn v3, 85/15 split, default hyperparameters → 93.1%."""
    from sklearn.model_selection import train_test_split

    X, y = _fetch("churn", 3)
    Xv, used_skrub = _vectorize(X)
    X_train, X_test, y_train, y_test = train_test_split(
        np.asarray(Xv, dtype=np.float64), np.asarray(y), test_size=0.15, random_state=42
    )
    score = NeoLSSVM().fit(X_train, y_train).score(X_test, y_test)
    floor = 0.925 if used_skrub else 0.90
    assert score >= floor, f"churn accuracy {score:.3f} below the reference floor"


def test_ames_housing_r2_matches_reference() -> None:
    """Ref README.md:44-48 — ames_housing v1, 85/15 split → R² 82.4%."""
    from sklearn.model_selection import train_test_split

    X, y = _fetch("ames_housing", 1)
    Xv, used_skrub = _vectorize(X)
    X_train, X_test, y_train, y_test = train_test_split(
        np.asarray(Xv, dtype=np.float64),
        np.asarray(y, dtype=np.float64),
        test_size=0.15,
        random_state=42,
    )
    score = NeoLSSVM().fit(X_train, y_train).score(X_test, y_test)
    floor = 0.80 if used_skrub else 0.75
    assert score >= floor, f"ames R² {score:.3f} below the reference floor"
