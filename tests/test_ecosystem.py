"""Ecosystem interop: sklearn Pipeline / GridSearchCV / CV splitters over NeoLSSVM."""

import numpy as np
from sklearn.model_selection import GridSearchCV, cross_val_score
from sklearn.pipeline import make_pipeline
from sklearn.preprocessing import StandardScaler

from neo_ls_svm_jax import NeoLSSVM

from .conftest import make_classification_dataset, make_regression_dataset


def test_pipeline_and_cross_val() -> None:
    X, y = make_regression_dataset(n=1500, seed=101)
    pipe = make_pipeline(StandardScaler(), NeoLSSVM())
    scores = cross_val_score(pipe, X, y, cv=3)
    assert scores.shape == (3,)
    assert np.all(scores > 0.3)


def test_grid_search() -> None:
    X, y = make_classification_dataset(n=900, seed=102)
    grid = GridSearchCV(
        NeoLSSVM(),
        param_grid={"dual": [True, "auto"]},
        cv=2,
        n_jobs=1,
    )
    grid.fit(X, y)
    assert grid.best_score_ > 0.6
    assert hasattr(grid.best_estimator_, "γ_")
