"""Multiclass composition: sklearn's OneVsRestClassifier over the binary NeoLSSVM.

The reference is binary-only and its own benchmark wraps multiclass tasks in
``OneVsRestClassifier`` (ref ``tests/test_neo_ls_svm.py:28``); this works unchanged with
the estimator because it speaks the sklearn protocol (predict_proba, classes_,
get_params/clone, tags).
"""

import numpy as np
from sklearn.multiclass import OneVsRestClassifier

from neo_ls_svm_jax import NeoLSSVM


def _make_multiclass(n: int = 1800, d: int = 6, seed: int = 71):
    gen = np.random.RandomState(seed)
    X = gen.randn(n, d)
    logits = np.stack(
        [
            X[:, 0] + 0.5 * X[:, 1],
            -X[:, 0] + np.abs(X[:, 2]),
            X[:, 3] - X[:, 1] * 0.5,
        ],
        axis=1,
    ) + 0.3 * gen.randn(n, 3)
    y = np.array(["red", "green", "blue"])[np.argmax(logits, axis=1)]
    return X, y


def test_one_vs_rest_multiclass() -> None:
    X, y = _make_multiclass()
    split = 1500
    model = OneVsRestClassifier(NeoLSSVM(estimator_type="classifier"))
    model.fit(X[:split], y[:split])
    accuracy = np.mean(model.predict(X[split:]) == y[split:])
    assert accuracy > 0.75
    proba = model.predict_proba(X[split:])
    assert proba.shape == (len(X) - split, 3)
    assert np.all((proba >= 0) & (proba <= 1))
