"""Parity tests for the L1 statistics layer: weighted quantiles and the ECDF quantizer."""

import jax.numpy as jnp
import numpy as np
import pytest

from neo_ls_svm_jax.ops.quantizer import (
    Quantizer,
    hist_quantized_ecdf,
    sample_bins_quantized_ecdf,
    sample_weights_quantized_ecdf,
)
from neo_ls_svm_jax.ops.weighted_quantile import weighted_quantile, weighted_quantile_jax

from .reference_shim import import_reference

ref = import_reference()
from neo_ls_svm._quantizer import (  # noqa: E402
    hist_quantized_ecdf as ref_hist_quantized_ecdf,
    sample_bins_quantized_ecdf as ref_sample_bins_quantized_ecdf,
    sample_weights_quantized_ecdf as ref_sample_weights_quantized_ecdf,
)
from neo_ls_svm._quantizer import Quantizer as RefQuantizer  # noqa: E402
from neo_ls_svm._weighted_quantile import weighted_quantile as ref_weighted_quantile  # noqa: E402


def test_weighted_quantile_toy_convention() -> None:
    # The averaged lower/upper ECDF convention (ref _weighted_quantile.py:69-71).
    a = np.array([0.0, 1.0, 1.0])
    w = np.array([2.0, 1.0, 1.0])
    assert weighted_quantile(a, w, 0.5, axis=None) == pytest.approx(0.5)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_weighted_quantile_matches_reference(rng, axis) -> None:
    a = rng.randn(50, 7)
    w = rng.rand(50, 7) + 0.01
    q = np.array([0.1, 0.5, 0.9])
    ours = weighted_quantile(a, w, q, axis=axis)
    theirs = ref_weighted_quantile(a, w, q, axis=axis)
    np.testing.assert_allclose(ours, theirs, rtol=1e-12)


def test_weighted_quantile_jax_matches_host(rng) -> None:
    a = rng.randn(40, 5)
    w = rng.rand(40, 5) + 0.01
    q = np.array([0.25, 0.5, 0.75])
    host = weighted_quantile(a, w, q, axis=0)
    dev = np.asarray(weighted_quantile_jax(jnp.asarray(a), jnp.asarray(w), jnp.asarray(q), axis=0))
    np.testing.assert_allclose(dev, host, rtol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["normal", "lognormal", "discrete", "bimodal"])
def test_hist_quantized_ecdf_matches_reference(seed, kind) -> None:
    gen = np.random.RandomState(seed)
    if kind == "normal":
        x = gen.randn(3000)
    elif kind == "lognormal":
        x = np.exp(gen.randn(3000))
    elif kind == "discrete":
        x = gen.randint(0, 40, size=3000).astype(np.float64)
    else:
        x = np.concatenate([gen.randn(1500) - 4, gen.randn(1500) + 4])
    ours_hist, ours_edges = hist_quantized_ecdf(x, density=False)
    ref_hist, ref_edges = ref_hist_quantized_ecdf(x, density=False)
    np.testing.assert_array_equal(ours_hist, ref_hist)
    np.testing.assert_allclose(ours_edges, ref_edges)
    ours_dens, _ = hist_quantized_ecdf(x, density=True)
    ref_dens, _ = ref_hist_quantized_ecdf(x, density=True)
    np.testing.assert_allclose(ours_dens, ref_dens)
    # The reference's middle-merge branch can be off-by-one on the total count (its own
    # TODO at _quantizer.py:159); parity with the reference is the contract, so only
    # require the near-invariant here.
    assert abs(int(np.sum(ours_hist)) - len(x)) <= 2


@pytest.mark.parametrize("seed", [0, 3])
def test_quantizer_matches_reference(seed) -> None:
    gen = np.random.RandomState(seed)
    X = np.column_stack([gen.randn(2000), np.exp(gen.randn(2000)), gen.randint(0, 9, 2000)])
    ours = Quantizer().fit(X)
    theirs = RefQuantizer().fit(X)
    X_new = np.column_stack([gen.randn(500), np.exp(gen.randn(500)), gen.randint(0, 9, 500)])
    np.testing.assert_array_equal(ours.transform(X_new), theirs.transform(X_new))
    ours_if = Quantizer(append_invfreq=True).fit(X)
    theirs_if = RefQuantizer(append_invfreq=True).fit(X)
    np.testing.assert_allclose(ours_if.transform(X_new), theirs_if.transform(X_new))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_bins_matches_reference(seed) -> None:
    gen = np.random.RandomState(seed)
    for x in (gen.randn(2500), gen.randint(0, 5, 400), np.exp(gen.randn(1200))):
        ours = sample_bins_quantized_ecdf(x)
        theirs = ref_sample_bins_quantized_ecdf(x)
        np.testing.assert_array_equal(ours, theirs)


def test_sample_weights_matches_reference(rng) -> None:
    x = rng.randn(2000)
    np.testing.assert_allclose(
        sample_weights_quantized_ecdf(x), ref_sample_weights_quantized_ecdf(x)
    )
    x_small = rng.randint(0, 4, 300)
    np.testing.assert_allclose(
        sample_weights_quantized_ecdf(x_small), ref_sample_weights_quantized_ecdf(x_small)
    )


def test_native_knot_scan_matches_python_fallback() -> None:
    """The C++ knot-scan kernel is bit-identical to the pure-Python scan."""
    import neo_ls_svm_jax.native as native
    import neo_ls_svm_jax.ops.quantizer as q

    if native.knot_scan is None:
        pytest.skip("native kernel unavailable (no C++ compiler)")
    gen = np.random.RandomState(13)
    for x in (gen.randn(50000), np.exp(gen.randn(20000)), gen.randint(0, 1000, 30000)):
        native_hist, native_edges = q.hist_quantized_ecdf(x)
        saved = q._native_knot_scan
        try:
            q._native_knot_scan = None
            py_hist, py_edges = q.hist_quantized_ecdf(x)
        finally:
            q._native_knot_scan = saved
        np.testing.assert_array_equal(native_hist, py_hist)
        np.testing.assert_allclose(native_edges, py_edges)


def test_uniform_fast_path_bitwise_equals_general_path() -> None:
    """The O(n) partition fast path for uniform weights must be BIT-exactly equal to
    the general argsort path (it replicates np.interp's bracket choice and
    arithmetic), across dtypes, tie regimes, and edge quantiles."""
    import importlib

    wq = importlib.import_module("neo_ls_svm_jax.ops.weighted_quantile")
    gen = np.random.RandomState(17)
    try:
        for trial in range(400):
            n = gen.randint(64, 1500)
            d = gen.randint(1, 6)
            dtype = np.float32 if trial % 2 else np.float64
            kind = trial % 4
            if kind == 0:
                a = gen.randn(n, d).astype(dtype)
            elif kind == 1:
                a = np.round(gen.randn(n, d), 1).astype(dtype)  # heavy ties
            elif kind == 2:
                a = gen.choice([0.0, 1.0, 2.0], size=(n, d)).astype(dtype)
            else:
                a = np.sort(gen.randn(n, d), axis=0).astype(dtype)  # presorted
            w = np.full((n, 1), gen.choice([1.0, 0.5, 1.0 / n]),
                        dtype=np.float32 if trial % 3 == 0 else np.float64)
            q = gen.choice([0.5, 0.1, 0.9, 0.0, 1.0, 0.999])
            fast = wq.weighted_quantile(a, w, q, axis=0)
            wq._ENABLE_UNIFORM_FAST_PATH = False
            slow = wq.weighted_quantile(a, w, q, axis=0)
            wq._ENABLE_UNIFORM_FAST_PATH = True
            assert fast.shape == slow.shape
            np.testing.assert_array_equal(fast, slow)
    finally:
        wq._ENABLE_UNIFORM_FAST_PATH = True
