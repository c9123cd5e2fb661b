"""staged_device_put: value-preserving pipelined upload (utils/transfer.py)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from neo_ls_svm_jax.utils import transfer
from neo_ls_svm_jax.utils.transfer import staged_device_put


def _force_chunking(monkeypatch, target_bytes: int = 256) -> None:
    monkeypatch.setattr(transfer, "_TARGET_CHUNK_BYTES", target_bytes)
    monkeypatch.setattr(transfer, "_MIN_STAGED_BYTES", 2 * target_bytes)


def test_staged_equals_monolithic(monkeypatch) -> None:
    _force_chunking(monkeypatch)
    rng = np.random.RandomState(0)
    for rows in (37, 64, 1000):  # odd counts exercise unequal array_split chunks
        X = rng.randn(rows, 7).astype(np.float32)
        out = staged_device_put(X)
        assert isinstance(out, jax.Array)
        assert out.shape == X.shape and out.dtype == X.dtype
        np.testing.assert_array_equal(np.asarray(out), X)


def test_staged_cast_matches_host_cast(monkeypatch) -> None:
    _force_chunking(monkeypatch)
    X = np.random.RandomState(1).randn(123, 9).astype(np.float32)
    out = staged_device_put(X, cast_dtype=ml_dtypes.bfloat16)
    assert out.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(out).astype(np.float32), X.astype(ml_dtypes.bfloat16).astype(np.float32)
    )


def test_staged_cast_fn_matches_monolithic(monkeypatch) -> None:
    """A per-chunk cast_fn (the int8 quantiser) must be bitwise-equal to applying
    the same transform to the whole array, chunked or not."""
    X = np.random.RandomState(4).randn(123, 9).astype(np.float32)
    inv_scale = (127.0 / np.maximum(np.abs(X).max(axis=0), 1e-12)).astype(np.float32)

    def quantize(chunk: np.ndarray) -> np.ndarray:
        return np.clip(np.rint(chunk * inv_scale), -127, 127).astype(np.int8)

    expected = quantize(X)
    # Monolithic fallback path (no chunk-forcing): cast_fn still applies.
    out_mono = staged_device_put(X, cast_dtype=np.dtype(np.int8), cast_fn=quantize)
    assert out_mono.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(out_mono), expected)
    # Chunked path.
    _force_chunking(monkeypatch)
    out_chunked = staged_device_put(X, cast_dtype=np.dtype(np.int8), cast_fn=quantize)
    np.testing.assert_array_equal(np.asarray(out_chunked), expected)


def test_small_and_non_2d_fall_back_to_plain_put() -> None:
    X_small = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(np.asarray(staged_device_put(X_small)), X_small)
    v = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(np.asarray(staged_device_put(v)), v)


def test_chunk_count_capped_by_rows(monkeypatch) -> None:
    # A wide 2-row array big enough to chunk must not split beyond its rows.
    _force_chunking(monkeypatch, target_bytes=64)
    X = np.random.RandomState(2).randn(2, 100).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(staged_device_put(X)), X)


def test_oversized_arrays_fall_back_to_monolithic(monkeypatch) -> None:
    # Above the staging cap the on-device stitch would transiently double device
    # memory, so staging must not engage (will_stage False → plain device_put).
    _force_chunking(monkeypatch)
    monkeypatch.setattr(transfer, "_HOST_MAX_STAGED_BYTES", 1024)
    X = np.random.RandomState(3).randn(64, 16).astype(np.float32)  # 4KB > cap
    assert not transfer.will_stage(X)
    np.testing.assert_array_equal(np.asarray(staged_device_put(X)), X)


def test_will_stage_matches_staging_decision(monkeypatch) -> None:
    _force_chunking(monkeypatch)
    big = np.zeros((64, 4), np.float32)  # 1KB > 2*256B threshold
    small = np.zeros((4, 4), np.float32)
    assert transfer.will_stage(big)
    assert not transfer.will_stage(small)
    assert not transfer.will_stage(big[0])  # 1-D never stages
    # bf16 cast halves the wire size: a buffer just over threshold in f32 drops under.
    edge = np.zeros((48, 4), np.float32)  # 768B wire in f32, 384B in bf16
    assert transfer.will_stage(edge)
    import ml_dtypes

    assert not transfer.will_stage(edge, cast_dtype=ml_dtypes.bfloat16)


def test_symmetric_int8_grid_subnormal_column_never_nan() -> None:
    """A column whose magnitude underflows the grid (absmax/127 subnormal) must fall
    back to scale 1 — not produce inf inv_scale and NaN→int8 undefined casts."""
    from neo_ls_svm_jax.utils.transfer import symmetric_int8_grid

    X = np.zeros((8, 3), dtype=np.float32)
    X[:, 0] = np.linspace(-2.0, 2.0, 8)
    X[:4, 1] = 1e-44  # subnormal magnitude: absmax/127 underflows to 0
    # column 2 stays exactly zero
    scale, cast_fn = symmetric_int8_grid(X)
    assert np.all(np.isfinite(scale)) and np.all(scale > 0)
    q = cast_fn(X)
    assert q.dtype == np.int8
    deq = q.astype(np.float32) * scale[None, :]
    assert np.all(np.isfinite(deq))
    np.testing.assert_allclose(deq[:, 0], X[:, 0], atol=float(scale[0]) / 2 + 1e-7)
    assert np.all(q[:, 1:] == 0)  # tiny/zero columns quantise to 0, not NaN
