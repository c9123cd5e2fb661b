"""Host→device transfer helpers.

A monolithic ``jax.device_put`` serializes the host-side buffer preparation with the
transfer; issuing the upload as a train of row-chunk ``device_put`` calls lets the
runtime pipeline the two. Chunking also lets an optional host-side dtype cast (the
``transfer="bfloat16"``/``"int8"`` opt-in modes) ride under the transfer of the
previous chunk instead of stalling in front of the whole upload.

The reference has no transfer layer at all (pure in-process NumPy).
"""

import math
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

#: Per-chunk transfer-size target: small enough to pipeline, large enough that the
#: per-call overhead stays amortized.
_TARGET_CHUNK_BYTES = 16 * 1024 * 1024
#: Below this post-cast size a single device_put wins (no pipelining to gain).
_MIN_STAGED_BYTES = 2 * _TARGET_CHUNK_BYTES
#: Share of the device's memory limit a staged upload may take. The on-device
#: concatenate transiently holds the chunk buffers and the stitched copy (2×), so
#: an eighth keeps that transient within a quarter of the device.
_MAX_STAGED_FRACTION = 1 / 8
#: Staging cap on backends that report no memory limit (the CPU).
_HOST_MAX_STAGED_BYTES = 1 * 1024**3
_MAX_CHUNKS = 16


def device_bytes_limit(device: Any = None) -> int | None:
    """The memory XLA may allocate on ``device`` (default: the first device), from
    ``memory_stats()["bytes_limit"]``; None where the backend reports no limit."""
    device = jax.devices()[0] if device is None else device
    stats = device.memory_stats() if hasattr(device, "memory_stats") else None
    limit = (stats or {}).get("bytes_limit")
    return int(limit) if limit else None


def max_staged_bytes() -> int:
    """Largest upload :func:`staged_device_put` chunks; larger ones go monolithic."""
    limit = device_bytes_limit()
    return _HOST_MAX_STAGED_BYTES if limit is None else int(_MAX_STAGED_FRACTION * limit)


def symmetric_int8_grid(rows: np.ndarray) -> tuple[np.ndarray, "object"]:
    """Per-column symmetric int8 quantisation grid: ``x ≈ q·scale``, q ∈ [-127, 127].

    Returns ``(scale, cast_fn)`` where ``cast_fn`` quantises a row chunk to int8.
    ``cast_fn`` is row-independent, so it composes with :func:`staged_device_put`'s
    sub-chunking, and the grid rows may differ from the cast target (the fit path
    computes the grid from positive-weight rows only). Columns whose magnitude is
    zero — or so small that ``absmax/127`` underflows to a subnormal whose
    reciprocal overflows (0·inf → NaN, and NaN→int8 is undefined) — fall back to
    ``scale = 1``: their values quantise to 0, which is what they round to anyway.

    This is the single definition of the wire grid. The invariant callers rely on
    is only that the grid is row-independent *within one upload* (so it composes
    with :func:`staged_device_put`'s sub-chunking); cross-call consistency is NOT
    required — each upload dequantises immediately on device, so fit-time and
    serving-time uploads may legitimately use different grids
    (``models/estimator.py`` builds a fresh grid per prediction chunk).
    """
    dtype = rows.dtype
    col_absmax = np.maximum(rows.max(axis=0), -rows.min(axis=0))
    scale = (col_absmax / 127.0).astype(dtype)
    scale = np.where(scale >= np.finfo(dtype).tiny, scale, dtype.type(1.0))
    inv_scale = (1.0 / scale).astype(dtype)

    def cast_fn(chunk: np.ndarray) -> np.ndarray:
        return np.clip(np.rint(chunk * inv_scale), -127, 127).astype(np.int8)

    return scale, cast_fn


def will_stage(X: np.ndarray, cast_dtype: "np.dtype | None" = None) -> bool:
    """True when :func:`staged_device_put` would actually chunk this upload.

    Callers batching several small arrays into one ``device_put`` can use this to
    keep X in the batch when staging would not engage (one call instead of two)."""
    itemsize = np.dtype(cast_dtype).itemsize if cast_dtype is not None else X.itemsize
    wire_bytes = X.size * itemsize
    return X.ndim == 2 and _MIN_STAGED_BYTES <= wire_bytes <= max_staged_bytes()


def staged_device_put(
    X: np.ndarray,
    cast_dtype: "np.dtype | None" = None,
    cast_fn=None,
    extras: tuple = (),
) -> "jax.Array | tuple[jax.Array, tuple[jax.Array, ...]]":
    """Upload a 2-D host array, pipelining serialization/cast with the wire transfer.

    Splits ``X`` into row chunks sized ~:data:`_TARGET_CHUNK_BYTES` on the wire and
    issues their ``device_put`` calls back-to-back without blocking, then stitches
    the device buffers with one on-device concatenate (a device-memory copy). With ``cast_dtype`` each chunk is cast on host immediately
    before its upload, so the cast of chunk *k+1* overlaps the transfer of chunk
    *k*. ``cast_fn`` replaces the plain ``astype`` with an arbitrary per-chunk host
    transform (e.g. int8 quantisation) whose *output* dtype must be ``cast_dtype``
    so the wire-size accounting stays right; it rides the same pipeline. Small
    arrays (or 1-D/0-D input) fall back to a plain ``device_put``.

    Returns a device array equal to ``jax.device_put(cast(X))`` — bitwise, since
    ``cast_fn`` is applied per row chunk and both row-slicing and concatenation are
    value-preserving (``cast_fn`` must therefore be row-independent).
    Arrays above :func:`max_staged_bytes` also take the monolithic path: the
    on-device stitch transiently doubles device memory (chunks + concatenated copy),
    which a streaming fit near the memory limit cannot afford.

    ``extras`` are small companion arrays (e.g. an int8 dequantisation grid) that
    must reach the device alongside ``X``: they ride the first chunk's
    ``device_put`` as one batched call. With ``extras`` the return value becomes
    ``(X_device, extras_device)``.
    """
    if cast_fn is None and cast_dtype is not None:
        cast_fn = lambda chunk: chunk.astype(cast_dtype)  # noqa: E731
    if not will_stage(X, cast_dtype):
        host = X if cast_fn is None else cast_fn(X)
        if extras:
            X_d, *extras_d = jax.device_put((host, *extras))
            return X_d, tuple(extras_d)
        return jax.device_put(host)
    itemsize = np.dtype(cast_dtype).itemsize if cast_dtype is not None else X.itemsize
    wire_bytes = X.size * itemsize
    num_chunks = min(
        _MAX_CHUNKS, max(2, math.ceil(wire_bytes / _TARGET_CHUNK_BYTES)), X.shape[0]
    )
    parts = []
    extras_d: tuple[jax.Array, ...] = ()
    for i, chunk in enumerate(np.array_split(X, num_chunks, axis=0)):
        if cast_fn is not None:
            chunk = cast_fn(chunk)
        if i == 0 and extras:
            first, *rest = jax.device_put((chunk, *extras))
            extras_d = tuple(rest)
            parts.append(first)
        else:
            parts.append(jax.device_put(chunk))
    X_dev = jnp.concatenate(parts, axis=0)
    return (X_dev, extras_d) if extras else X_dev
