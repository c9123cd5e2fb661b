"""Profiling helpers.

The reference ships no instrumentation (SURVEY.md §5.1); this build annotates every
solver phase with ``jax.named_scope`` (visible in XLA/Perfetto traces) and provides this
thin helper for capturing a trace around any region of user code::

    from neo_ls_svm_jax.utils.profiling import trace
    with trace("/tmp/neo_trace"):
        model.fit(X, y)

Open the resulting directory with TensorBoard's profile plugin or ui.perfetto.dev.
"""

import contextlib
from typing import Iterator

import jax


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_trace: bool = True) -> Iterator[None]:
    """Capture a JAX profiler trace (device + host activity) into ``log_dir``."""
    jax.profiler.start_trace(log_dir, create_perfetto_trace=create_perfetto_trace)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


annotate = jax.profiler.TraceAnnotation
"""Host-side annotation context manager: ``with annotate("phase"): ...``."""
