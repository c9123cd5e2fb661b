"""Import the upstream reference implementation for behavioural parity tests.

The reference (`/root/reference`, read-only) depends on numba, which is not installed in
this environment. Its four numba kernels are plain Python loops under ``nopython`` — a
no-op ``jit`` shim executes them correctly (just slower), which is fine for tests. The
shim lets parity tests compare this implementation's outputs against the *actual*
reference, not a transcription of it.
"""

import os
import sys
import types
from typing import Any

REFERENCE_SRC = "/root/reference/src"


def _install_numba_shim() -> None:
    if "numba" in sys.modules:
        return
    numba = types.ModuleType("numba")

    def jit(*args: Any, **kwargs: Any):
        if args and callable(args[0]) and not kwargs:
            return args[0]

        def decorator(fn):
            return fn

        return decorator

    numba.jit = jit  # type: ignore[attr-defined]
    numba.njit = jit  # type: ignore[attr-defined]
    numba.prange = range  # type: ignore[attr-defined]
    sys.modules["numba"] = numba


def import_reference():
    """Return the reference ``neo_ls_svm`` package, importable without numba.

    A missing reference checkout fails LOUDLY by default — many test modules mix
    parity tests with tests of this repo's own code, and a silent module-level skip
    would hide regressions in the latter. Environments that genuinely lack the
    checkout (public CI) opt into skipping by exporting
    ``NEO_LS_SVM_ALLOW_MISSING_REFERENCE=1``.
    """
    if not os.path.isdir(REFERENCE_SRC):
        if os.environ.get("NEO_LS_SVM_ALLOW_MISSING_REFERENCE"):
            import pytest  # noqa: PLC0415

            pytest.skip(
                f"reference implementation not available at {REFERENCE_SRC}",
                allow_module_level=True,
            )
        msg = (
            f"The reference checkout is required at {REFERENCE_SRC} for parity tests. "
            "Set NEO_LS_SVM_ALLOW_MISSING_REFERENCE=1 to skip reference-dependent "
            "test modules instead (note: modules mixing parity and non-parity tests "
            "skip entirely)."
        )
        raise FileNotFoundError(msg)
    _install_numba_shim()
    if REFERENCE_SRC not in sys.path:
        sys.path.insert(0, REFERENCE_SRC)
    import neo_ls_svm  # noqa: PLC0415

    return neo_ls_svm
