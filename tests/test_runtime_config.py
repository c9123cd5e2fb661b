"""Runtime configuration: compile cache location, memory-derived limits, quantile
rearrangement, and the smoke test's refusal to run without a GPU."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neo_ls_svm_jax.models import estimator as est_mod
from neo_ls_svm_jax.models.conformal import _rearranged
from neo_ls_svm_jax.utils import compilation_cache, transfer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_device(stats):
    return SimpleNamespace(memory_stats=lambda: stats)


@pytest.mark.parametrize("env_dir", [None, "cache-from-env"])
def test_compilation_cache_location(tmp_path, env_dir) -> None:
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting stands and no other
    directory is set; without it the cache goes to the fixed in-checkout path."""
    script = textwrap.dedent(
        """
        import jax
        from neo_ls_svm_jax.utils.compilation_cache import enable_compilation_cache
        before = jax.config.jax_compilation_cache_dir
        returned = enable_compilation_cache()
        print(repr((before, returned, jax.config.jax_compilation_cache_dir)))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300, check=True,
    ).stdout.strip().splitlines()[-1]
    before, returned, after = ast.literal_eval(out)
    if env_dir is None:
        expected = os.path.join(REPO, ".jax_cache")
        assert compilation_cache.DEFAULT_CACHE_DIR == expected
        assert before is None and returned == after == expected
    else:
        assert before == returned == after == str(tmp_path / env_dir)
        assert not os.path.exists(tmp_path / env_dir)  # JAX creates it on first write


@pytest.mark.parametrize(
    ("override", "stats", "expected"),
    [
        (None, {"bytes_limit": 60 * 1024**3}, int(est_mod.STREAMING_MEMORY_FRACTION * 60 * 1024**3)),
        (None, None, est_mod.HOST_STREAMING_BYTES_THRESHOLD),
        (None, {"bytes_in_use": 1}, est_mod.HOST_STREAMING_BYTES_THRESHOLD),
        (12345, {"bytes_limit": 60 * 1024**3}, 12345),
    ],
)
def test_streaming_threshold_rule(monkeypatch, override, stats, expected) -> None:
    monkeypatch.setattr(est_mod, "STREAMING_BYTES_THRESHOLD", override)
    assert est_mod.streaming_bytes_threshold(_fake_device(stats)) == expected


def test_streaming_threshold_routes_one_million_rows_in_memory_on_an_80_gb_card() -> None:
    """On a card whose JAX process may use 60 GiB, the 1M×32 default fit (working-set
    estimate 12.9 GB) stays in memory and a 4M×32 fit (51.6 GB) streams."""
    threshold = est_mod.streaming_bytes_threshold(_fake_device({"bytes_limit": 60 * 1024**3}))
    assert est_mod._primal_working_set_bytes(1 << 20, 512, 4) < threshold
    assert est_mod._primal_working_set_bytes(1 << 22, 512, 4) > threshold


@pytest.mark.parametrize(("limit", "expected"), [(None, None), (80 * 10**9, 80 * 10**9)])
def test_staging_cap_follows_device_limit(monkeypatch, limit, expected) -> None:
    stats = None if limit is None else {"bytes_limit": limit}
    assert transfer.device_bytes_limit(_fake_device(stats)) == expected
    monkeypatch.setattr(transfer, "device_bytes_limit", lambda device=None: limit)
    cap = transfer._HOST_MAX_STAGED_BYTES if limit is None else limit // 8
    assert transfer.max_staged_bytes() == cap


@pytest.mark.parametrize("as_jax", [False, True])
def test_quantile_rearrangement(as_jax) -> None:
    """Crossed rows are sorted into the order of their quantile levels (given here
    out of order); monotone rows are left exactly as they were."""
    quantiles = np.array([0.9, 0.1, 0.5])
    values = np.array([[3.0, 1.0, 2.0], [1.0, 2.5, 2.0]])  # row 1 crosses
    out = _rearranged(jnp.asarray(values) if as_jax else values, quantiles)
    assert isinstance(out, jax.Array) == as_jax
    np.testing.assert_array_equal(np.asarray(out), [[3.0, 1.0, 2.0], [2.5, 1.0, 2.0]])


@pytest.mark.parametrize("standalone", [False, True])
def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path, standalone) -> None:
    """On the CPU, and in a directory holding the script alone, the smoke test exits
    non-zero with a clear message and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if standalone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    result = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300,
    )
    assert result.returncode != 0
    assert '"ok"' not in result.stdout
    expected = "checkout of the repository" if standalone else "no GPU"
    assert expected in result.stderr, result.stderr[-2000:]
