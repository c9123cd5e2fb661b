"""Worker for the 2-process ``jax.distributed`` test (see test_multiprocess.py).

Each process runs this script with ``argv = [proc_id, num_procs, port]``, forms the
global runtime via ``initialize_distributed``, builds a cross-process mesh, and runs
the sharded primal fits SPMD-style. Process 0 prints a ``RESULT {json}`` line with the
replicated outputs for the parent test to compare against a single-process oracle.
"""

import json
import sys


def main() -> None:
    proc_id, num_procs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import jax

    # Both processes run on the CPU: two JAX processes must never share one card.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from neo_ls_svm_jax.parallel.distributed import initialize_distributed

    assert initialize_distributed(f"localhost:{port}", num_procs, proc_id) is True
    # Idempotence: a second call must be a no-op instead of re-initialising.
    assert initialize_distributed(f"localhost:{port}", num_procs, proc_id) is False
    assert jax.process_count() == num_procs, jax.process_count()
    local = len(jax.local_devices())
    assert len(jax.devices()) == num_procs * local

    import numpy as np

    from neo_ls_svm_jax.models.primal import gamma_grid
    from neo_ls_svm_jax.ops.orff import OrthogonalRandomFourierFeatures
    from neo_ls_svm_jax.parallel.mesh import (
        make_mesh,
        sharded_primal_fit,
        sharded_primal_fit_streaming,
    )

    # Deterministic data, identical in every process and in the parent-test oracle.
    gen = np.random.RandomState(41)
    X = gen.randn(1536, 8)
    y = (
        np.sin(X[:, 0])
        + 0.5 * X[:, 1] * X[:, 2]
        + 0.25 * np.abs(X[:, 3])
        + 0.1 * X[:, 4]
        + 0.1 * gen.randn(1536)
    )
    s = np.ones_like(y)
    fmap = OrthogonalRandomFourierFeatures(num_features=64).fit(X, y, s)
    M_map, b_map = fmap.linear_map()
    gammas = gamma_grid(np.float64)

    mesh = make_mesh()  # ("data", "feature") across both processes
    assert mesh.shape["data"] * mesh.shape["feature"] == num_procs * local
    out = {}
    for name, fit in (
        ("plain", sharded_primal_fit),
        ("streaming", lambda *a, **k: sharded_primal_fit_streaming(*a, row_chunk=128, **k)),
    ):
        result = fit(mesh, X, M_map, b_map, y, s, gammas, is_classifier=False)
        # Replicated outputs are addressable on every process; row-sharded outputs
        # (loo_residuals etc.) are not, and stay distributed.
        out[name] = {
            "gamma": float(result["gamma"]),
            "loo_score": float(result["loo_score"]),
            "beta_emb": np.asarray(result["beta_emb"]).tolist(),
        }
    if proc_id == 0:
        print("RESULT " + json.dumps(out))


if __name__ == "__main__":
    main()
