"""Scaling Neo LS-SVM beyond one card: streaming, meshes, several processes.

Runnable anywhere: on a machine without multiple accelerators, simulate an 8-device
mesh with
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/scale_out.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    import jax

    # Some environments pre-register an accelerator platform before env vars apply;
    # honor an explicit virtual-device request by switching the backend in-process.
    if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass

    from neo_ls_svm_jax import NeoLSSVM
    from neo_ls_svm_jax.parallel.distributed import initialize_distributed
    from neo_ls_svm_jax.parallel.mesh import make_mesh

    # 1. Multi-process init (no-op in a single process; a multi-process run starts one
    #    process per card and passes coordinator_address/num_processes/process_id).
    initialize_distributed()

    # 2. One card scales to millions of rows by itself: the estimator auto-routes to
    #    the streaming solver (O(chunk) device memory) once its working set passes half
    #    the device's memory limit. Nothing to configure.
    gen = np.random.RandomState(0)
    n, d = 200_000, 16
    X = gen.randn(n, d).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * gen.randn(n)).astype(np.float32)
    model = NeoLSSVM().fit(X, y)
    print(f"single-device fit: loo R² = {model.loo_score_:.4f}")

    # 3. Several cards: pass a mesh. Rows shard over the "data" axis; the Gram
    #    reduction crosses cards as one psum. When even a per-card shard would be large, the
    #    estimator composes sharding with streaming automatically.
    if len(jax.devices()) >= 2:
        # mesh="auto" builds the ("data", "feature") mesh over every visible device;
        # hand-build with make_mesh when the default layout doesn't fit.
        sharded = NeoLSSVM(mesh="auto").fit(X, y)
        print(f"mesh {dict(sharded.mesh_.shape)} fit: loo R² = {sharded.loo_score_:.4f}")
        # A 2-D layout keeps a "feature" axis for the n×2M contractions at very large D:
        mesh2d = make_mesh(num_data=len(jax.devices()) // 2, num_feature=2)
        print(f"2-D mesh available: {dict(mesh2d.shape)}")
    else:
        print("one device visible: skipping the mesh demo (see the module docstring)")


if __name__ == "__main__":
    main()
