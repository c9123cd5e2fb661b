"""Multi-process scaffolding: ``jax.distributed`` initialisation.

The reference has no distributed code of any kind (SURVEY.md §5.8). One process can
drive every card of a host through :func:`~neo_ls_svm_jax.parallel.mesh.make_mesh`;
a multi-process run uses one JAX process per card, ``jax.distributed.initialize`` to
form the global runtime, and the same ``make_mesh`` over the global device list. No
hand-written communication backend exists or is needed: GSPMD/shard_map emit the
collectives.

The multi-process path is executed for real by ``tests/test_multiprocess.py``: two
CPU processes form the global runtime over a localhost coordinator, build a
cross-process mesh, and run both sharded fits SPMD-style with parity against a
single-process oracle.
"""

from typing import Sequence

import jax


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
) -> bool:
    """Initialise the multi-process JAX runtime; returns True if it did anything.

    Single-process usage (all arguments None) is a no-op, so library code may call
    this unconditionally. A multi-process run starts one process per card and passes
    every argument explicitly (``coordinator_address`` as ``host:port``,
    ``num_processes``, ``process_id`` and, per process, the one local card in
    ``local_device_ids``), BEFORE any other JAX API touches the backend.
    Idempotent: the runtime's own initialisation state is consulted (not a
    process-global flag), so a runtime initialised by the caller directly through
    ``jax.distributed.initialize`` is also recognised.
    """
    if jax.distributed.is_initialized():
        return False
    if all(v is None for v in (coordinator_address, num_processes, process_id)):
        # Plain single-process run. (Cluster schedulers that want auto-detection
        # should call jax.distributed.initialize() themselves before importing this
        # library.)
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True
