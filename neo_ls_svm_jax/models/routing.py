"""Auto-routing policy: resolve ``pre_transform="auto"`` / ``transfer="auto"``.

Pure policy, no estimator state — split out of ``models/estimator.py`` so the
routing threshold and the resolution rules live in one small reviewable unit.

The reference has no analogue (it has one fixed fit path, ref ``_neo_ls_svm.py``);
this module exists because the fit has two pre-transform lanes (host and on-device).
"""

from __future__ import annotations

# Payload size (n·d·itemsize of the raw feature matrix) from which
# ``pre_transform="auto"`` takes the on-device pre-transform: at 1M×32 f32 the host
# pre-transform's binning and argsorts cost seconds that the device program removes,
# while small fits keep the bit-parity host path. The crossover has not been
# re-measured on the GPU yet.
AUTO_DEVICE_PT_MIN_BYTES = 32 * 1024**2


def _resolve_fit_plan(
    pre_transform: str,
    transfer: str,
    *,
    payload_bytes: int,
    device_pt_eligible: bool,
) -> tuple[str, str]:
    """Resolve ``pre_transform="auto"`` / ``transfer="auto"`` to concrete modes.

    Pure routing policy (unit-tested in ``tests/test_auto_routing.py``):

    - ``pre_transform="auto"`` → ``"device"`` when the fit is eligible for the
      on-device pre-transform (single-chip primal, random-Fourier map with the
      identity complexity matrix) and the feature payload is large enough that the
      host prep dominates (≥ :data:`AUTO_DEVICE_PT_MIN_BYTES`); else the bit-parity
      ``"host"`` path.
    - ``transfer="auto"`` → lossless ``"float32"``. The lossy ``"bfloat16"`` and
      ``"int8"`` uploads are explicit opt-ins only.

    Explicit values pass through untouched — ``pre_transform="host"`` remains the
    documented bit-parity escape hatch.
    """
    resolved_pt = pre_transform
    if pre_transform == "auto":
        resolved_pt = (
            "device"
            if device_pt_eligible and payload_bytes >= AUTO_DEVICE_PT_MIN_BYTES
            else "host"
        )
    resolved_tr = "float32" if transfer == "auto" else transfer
    return resolved_pt, resolved_tr
