"""Device mesh construction for multi-chip TFHE (SURVEY.md section 2.2).

Axes:
  * ``host`` — multi-host sharding (the slow network between hosts, the
    fast interconnect within): batch shards ride it together with ``batch``;
    keys are replicated per host (or row-sharded over ``model`` within a host
    under memory pressure — see ``plan_key_placement``).  Collectives never
    cross hosts in the steady-state batch-parallel path.
  * ``batch`` — independent ciphertexts (DP analog): gates/PBS are
    embarrassingly parallel per ciphertext (src/boolean.rs has zero cross-ct
    coupling), so this axis scales near-linearly with zero steady-state
    collective traffic.
  * ``model`` — the (k+1)*levels decomposed rows / GGSW rows of the external
    product (TP analog): partial int32 accumulators are psum-reduced per CMUX
    step.  Must divide (k+1)*levels (and kN*l_ks for the key switch).
  * ``stage`` — pipeline-parallel blind rotation (parallel/pipeline.py).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

HOST_AXIS = "host"
BATCH_AXIS = "batch"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"


def make_mesh(batch: int | None = None, model: int = 1, devices=None) -> Mesh:
    """Build a (batch, model) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if batch is None:
        batch = len(devices) // model
    assert batch * model == len(devices), (batch, model, len(devices))
    arr = np.array(devices).reshape(batch, model)
    return Mesh(arr, (BATCH_AXIS, MODEL_AXIS))


def make_pipeline_mesh(batch: int | None = None, stage: int = 1, devices=None) -> Mesh:
    """Build a (batch, stage) mesh for pipeline-parallel blind rotation
    (parallel/pipeline.py): DP over ciphertexts x PP over rotation steps."""
    devices = list(devices if devices is not None else jax.devices())
    if batch is None:
        batch = len(devices) // stage
    assert batch * stage == len(devices), (batch, stage, len(devices))
    arr = np.array(devices).reshape(batch, stage)
    return Mesh(arr, (BATCH_AXIS, STAGE_AXIS))


def make_host_mesh(
    host: int | None = None, batch: int | None = None, model: int = 1, devices=None
) -> Mesh:
    """Build a (host, batch, model) mesh.

    In a real multi-process run (``jax.process_count() > 1``) the host axis is
    laid out host-major via ``mesh_utils.create_hybrid_device_mesh`` so that
    ``batch``/``model`` collectives stay within a host and only the host axis
    crosses between hosts.  Single-process (incl. the virtual CPU mesh) falls
    back to a plain reshape with the same axis semantics.
    """
    devices = list(devices if devices is not None else jax.devices())
    if host is None:
        host = jax.process_count()
    if batch is None:
        batch = len(devices) // (host * model)
    assert host * batch * model == len(devices), (host, batch, model, len(devices))
    if jax.process_count() > 1 and host == jax.process_count():
        from jax.experimental import mesh_utils

        arr = mesh_utils.create_hybrid_device_mesh(
            (1, batch, model), (host, 1, 1), devices=devices
        ).reshape(host, batch, model)
    else:
        if jax.process_count() > 1:
            import warnings

            warnings.warn(
                f"make_host_mesh: host={host} != process_count="
                f"{jax.process_count()}; falling back to a plain reshape — "
                "batch/model collectives may cross hosts (correct but slow). "
                "Pass host=jax.process_count() for the host-major layout.",
                stacklevel=2,
            )
        arr = np.array(devices).reshape(host, batch, model)
    return Mesh(arr, (HOST_AXIS, BATCH_AXIS, MODEL_AXIS))


@dataclasses.dataclass(frozen=True)
class KeyPlacement:
    """BK/KSK placement decision for a mesh (SURVEY.md section 2.2 row 5)."""

    shard_bk_rows: bool  #: shard BK rows over ``model`` instead of replicating
    bk_bytes: int  #: canonical BK size
    per_device_key_bytes: int  #: resident key bytes per device after placement
    reason: str


def device_bytes_limit(device) -> int:
    """Device memory this process may fill with arrays, as the runtime
    reports it (``memory_stats()["bytes_limit"]``)."""
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise ValueError(
            f"{device.platform} device reports no memory limit; pass hbm_bytes")
    return stats["bytes_limit"]


def plan_key_placement(
    params, mesh: Mesh, hbm_bytes: int | None = None, budget_frac: float = 0.25
) -> KeyPlacement:
    """Decide BK replication vs model-axis row sharding under a memory budget.

    Policy: keys are replicated per (host, batch) group — the batch-parallel
    path then needs zero steady-state collectives — unless the resident key
    material exceeds ``budget_frac`` of per-device memory (``hbm_bytes``,
    read from the mesh's first device when not given), in which case BK/KSK
    rows shard over ``model`` (per-step u32 psum, bit-exact).  At default_128
    the canonical BK is ~80 MB so replication always wins there; the policy
    matters for wide parameter sets (bigger N / more levels) or many users'
    keys resident at once.
    """
    if hbm_bytes is None:
        hbm_bytes = device_bytes_limit(mesh.devices.flat[0])
    k, n, deg = params.glwe_dimension, params.lwe_dimension, params.degree
    rows = (k + 1) * params.pbs_decomposer.levels
    bk_bytes = n * rows * (k + 1) * deg * 4
    ksk_bytes = k * deg * params.ks_decomposer.levels * (n + 1) * 4
    total = bk_bytes + ksk_bytes
    model_n = dict(mesh.shape).get(MODEL_AXIS, 1)
    budget = int(hbm_bytes * budget_frac)
    if total <= budget or model_n <= 1:
        return KeyPlacement(
            shard_bk_rows=False,
            bk_bytes=bk_bytes,
            per_device_key_bytes=total,
            reason=f"replicated: keys {total/1e6:.0f}MB <= budget {budget/1e6:.0f}MB"
            if total <= budget
            else "replicated: no model axis to shard over",
        )
    return KeyPlacement(
        shard_bk_rows=True,
        bk_bytes=bk_bytes,
        per_device_key_bytes=total // model_n,
        reason=f"row-sharded over model={model_n}: keys {total/1e6:.0f}MB "
        f"> budget {budget/1e6:.0f}MB",
    )


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ciphertext batches: leading axis over ``batch`` (and
    ``host`` when the mesh has one)."""
    if HOST_AXIS in mesh.axis_names:
        return NamedSharding(mesh, P((HOST_AXIS, BATCH_AXIS)))
    return NamedSharding(mesh, P(BATCH_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
