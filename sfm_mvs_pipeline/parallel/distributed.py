"""Multi-host runtime: jax.distributed bring-up + host-level work sharding.

The reference has no distributed capability at all (SURVEY.md §2.7 — its
parallelism is one process of OpenMP threads). This module is the
multi-host dimension the new framework adds: process bring-up over the coordinator,
host-local sharding of host-side work (image decode, per-view depth maps),
and cross-host array assembly via jax.make_array_from_process_local_data.

Layering: chips within a host/slice communicate over ICI through the
meshes in parallel/mesh.py; THIS module only decides which host touches
which images/views and initializes the process group. On a single host
everything degrades to no-ops, so the pipeline code is identical either
way.
"""

from __future__ import annotations

import os

import jax
import numpy as np

_INITIALIZED = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Bring up jax.distributed when running multi-process.

    Reads the standard env (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID, or cluster metadata which jax.distributed.initialize
    auto-detects). Returns True when a multi-process group is live. Safe to
    call more than once and in single-process runs (no-op)."""
    global _INITIALIZED
    if _INITIALIZED:
        return jax.process_count() > 1

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        # single-process (or cluster auto-detect explicitly not requested)
        _INITIALIZED = True
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _INITIALIZED = True
    return jax.process_count() > 1


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def host_shard(items: list | np.ndarray, pad: bool = False):
    """The slice of a host-side work list this process owns (round-robin,
    deterministic across hosts). With pad=True every host gets the same
    count (last items repeated) so collectives stay shape-aligned."""
    p, n = jax.process_index(), jax.process_count()
    if n == 1:
        return items
    own = list(items[p::n])
    if pad:
        per = -(-len(items) // n)
        while len(own) < per:
            own.append(own[-1] if own else items[0])
    return own


def assemble_global(mesh, sharding, local_arrays: np.ndarray) -> jax.Array:
    """Build a globally-sharded jax.Array from this process's local shard
    (images this host decoded, descriptors it extracted, ...). Single
    process: a plain device_put with the given sharding."""
    if jax.process_count() == 1:
        return jax.device_put(np.asarray(local_arrays), sharding)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_arrays)
    )


def all_hosts_agree(value: int) -> bool:
    """Cheap cross-host consistency check (e.g. same #images discovered):
    psum of the value must equal value * process_count."""
    if jax.process_count() == 1:
        return True
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    devs = np.asarray(jax.devices()).reshape(jax.process_count(), -1)
    mesh = Mesh(devs, ("host", "chip"))
    f = shard_map(
        lambda x: jax.lax.psum(x, "host"),
        mesh=mesh,
        in_specs=P("host"),
        out_specs=P(),
    )
    arr = jax.make_array_from_process_local_data(
        jax.sharding.NamedSharding(mesh, P("host")),
        np.asarray([value], np.int64),
    )
    return int(np.asarray(f(arr))[0]) == value * jax.process_count()
