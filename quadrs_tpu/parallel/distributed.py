"""Multi-host execution: the same sharded streaming step across
processes (SURVEY §5 "Distributed communication backend").

The reference has no networking at all; this counterpart runs one JAX
process per host, joined through ``jax.distributed`` — the device
interconnect inside a host, the network between hosts, both behind the same
``shard_map``.  Nothing in :mod:`quadrs_tpu.parallel.sharding` changes:
:func:`~quadrs_tpu.parallel.sharding.make_mesh` already builds from
``jax.devices()``, which is the *global* device list once
:func:`init_distributed` has run, and the halo ``ppermute`` in
``make_sharded_stream_step`` crosses process boundaries transparently
(Gloo on CPU, NCCL on GPUs).

What this module adds is the host-side plumbing that is different under
multi-process:

* :func:`init_distributed` — process bring-up (coordinator handshake).
* :func:`shard_chunk_global` / :func:`replicate_tail_global` — build
  global arrays where each process supplies only the shards it owns
  (``jax.device_put`` onto a mesh with non-addressable devices is not
  legal; ``jax.make_array_from_callback`` is the multi-process path).
* :func:`addressable_rows` — pull a process's local output shards back
  to its host.

On a CPU rig, test with N virtual devices per process
(``XLA_FLAGS=--xla_force_host_platform_device_count=N`` *before* jax
import) — ``tests/test_distributed.py`` runs the full sharded step over
2 processes this way, with the halo exchange crossing the process
boundary.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
) -> None:
    """Join this process to the global JAX runtime.

    Call before any other jax use.  The three arguments are explicit
    because nothing detects a cluster on its own here: the coordinator
    is ``host:port`` of process 0.  After this, ``jax.devices()`` lists every chip in the
    job and meshes from :func:`quadrs_tpu.parallel.sharding.make_mesh`
    span processes.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def shard_chunk_global(raw: np.ndarray, mesh: Mesh) -> jax.Array:
    """Multi-process :func:`~quadrs_tpu.parallel.sharding.shard_chunk`:
    assemble a global array on ``mesh`` where this process only
    materializes the index ranges its local devices own.  ``raw`` may be
    the full host array (file-backed captures on a shared filesystem) —
    the callback slices out just the local shards."""
    spec = P("stream", None, "time") if raw.ndim == 3 else P("stream", "time")
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(raw.shape, sharding, lambda idx: raw[idx])


def replicate_tail_global(tail: np.ndarray, mesh: Mesh) -> jax.Array:
    """Multi-process :func:`~quadrs_tpu.parallel.sharding.replicate_tail`."""
    sharding = NamedSharding(mesh, P("stream", None, None))
    return jax.make_array_from_callback(tail.shape, sharding, lambda idx: tail[idx])


def addressable_rows(out: jax.Array) -> list[tuple[tuple, np.ndarray]]:
    """This process's output shards as ``(global_index, rows)`` pairs —
    each host consumes the spectrogram windows it computed without an
    all-gather (the serving layout; use
    ``jax.experimental.multihost_utils.process_allgather`` when one host
    needs everything)."""
    return [(s.index, np.asarray(s.data)) for s in out.addressable_shards]
