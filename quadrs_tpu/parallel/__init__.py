"""Multi-chip and multi-host execution.

:mod:`quadrs_tpu.parallel.sharding` — single-process meshes:
time-sharded streaming with halo exchange, stream banks.
:mod:`quadrs_tpu.parallel.distributed` — multi-process bring-up
(``jax.distributed``) and global-mesh array assembly.
"""

from quadrs_tpu.parallel.sharding import (  # noqa: F401
    halo_samples,
    make_mesh,
    make_sharded_stream_step,
    plan_shard_phases,
    replicate_tail,
    shard_chunk,
)
