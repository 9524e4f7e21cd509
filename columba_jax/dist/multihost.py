"""Multi-host scale-out: jax.distributed + per-host readers + global mesh.

The reference has no distributed mode (SURVEY §2.6) — its scale story stops
at pthreads in one process. The scale-out here, one process per host:

- every host calls :func:`initialize` (jax.distributed), then builds the
  same index arrays (or loads the same persisted index) and replicates them
  across the global mesh (``P()``),
- every host reads ITS OWN slice of the input (per-host file sharding:
  batch b belongs to host ``b % num_hosts`` — the distributed analogue of
  the reference's reader thread handing chunks to workers,
  src/fastq.cpp:395-424),
- the data-parallel match step runs over the GLOBAL ``data`` mesh axis
  (dist/mesh.py sharded_match): the hot loop is device-local; NCCL (over
  NVLink within a host, the network between hosts) carries only the
  psum'd counters,
- each host extracts occurrences for its addressable output shards and
  writes its own ordered SAM shard; host 0 concatenates shards in host
  order (ordered output, like the reference's chunkID-ordered writer).

Bytes/s scaling is linear by construction — no cross-host traffic scales
with read count. tools/multihost_dryrun.py runs this end to end with two
local processes on virtual CPU meshes (gloo collectives) and checks
recall + counter reduction; the same program runs unchanged on GPU hosts
with one process per host driving all of its local cards.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, cpu_gloo: bool = False) -> None:
    """jax.distributed.initialize for one host of the job.

    cpu_gloo=True selects the gloo CPU collectives backend — used by the
    local dryrun harness; GPU hosts use the default (NCCL) transport."""
    if cpu_gloo:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh() -> Mesh:
    """1-D data mesh over every device of every host."""
    return Mesh(np.array(jax.devices()), ("data",))


def replicate(mesh: Mesh, tree):
    """Replicate a host-local pytree across the global mesh (P())."""
    sh = NamedSharding(mesh, P())

    def one(x):
        arr = np.asarray(x)
        return jax.make_array_from_process_local_data(sh, arr)

    return jax.tree.map(one, tree)


def shard_batch(mesh: Mesh, local_reads: np.ndarray) -> jax.Array:
    """Host-local (R_local, m) reads -> global (R_global, m) array sharded
    on the data axis; shards are laid out in process order, so global read
    id = host_offset + local id."""
    sh = NamedSharding(mesh, P("data"))
    return jax.make_array_from_process_local_data(
        sh, np.ascontiguousarray(local_reads))


def local_out(out: dict) -> dict:
    """Per-host view of a sharded match output dict: addressable shards
    concatenated (arrays), psum'd scalars fetched."""
    res = {}
    for k, v in out.items():
        if getattr(v, "ndim", 0) == 0:
            res[k] = int(v)
        else:
            shards = sorted(v.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            res[k] = np.concatenate([np.asarray(s.data) for s in shards])
    return res
