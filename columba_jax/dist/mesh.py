"""Multi-chip data parallelism: shard read batches over a device mesh.

The reference's only parallelism is pthread data-parallelism over read
chunks (reference: src/parallel.cpp:88-199); the equivalent here is a flat
1-D ``data`` mesh: the FM-index is **replicated** per device, read batches
are sharded on their leading axis via shard_map, each device runs its own
frontier (compaction stays device-local — no cross-device traffic in the
hot loop), and scalar counters reduce with psum (the analogue of the
reference's chunk->writer Counters merge, src/fastq.cpp:641).

Within a host the cards are joined all to all by NVLink, so the mesh needs
no topology shape. Across hosts the same program runs under
jax.distributed (one process per host) with per-host input feeding of
addressable shards; NCCL carries only the psum'd counters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from columba_jax.index.fmindex import FMIndex
from columba_jax.search import pipeline, schedule


def make_data_mesh(num_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), ("data",))


def sharded_match(
    mesh: Mesh,
    index: FMIndex,
    reads: jax.Array,
    sched: schedule.Schedule,
    capacity_per_shard: int,
    max_locate_per_shard: int,
    kb: int,
    kmer_table: jax.Array | None = None,
    switchpoint: int = 0,
    max_verify_per_shard: int | None = None,
    globalize=None,
):
    """Run the device match step data-parallel over `mesh`.

    reads: (R, m) with R divisible by mesh size. Returns the same dict as
    pipeline.match_device_core with per-shard outputs concatenated on axis 0
    and counters psum'd (replicated scalars). The k-mer seed table (if any)
    is replicated like the index; the in-text crossover and verify sizing
    mirror the single-chip arguments, per shard.

    globalize: optional fn(tree) -> tree that converts host-local arrays to
    globally-replicated ones — required under jax.distributed where every
    jit input must be a global array (dist/multihost.replicate).
    """
    tables = pipeline.device_tables(sched)
    if globalize is not None:
        index = globalize(index)
        tables = globalize(tables)
        if kmer_table is not None:
            kmer_table = globalize(kmer_table)
    ndev = mesh.devices.size
    R = reads.shape[0]
    assert R % ndev == 0, f"batch {R} not divisible by {ndev} devices"
    itv_cap, split_step, cap2 = pipeline.crossover_caps(
        capacity_per_shard, max_locate_per_shard, switchpoint)

    def local(idx, rd, tbl, kt=None):
        out = pipeline.match_device_core(
            idx, rd, sched, tbl,
            capacity_per_shard, max_locate_per_shard, kb,
            kmer_table=kt, switchpoint=switchpoint, itv_cap=itv_cap,
            split_step=split_step, capacity2=cap2,
            max_verify=max_verify_per_shard,
        )
        # per-shard rid is local; globalize using the shard's position
        shard = jax.lax.axis_index("data")
        out["rid"] = out["rid"] + shard * rd.shape[0]
        out["overflow"] = jax.lax.psum(out["overflow"], "data")
        out["nodes_visited"] = jax.lax.psum(out["nodes_visited"], "data")
        out["total"] = jax.lax.psum(out["total"], "data")
        out["n_unique"] = jax.lax.psum(out["n_unique"], "data")
        out["itv_started"] = jax.lax.psum(out["itv_started"], "data")
        out["searches_started"] = jax.lax.psum(out["searches_started"],
                                               "data")
        # keep per-shard arrays sharded; scalars replicated
        return out

    out_specs = dict(
        rid=P("data"), win_start=P("data"), final_rows=P("data"),
        valid=P("data"), total=P(), overflow=P(), nodes_visited=P(),
        n_unique=P(), itv_started=P(), searches_started=P(),
    )
    # check_vma=False: the frontier scan's initial carry is replicated (built
    # from the replicated index) and becomes shard-varying after one step;
    # the vma type-check rejects that even though it is semantically fine.
    if kmer_table is None:
        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(), P("data"), P()),
            out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(fn)(index, reads, tables)
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P("data"), P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)(index, reads, tables, kmer_table)


def sharded_match_jit(mesh, index, reads, scheme, m, metric="edit",
                      capacity_per_shard=4096, max_locate_per_shard=4096):
    """Convenience: compile schedule + run sharded match."""
    sched = pipeline.compile_cached(scheme, m, metric)
    kb = scheme.k if metric == "edit" else 0
    return sharded_match(
        mesh, index, reads, sched, capacity_per_shard,
        max_locate_per_shard, kb,
    )
