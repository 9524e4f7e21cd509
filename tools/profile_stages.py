"""Per-stage wall-clock profile of the ALL-mode device step on the bench
workload (run on the GPU, one process per card).

Times jitted prefixes of match_device_core — frontier only, +locate,
+dedup, +verify (= full) — so stage costs fall out by differencing.
Usage: python tools/profile_stages.py [--batches N]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402  (reuses the cached bench workload/index)
from tools._bench_util import timed_batches as timed  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=int, default=4)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from columba_jax.core import alphabet
    from columba_jax.index.fmindex import FMIndex
    from columba_jax.index.kmer import build_kmer_table, table_k
    from columba_jax.ops import locate, verify
    from columba_jax.search import executor, pipeline
    from columba_jax.search.scheme import get_scheme

    genome, reads = bench.build_workload()
    arrays = bench.build_index_cached(genome)
    index = FMIndex.from_arrays(arrays)
    kmer_table = build_kmer_table(index)
    scheme = get_scheme("kuch1", bench.K)
    sched = pipeline.compile_cached(scheme, bench.READ_LEN, "edit",
                                    kmer_k=table_k(kmer_table))
    tables = pipeline.device_tables(sched)
    B = bench.BATCH
    capacity = 4 * B
    max_locate = 1 << 15
    max_verify = 12288
    switchpoint = 4
    split_step, capacity2 = 2, max(1024, capacity // 16)

    def batch_rows(b):
        rc = alphabet.revcomp(b, axis=-1)
        return jnp.asarray(np.concatenate([b, rc]).astype(np.int32))

    # tables must be passed as jit args, not closed over (closure arrays
    # become XLA constants and poison codegen — see executor.host_tables)
    batches = [(index, batch_rows(reads[o:o + B]), kmer_table, tables)
               for o in range(0, args.batches * B, B)]

    def frontier_only(idx, rd, kt, tbl):
        res = executor.run_scheme(idx, rd, sched, capacity, kt, None, None,
                                  switchpoint, max_locate, split_step,
                                  capacity2, tables=tbl)
        return res.ranges, res.itv_count, res.overflow

    full = lambda idx, rd, kt, tbl: pipeline.match_device_core(
        idx, rd, sched, tbl, capacity, max_locate, bench.K, kt,
        None, None, switchpoint, max_locate, split_step, capacity2,
        max_verify)

    t_front = timed(jax.jit(frontier_only), batches)
    t_full = timed(jax.jit(full), batches)

    # locate+dedup+verify cost = full - frontier (frontier recomputed inside
    # full; XLA CSEs nothing across jits, so difference is the tail cost)
    print(f"frontier:          {t_front*1e3:8.2f} ms/batch")
    print(f"full step:         {t_full*1e3:8.2f} ms/batch")
    print(f"tail (loc+dd+ver): {(t_full-t_front)*1e3:8.2f} ms/batch")
    print(f"reads/s (full, {args.batches} batches x{B*2} rows): "
          f"{B/t_full:,.0f}")


if __name__ == "__main__":
    main()
