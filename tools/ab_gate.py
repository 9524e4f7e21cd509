"""Sweep in-text crossover gate depth / switchpoint on the bench workload.

With dense-SA locate (1 gather) and fast verify, draining lanes EARLIER
shortens the exact loop (its early exit fires when every lane has died or
crossed over) at the cost of more locate/verify lanes. Finds the best
(itv_min_depth, switchpoint, max_locate, max_verify) point.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from tools._bench_util import timed_batches as timed  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from columba_jax.core import alphabet
    from columba_jax.index.fmindex import FMIndex
    from columba_jax.index.kmer import build_kmer_table, table_k
    from columba_jax.search import pipeline
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
    split_step = 2

    def batch_rows(b):
        rc = alphabet.revcomp(b, axis=-1)
        return jnp.asarray(np.concatenate([b, rc]).astype(np.int32))

    batches = [(index, batch_rows(reads[o:o + B]), kmer_table, tables)
               for o in range(0, 4 * B, B)]

    configs = [
        ("base 16/4", 16, 4, 1 << 15, 12288),
        ("gate14 sw8", 14, 8, 1 << 16, 24576),
        ("gate13 sw8", 13, 8, 1 << 17, 32768),
        ("gate13 sw16", 13, 16, 1 << 17, 49152),
        ("gate15 sw16", 15, 16, 1 << 16, 24576),
    ]
    for name, gate, sw, ml, mv in configs:
        def fn(idx, rd, kt, tbl, gate=gate, sw=sw, ml=ml, mv=mv):
            return pipeline.match_device_core(
                idx, rd, sched, tbl, capacity, ml, bench.K, kt,
                None, None, sw, ml, split_step,
                max(1024, capacity // 16), mv, itv_min_depth=gate)
        f = jax.jit(fn)
        t = timed(f, batches)
        out = f(*batches[0])
        print(f"{name:12s}: {t*1e3:8.2f} ms/batch ({B/t:,.0f} reads/s)  "
              f"total={int(out['total'])} uniq={int(out['n_unique'])} "
              f"of={int(out['overflow'])} "
              f"spill={max(int(out['n_unique']) - mv, 0)}")


if __name__ == "__main__":
    main()
