"""A/B the seed-table K (12 vs 13) on the bench workload (GPU).

K=13 (dense 4^13 x 4 int32 = 1GB HBM) opens the in-text drain gate at
step 2 and kills junk lanes ~1 step earlier than K=12; this measures
whether the shorter exact loop pays for the bigger seed gather.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from tools._bench_util import timed_batches  # noqa: E402


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
    B = bench.BATCH
    capacity = 4 * B

    def batch_rows(b):
        rc = alphabet.revcomp(b, axis=-1)
        return jnp.asarray(np.concatenate([b, rc]).astype(np.int32))

    rows = [batch_rows(reads[o:o + B]) for o in range(0, 4 * B, B)]

    for K in (12, 13):
        t0 = time.time()
        kt = build_kmer_table(index, K)
        int(np.asarray(kt[0, 0]))
        print(f"K={K}: table build {time.time()-t0:.1f}s", file=sys.stderr)
        sched = pipeline.compile_cached(get_scheme("kuch1", bench.K),
                                        bench.READ_LEN, "edit",
                                        kmer_k=table_k(kt))
        tables = pipeline.device_tables(sched)

        def fn(idx, rd, kt_, tbl):
            return pipeline.match_device_core(
                idx, rd, sched, tbl, capacity, 1 << 15, bench.K, kt_,
                None, None, 4, 1 << 15, 2, max(1024, capacity // 16),
                12288)
        f = jax.jit(fn)
        batches = [(index, r, kt, tables) for r in rows]
        t = timed_batches(f, batches)
        out = f(*batches[0])
        print(f"K={K}: {t*1e3:8.2f} ms/batch ({B/t:,.0f} reads/s)  "
              f"total={int(out['total'])} of={int(out['overflow'])}")


if __name__ == "__main__":
    main()
