"""A/B the two-stage exact loop (ex_split) and dense-SA locate on the GPU."""

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
    split_step, capacity2 = 2, max(1024, capacity // 16)

    def batch_rows(b):
        rc = alphabet.revcomp(b, axis=-1)
        return jnp.asarray(np.concatenate([b, rc]).astype(np.int32))

    batches = [(index, batch_rows(reads[o:o + B]), kmer_table, tables)
               for o in range(0, 4 * B, B)]

    for name, es, ec in [("ex_split OFF", 0, 0),
                         ("ex_split 8/6144", 8, 6144),
                         ("ex_split 10/4096", 10, 4096),
                         ("ex_split 6/8192", 6, 8192)]:
        def fn(idx, rd, kt, tbl, es=es, ec=ec):
            return pipeline.match_device_core(
                idx, rd, sched, tbl, capacity, 1 << 15, bench.K, kt,
                None, None, 4, 1 << 15, split_step, capacity2, 12288,
                ex_split=es, ex_cap=ec)
        t = timed(jax.jit(fn), batches)
        print(f"{name:18s}: {t*1e3:8.2f} ms/batch  ({B/t:,.0f} reads/s)")


if __name__ == "__main__":
    main()
