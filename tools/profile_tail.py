"""Fine-grained tail profile: frontier / expand / locate / dedup / verify.

Times jitted PREFIXES of match_device_core on the bench workload and
differences them (honest value-fetch fencing; each prefix recomputes the
earlier stages, so differences are the marginal stage costs).
Usage: python tools/profile_tail.py
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
    kb = bench.K

    def batch_rows(b):
        rc = alphabet.revcomp(b, axis=-1)
        return jnp.asarray(np.concatenate([b, rc]).astype(np.int32))

    batches = [(index, batch_rows(reads[o:o + B]), kmer_table, tables)
               for o in range(0, 4 * B, B)]

    def run_front(idx, rd, tbl, kt):
        return executor.run_scheme(idx, rd, sched, capacity, kt, None, None,
                                   switchpoint, max_locate, split_step,
                                   capacity2, tables=tbl)

    def p_frontier(idx, rd, kt, tbl):
        res = run_front(idx, rd, tbl, kt)
        return res.itv_count, res.overflow

    def p_expand(idx, rd, kt, tbl):
        res = run_front(idx, rd, tbl, kt)
        c_lo, c_hi, c_rid, c_estb = pipeline.stage_candidates(res, sched, None)
        rows, cand, valid, total = pipeline.stage_expand(c_lo, c_hi,
                                                         max_locate)
        return rows, total

    def p_locate(idx, rd, kt, tbl):
        res = run_front(idx, rd, tbl, kt)
        c_lo, c_hi, c_rid, c_estb = pipeline.stage_candidates(res, sched, None)
        rows, cand, valid, total = pipeline.stage_expand(c_lo, c_hi,
                                                         max_locate)
        pos = locate.locate_rows(idx, rows)
        return pos, total

    def p_dedup(idx, rd, kt, tbl):
        res = run_front(idx, rd, tbl, kt)
        c_lo, c_hi, c_rid, c_estb = pipeline.stage_candidates(res, sched, None)
        rows, cand, valid, total = pipeline.stage_expand(c_lo, c_hi,
                                                         max_locate)
        pos = locate.locate_rows(idx, rows)
        rid_v, win_v, vlive, n_uniq = pipeline.stage_dedup(
            c_rid[cand], pos + c_estb[cand] - kb, valid, max_locate,
            max_verify)
        return rid_v, n_uniq

    def p_full(idx, rd, kt, tbl):
        return pipeline.match_device_core(
            idx, rd, sched, tbl, capacity, max_locate, kb, kt,
            None, None, switchpoint, max_locate, split_step, capacity2,
            max_verify)

    cuts = [("frontier", p_frontier), ("+expand", p_expand),
            ("+locate", p_locate), ("+dedup", p_dedup), ("full(+ver)", p_full)]
    prev = 0.0
    for name, fn in cuts:
        t = timed(jax.jit(fn), batches)
        print(f"{name:12s} {t*1e3:8.2f} ms/batch   (marginal "
              f"{(t-prev)*1e3:+7.2f} ms)")
        prev = t


if __name__ == "__main__":
    main()
