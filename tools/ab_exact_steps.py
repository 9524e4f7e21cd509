"""Isolate the exact-prefix loop's per-step cost and loop-form overhead.

Times the REAL loop body at bench scale under: while_loop (early exit) vs
fori_loop (fixed trip count), and with progressively trimmed step tables,
to separate per-step compute from loop-form overhead.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from tools._bench_util import timed  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from columba_jax.core import alphabet
    from columba_jax.index.fmindex import FMIndex
    from columba_jax.index import kmer as kmer_mod
    from columba_jax.index.kmer import build_kmer_table, table_k
    from columba_jax.ops import extend
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    genome, reads = bench.build_workload()
    arrays = bench.build_index_cached(genome)
    index = FMIndex.from_arrays(arrays)
    kt = build_kmer_table(index)
    sched = pipeline.compile_cached(get_scheme("kuch1", bench.K),
                                    bench.READ_LEN, "edit",
                                    kmer_k=table_k(kt))
    tbl = pipeline.device_tables(sched)
    B = bench.BATCH
    m = bench.READ_LEN
    b = reads[:B].astype(np.int32)
    rd = jnp.asarray(np.concatenate([b, 3 - b[:, ::-1]]))
    R = 2 * B
    S = sched.num_searches
    L = R * S
    E = sched.e_max
    sw, gate_t = 4, 5

    def seed(rd_, tb):
        rid0 = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)
        kstart = jnp.tile(tb["kmer_start"], R)
        offs = jnp.arange(sched.kmer_k, dtype=jnp.int32)
        wpos = jnp.clip(kstart[:, None], 0, m - sched.kmer_k) + offs
        return kmer_mod.lookup(kt, rd_[rid0[:, None], wpos])

    def prep(rd_, tb):
        ex_pos_l = jnp.tile(tb["ex_pos"], (1, R))
        ex_dir_l = jnp.tile(tb["ex_dir"], (1, R))
        ex_chars = jnp.transpose(
            rd_[:, jnp.clip(tb["ex_pos"], 0, m - 1)], (1, 0, 2)
        ).reshape(E, L).astype(jnp.int32)
        return ex_pos_l, ex_dir_l, ex_chars

    def body_of(idx, ex_pos_l, ex_dir_l, ex_chars):
        def body(t, ranges):
            alive = ranges[:, 1] > ranges[:, 0]
            act = (ex_pos_l[t] >= 0) & alive
            new = extend.extend_char(
                idx, jnp.where(act[:, None], ranges, 0), ex_chars[t],
                ex_dir_l[t])
            new = jnp.where(act[:, None], new, ranges)
            new = jnp.where((new[:, 1] > new[:, 0])[:, None], new, 0)
            width = new[:, 1] - new[:, 0]
            narrow = (width > 0) & (width <= sw) & (t >= gate_t)
            return jnp.where(narrow[:, None], 0, new)
        return body

    # 1) seed-only baseline
    f0 = jax.jit(lambda rd_, tb: seed(rd_, tb))
    t0 = timed(f0, rd, tbl)
    print(f"seed only:             {t0*1e3:8.2f} ms")

    # 2) fori_loop, fixed trip counts
    for nsteps in (2, 6, 12, 24):
        def f(rd_, tb, nsteps=nsteps):
            r0 = seed(rd_, tb)
            pl_, dl_, cl_ = prep(rd_, tb)
            return jax.lax.fori_loop(0, nsteps, body_of(index, pl_, dl_, cl_),
                                     r0)
        t = timed(jax.jit(f), rd, tbl)
        print(f"fori {nsteps:2d} steps:        {t*1e3:8.2f} ms "
              f"({(t-t0)/nsteps*1e3:6.2f} ms/step)")

    # 3) while_loop with early exit (the production form)
    def fw(rd_, tb):
        r0 = seed(rd_, tb)
        pl_, dl_, cl_ = prep(rd_, tb)
        bd = body_of(index, pl_, dl_, cl_)

        def cond(c):
            t, ranges = c
            return (t < E) & jnp.any(ranges[:, 1] > ranges[:, 0])

        def body(c):
            t, ranges = c
            return t + 1, bd(t, ranges)

        t_, r_ = jax.lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), r0))
        return r_, t_
    fwj = jax.jit(fw)
    t = timed(fwj, rd, tbl)
    exit_t = int(fwj(rd, tbl)[1])
    print(f"while (exit at t={exit_t}):   {t*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
