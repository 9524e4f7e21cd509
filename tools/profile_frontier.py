"""Split the frontier executor's cost into exact-loop vs band-step phases.

Reconstructs each phase as a standalone jitted probe over the REAL bench
index (so gather locality matches production), with honest value-fetch
fencing. Usage: python tools/profile_frontier.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def fence(x):
    import jax
    import jax.numpy as jnp

    leaf = jax.tree_util.tree_leaves(x)[0]
    return float(jnp.ravel(leaf)[0].astype(jnp.float32))


def timed(fn, *args, iters=5):
    import jax
    import jax.numpy as jnp

    fence(fn(*args))
    tot = jnp.zeros((), jnp.float32)
    t0 = time.time()
    for _ in range(iters):
        leaf = jax.tree_util.tree_leaves(fn(*args))[0]
        tot = tot + jnp.ravel(leaf)[0].astype(jnp.float32)
    float(tot)
    return (time.time() - t0) / iters


def main():
    import jax
    import jax.numpy as jnp

    from columba_jax.index.fmindex import FMIndex
    from columba_jax.index.kmer import build_kmer_table, table_k
    from columba_jax.ops import extend
    from columba_jax.search import executor, pipeline
    from columba_jax.search.scheme import get_scheme

    genome, reads_np = bench.build_workload()
    arrays = bench.build_index_cached(genome)
    index = FMIndex.from_arrays(arrays)
    kmer_table = build_kmer_table(index)
    scheme = get_scheme("kuch1", bench.K)
    sched = pipeline.compile_cached(scheme, bench.READ_LEN, "edit",
                                    kmer_k=table_k(kmer_table))
    tables = pipeline.device_tables(sched)

    B = bench.BATCH
    m = bench.READ_LEN
    b = reads_np[:B].astype(np.int32)
    rc = (3 - b[:, ::-1])
    reads = jnp.asarray(np.concatenate([b, rc]))
    R = 2 * B
    S = sched.num_searches
    L = R * S
    E, T = sched.e_max, sched.t_max
    print(f"L={L} E={E} T={T} S={S}", file=sys.stderr)

    # ---- phase 1 probe: the exact-prefix while_loop exactly as run_scheme
    def exact_probe(idx, rd, kt, tbl):
        rid0 = jnp.repeat(jnp.arange(R, dtype=jnp.int32), S)
        from columba_jax.index import kmer as kmer_mod

        kstart = jnp.tile(tbl["kmer_start"], R)
        offs = jnp.arange(sched.kmer_k, dtype=jnp.int32)
        wpos = jnp.clip(kstart[:, None], 0, m - sched.kmer_k) + offs
        wchars = rd[rid0[:, None], wpos]
        ranges0 = kmer_mod.lookup(kt, wchars)
        ex_pos_l = jnp.tile(tbl["ex_pos"], (1, R))
        ex_dir_l = jnp.tile(tbl["ex_dir"], (1, R))
        ex_chars = jnp.transpose(
            rd[:, jnp.clip(tbl["ex_pos"], 0, m - 1)], (1, 0, 2)
        ).reshape(E, L).astype(jnp.int32)

        def cond(c):
            t, ranges = c
            return (t < E) & jnp.any(ranges[:, 1] > ranges[:, 0])

        def body(c):
            t, ranges = c
            alive = ranges[:, 1] > ranges[:, 0]
            act = (ex_pos_l[t] >= 0) & alive
            new = extend.extend_char(
                idx, jnp.where(act[:, None], ranges, 0), ex_chars[t],
                ex_dir_l[t])
            new = jnp.where(act[:, None], new, ranges)
            new = jnp.where((new[:, 1] > new[:, 0])[:, None], new, 0)
            return t + 1, new

        t, ranges = jax.lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), ranges0))
        return jnp.sum(ranges[:, 1] - ranges[:, 0]), t

    f1 = jax.jit(exact_probe)
    dt = timed(f1, index, reads, kmer_table, tables)
    print(f"exact loop ({E} steps x {L} lanes): {dt*1e3:8.2f} ms "
          f"({dt/E*1e3:.3f} ms/step)")

    # ---- full run_scheme (switchpoint on, as bench) for reference
    capacity = 4 * B
    split_step, capacity2 = 2, max(1024, capacity // 16)

    def fr_probe(idx, rd, kt, tbl):
        res = executor.run_scheme(idx, rd, sched, capacity, kt, None, None,
                                  4, 1 << 15, split_step, capacity2,
                                  tables=tbl)
        return res.nodes_visited, res.searches_started, res.itv_count

    f2 = jax.jit(fr_probe)
    dt2 = timed(f2, index, reads, kmer_table, tables)
    out = f2(index, reads, kmer_table, tables)
    print(f"full frontier: {dt2*1e3:8.2f} ms  "
          f"(=> band+drain {max(dt2-dt,0)*1e3:.2f} ms)")
    print(f"  nodes_visited={int(out[0])} searches_started={int(out[1])} "
          f"itv={int(out[2])}")

    # ---- band-only cost model: vary capacity2 to see the tail's weight
    for c2 in (1024, 2048, 4096):
        def fr2(idx, rd, kt, tbl, c2=c2):
            res = executor.run_scheme(idx, rd, sched, capacity, kt, None,
                                      None, 4, 1 << 15, split_step, c2,
                                      tables=tbl)
            return res.nodes_visited, res.overflow
        f3 = jax.jit(fr2)
        dt3 = timed(f3, index, reads, kmer_table, tables, iters=3)
        ov = int(f3(index, reads, kmer_table, tables)[1])
        print(f"frontier c2={c2}: {dt3*1e3:8.2f} ms  overflow={ov}")


if __name__ == "__main__":
    main()
