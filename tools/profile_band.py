"""Profile the -i 0 band path (frontier carries the full load) at k=4.

Splits device time into: exact prefix, frontier scan (run_scheme), and
the locate+verify tail (full match_device_core minus run_scheme), across
capacities — to expose overflow-retry costs and the per-step weight.
Run on the GPU: python tools/profile_band.py [--k 4] [--batch 16384]
"""

from __future__ import annotations

import argparse
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


def timed(fn, *args, iters=3):
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--caps", default="20480,65536,163840,327680")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from columba_jax import compile_cache
    from columba_jax.index.fmindex import FMIndex
    from columba_jax.index.kmer import build_kmer_table, table_k
    from columba_jax.search import executor, pipeline
    from columba_jax.search.scheme import get_scheme

    compile_cache.enable()
    genome, reads_np = bench.build_workload()
    arrays = bench.build_index_cached(genome)
    index = FMIndex.from_arrays(arrays)
    kmer_table = build_kmer_table(index)
    scheme = get_scheme("kuch1", args.k)
    m = bench.READ_LEN
    sched = pipeline.compile_cached(scheme, m, "edit",
                                    kmer_k=table_k(kmer_table))
    tables = pipeline.device_tables(sched)

    B = args.batch
    b = reads_np[:B].astype(np.int32)
    rc = 3 - b[:, ::-1]
    reads = jnp.asarray(np.concatenate([b, rc]))
    R = 2 * B
    S = sched.num_searches
    L = R * S
    print(f"R={R} S={S} L={L} E={sched.e_max} T={sched.t_max} "
          f"bw={sched.bw} W={getattr(sched, 'W', 1)}", file=sys.stderr)

    # survivors after the exact prefix (what capacity must hold at init)
    def surv_probe(idx, rd, kt, tbl):
        res = executor.run_scheme(idx, rd, sched, L, kt, None, None,
                                  0, 0, 0, 0, tables=tbl)
        return (res.searches_started, res.overflow, res.nodes_visited,
                jnp.sum(res.done), res.itv_count)

    f0 = jax.jit(surv_probe)
    out0 = f0(index, reads, kmer_table, tables)
    print(f"[cap=L] searches_started={int(out0[0])} overflow={int(out0[1])}"
          f" nodes={int(out0[2])} done={int(out0[3])} "
          f"harvest={int(out0[4])}")
    dtL = timed(f0, index, reads, kmer_table, tables)
    print(f"run_scheme cap=L={L}: {dtL*1e3:8.1f} ms")

    for cap in (int(c) for c in args.caps.split(",")):
        def fr(idx, rd, kt, tbl, cap=cap):
            res = executor.run_scheme(idx, rd, sched, cap, kt, None, None,
                                      0, 0, 0, 0, tables=tbl)
            return res.nodes_visited, res.overflow, res.searches_started
        f1 = jax.jit(fr)
        o = f1(index, reads, kmer_table, tables)
        dt = timed(f1, index, reads, kmer_table, tables)
        print(f"run_scheme cap={cap:>7}: {dt*1e3:8.1f} ms  "
              f"overflow={int(o[1])}")

    # full device step (frontier + expand + locate + dedup + verify)
    ml = max(1 << 16, 4 * R)
    for cap in (int(c) for c in args.caps.split(",")):
        def full(idx, rd, kt, tbl, cap=cap):
            out = pipeline.match_device_core(
                idx, rd, sched, tbl, cap, ml, args.k, kt, None, None,
                0, 0, 0, 0)
            return out["total"], out["overflow"], out["n_unique"]
        f2 = jax.jit(full)
        o = f2(index, reads, kmer_table, tables)
        dt = timed(f2, index, reads, kmer_table, tables)
        print(f"full cap={cap:>7}: {dt*1e3:8.1f} ms  total={int(o[0])} "
              f"overflow={int(o[1])} n_unique={int(o[2])}")


if __name__ == "__main__":
    main()
