"""Micro-benchmarks of the hot device ops (run on the GPU).

Measures, per op: lanes/sec and effective device-memory gather bandwidth,
to guide kernel optimization. Usage:
  python tools/microbench.py [--genome N] [--lanes L]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools._bench_util import timed  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--genome", type=int, default=8_000_000)
    p.add_argument("--lanes", type=int, default=1 << 15)
    p.add_argument("--steps", type=int, default=32)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from columba_jax.index.build import build_index_from_codes
    from columba_jax.index.fmindex import FMIndex
    from columba_jax.ops import extend, locate, rank, verify
    from columba_jax.search import pipeline
    from columba_jax.search.scheme import get_scheme

    print("devices:", jax.devices(), file=sys.stderr)
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=args.genome).astype(np.uint8)
    t0 = time.time()
    arrays = build_index_from_codes(genome)
    print(f"index build: {time.time()-t0:.1f}s", file=sys.stderr)
    index = FMIndex.from_arrays(arrays)
    L = args.lanes

    pos = jnp.asarray(rng.integers(0, args.genome, size=L).astype(np.int32))

    # 1) raw occ gather
    f_occ = jax.jit(lambda p: rank.occ_all(index.occ_fused, p))
    dt = timed(f_occ, pos)
    bytes_per = 48  # one fused row
    print(f"occ_all:      {L/dt/1e6:8.1f} Mlanes/s  "
          f"{L*bytes_per/dt/1e9:6.1f} GB/s gather")

    # 2) extend_all (2 occ gathers + arithmetic, 4 children)
    ranges = index.full_range((L,))
    dirs = jnp.asarray((rng.integers(0, 2, size=L)).astype(np.int32))
    f_ext = jax.jit(lambda r, d: extend.extend_all(index, r, d))
    dt = timed(f_ext, ranges, dirs)
    print(f"extend_all:   {L/dt/1e6:8.1f} Mlanes/s  "
          f"{L*2*bytes_per/dt/1e9:6.1f} GB/s gather")

    # 3) chained extension steps (scan) — the executor's memory pattern
    chars = jnp.asarray(rng.integers(0, 4, size=(args.steps, L)).astype(np.int32))

    def chain(r0, cs):
        def body(r, c):
            return extend.extend_char(index, r, c, dirs), None
        r, _ = jax.lax.scan(body, r0, cs)
        return r

    f_chain = jax.jit(chain)
    dt = timed(f_chain, ranges, chars, iters=5)
    per_step = dt / args.steps
    print(f"extend chain: {L/per_step/1e6:8.1f} Mlanes/s/step "
          f"({per_step*1e3:.2f} ms/step at L={L})")

    # 4) locate
    rows = jnp.asarray(rng.integers(0, args.genome, size=L).astype(np.int32))
    f_loc = jax.jit(lambda r: locate.locate_rows(index, r))
    dt = timed(f_loc, rows)
    print(f"locate:       {L/dt/1e6:8.1f} Mlanes/s")

    # 5) verify window (m=100, kb=2)
    reads = jnp.asarray(rng.integers(0, 4, size=(256, 100)).astype(np.int32))
    rid = jnp.asarray(rng.integers(0, 256, size=L).astype(np.int32))
    ws = jnp.asarray(rng.integers(0, args.genome - 200, size=L).astype(np.int32))
    f_ver = jax.jit(lambda r, w: verify.verify_window(index, reads, r, w, 2))
    dt = timed(f_ver, rid, ws, iters=5)
    print(f"verify(k=2):  {L/dt/1e6:8.1f} Mlanes/s")

    # 6) full executor batch (kuch1 k=2, 512 reads x 2 strands)
    B = 512
    g2 = np.asarray(genome)
    starts = rng.integers(0, args.genome - 104, size=B)
    reads_np = np.stack([g2[s:s + 100] for s in starts]).astype(np.int32)
    batch = jnp.asarray(np.concatenate([reads_np, reads_np]))
    scheme = get_scheme("kuch1", 2)
    sched = pipeline.compile_cached(scheme, 100, "edit")
    tables = pipeline.device_tables(sched)
    cap = batch.shape[0] * sched.num_searches
    f_full = jax.jit(lambda idx, rd: pipeline.match_device_core(
        idx, rd, sched, tables, cap, 1 << 14, 2))
    dt = timed(f_full, index, batch, iters=3)
    print(f"full match:   {B/dt:8.1f} reads/s/chip (B={B}, cap={cap}, "
          f"T={sched.t_max})  {dt*1e3:.1f} ms/batch")


if __name__ == "__main__":
    main()
