"""Row-gather sweep on the GPU.

The frontier executor's cost is dominated by random row gathers from the
occ table (64B rows today; 48B before padding, ROADMAP C1). This measures
XLA's gather with LF-style chained dependencies (next indices depend on the
previous gather, as in real FM extension):

  1. at several row widths (do aligned 64B rows beat 48B rows?)
  2. at several lane counts (does parallelism scale?)

Usage: python tools/gather_bench.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools._bench_util import timed  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    NROWS = 1 << 20
    STEPS = 32
    rng = np.random.default_rng(0)

    print("devices:", jax.devices(), file=sys.stderr)

    for W in (12, 16, 32):
        table = jnp.asarray(
            rng.integers(0, 1 << 30, size=(NROWS, W)).astype(np.uint32))
        for LG in (15, 17, 19):
            L = 1 << LG

            @jax.jit
            def chain(tbl, idx0):
                def body(i, idx):
                    rows = tbl[idx]                      # (L, W) row gather
                    # LF-style dependency: next index derived from the row
                    return (rows[:, 0]
                            + rows[:, W - 1]).astype(jnp.int32) % NROWS
                return jax.lax.fori_loop(0, STEPS, body, idx0)

            idx0 = jnp.asarray(
                rng.integers(0, NROWS, size=L).astype(np.int32))
            dt = timed(chain, table, idx0, iters=3) / STEPS
            print(f"xla  W={W:2d}u32 ({W*4:3d}B) L={L:6d}: "
                  f"{L/dt/1e6:8.1f} Mrows/s  {L*W*4/dt/1e9:6.1f} GB/s "
                  f"({dt*1e3:.3f} ms/step)")


if __name__ == "__main__":
    main()
