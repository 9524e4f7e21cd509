"""Ablate the band-step cost at production shapes (C=160k, T=88, bw=9).

Times T-step scans of increasing step-body subsets:
  a) extend_all only (2 fused occ gathers/lane, 4 children)
  b) a + band row update (min-plus DP)
  c) b + colMin registers + prune bound
  d) c + pack + compact (the full structural step, minus meta decode)
  e) the real run_scheme (reference point)
Run on the GPU: python tools/profile_step.py
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
    import jax
    import jax.numpy as jnp

    from columba_jax import compile_cache
    from columba_jax.index.fmindex import FMIndex
    from columba_jax.ops import extend
    from columba_jax.search import executor
    from columba_jax.search.executor import _band_row_update

    compile_cache.enable()
    genome, reads_np = bench.build_workload()
    arrays = bench.build_index_cached(genome)
    index = FMIndex.from_arrays(arrays)

    C = 163840
    T = 88
    bw = 9
    W = 2
    rng = np.random.default_rng(3)
    # realistic ranges: random starts, widths mostly tiny
    n = arrays.n
    width = rng.integers(1, 4, C).astype(np.uint32)
    lo = rng.integers(0, n - 10, C).astype(np.uint32)
    ranges0 = jnp.asarray(
        np.stack([lo, lo + width, lo, lo + width], axis=1))
    band0 = jnp.asarray(rng.integers(0, 5, (C, 2, bw)), jnp.int8)
    colmin0 = jnp.asarray(rng.integers(0, 5, (C, 2, W)), jnp.int8)
    ids0 = jnp.asarray(rng.integers(0, C, C), jnp.int32)
    pchars = jnp.asarray(rng.integers(0, 4, (C * 2, bw)), jnp.int8)

    def scan_a(rngs):
        def body(c, t):
            r = c
            ch = extend.extend_all(index, r, jnp.zeros((C,), jnp.int32))
            r = ch[:, 0, :]
            return r, None
        out, _ = jax.lax.scan(body, rngs, jnp.arange(T))
        return out

    f = jax.jit(scan_a)
    dt = timed(f, ranges0)
    print(f"a) extend only:        {dt*1e3:8.1f} ms  ({dt/T*1e3:6.2f} ms/step)")

    def scan_b(rngs, band):
        def body(c, t):
            r, bd = c
            ch = extend.extend_all(index, r, jnp.zeros((C,), jnp.int32))
            pc = pchars[(t * jnp.ones((C,), jnp.int32)) % (2 * C - C)]
            newD = _band_row_update(bd[:, 0], pc, bw)
            r = ch[:, 0, :]
            bd = bd.at[:, 0].set(newD[:, 0])
            return (r, bd), None
        out, _ = jax.lax.scan(body, (rngs, band), jnp.arange(T))
        return out[0]

    f = jax.jit(scan_b)
    dt = timed(f, ranges0, band0)
    print(f"b) + band DP:          {dt*1e3:8.1f} ms  ({dt/T*1e3:6.2f} ms/step)")

    # d) full structural step: children expand + pack + compact 4C -> C
    def scan_d(rngs, band, colmin, ids):
        def body(c, t):
            r, bd, cm, idv = c
            alive = r[:, 1] > r[:, 0]
            ch = extend.extend_all(index, r, jnp.zeros((C,), jnp.int32))
            pc = pchars[idv % (2 * C - C)]
            newD = _band_row_update(bd[:, 0], pc, bw)
            ch_alive = (ch[..., 1] > ch[..., 0]) & alive[:, None] & (
                jnp.min(newD, axis=-1) <= 4)
            ch_band = jnp.stack(
                [newD, jnp.broadcast_to(bd[:, None, 1], (C, 4, bw))], axis=2)
            ch_cm = jnp.broadcast_to(cm[:, None], (C, 4, 2, W))
            packed = executor._pack_state(
                jnp.where(ch_alive[..., None], ch, 0),
                jnp.broadcast_to(idv[:, None], (C, 4)),
                ch_band, ch_cm, bw, W)
            flat_alive = ch_alive.reshape(-1)
            pos = jnp.cumsum(flat_alive.astype(jnp.int32)) - 1
            dest = jnp.where(flat_alive & (pos < C), pos, C)
            src = jnp.full((C + 1,), 4 * C, jnp.int32)
            src = src.at[dest].set(jnp.arange(4 * C, dtype=jnp.int32),
                                   mode="drop")[:C]
            live = src < 4 * C
            srcc = jnp.where(live, src, 0)
            nw = packed.shape[-1]
            st = jnp.where(live[:, None], packed.reshape(4 * C, nw)[srcc], 0)
            r2, i2, b2, c2 = executor._unpack_state(st, bw, W, 4)
            return (r2, b2, c2, i2), None
        out, _ = jax.lax.scan(body, (rngs, band, colmin, ids),
                              jnp.arange(T))
        return out[0]

    f = jax.jit(scan_d)
    dt = timed(f, ranges0, band0, colmin0, ids0)
    print(f"d) + pack/compact:     {dt*1e3:8.1f} ms  ({dt/T*1e3:6.2f} ms/step)")


if __name__ == "__main__":
    main()
