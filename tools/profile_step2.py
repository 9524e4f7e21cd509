"""Second-stage band-step ablation: price the step's non-gather pieces and
compare compaction strategies at production shapes (C=131072, T=88, bw=9).

Variants (cumulative unless noted):
  a) extend_all only
  c) a + band DP + colmin regs + prune bound (the compute block)
  d) c + pack + scatter-compact          (the current design)
  d_u) d with unique_indices=True scatters
  d_s) d with sort-based compaction (lax.sort_key_val) instead of scatter
  e) d + harvest-style scatter           (the full structural step)
Run on the GPU: python tools/profile_step2.py
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
    from columba_jax.search.executor import INF, _band_row_update

    compile_cache.enable()
    genome, _ = bench.build_workload()
    arrays = bench.build_index_cached(genome)
    index = FMIndex.from_arrays(arrays)

    C = 131072
    T = 88
    bw = 9
    W = 2
    S = 8
    rng = np.random.default_rng(3)
    n = arrays.n
    width = rng.integers(1, 4, C).astype(np.uint32)
    lo = rng.integers(0, n - 10, C).astype(np.uint32)
    ranges0 = jnp.asarray(np.stack([lo, lo + width, lo, lo + width], axis=1))
    band0 = jnp.asarray(rng.integers(0, 5, (C, 2, bw)), jnp.int8)
    colmin0 = jnp.asarray(rng.integers(0, 5, (C, 2, W)), jnp.int8)
    ids0 = jnp.asarray(rng.integers(0, C, C), jnp.int32)
    pchars = jnp.asarray(rng.integers(0, 4, (2 * C, bw)), jnp.int8)
    M = 1 << 15
    mrow = jnp.asarray(rng.integers(1, 1 << 20, (T, S, 7)), jnp.int32) | 1

    def compute_block(r, bd, cm, idv, meta_row):
        """meta decode + extend + DP + colmin + prune (no state motion)."""
        sid = idv % S
        alive = r[:, 1] > r[:, 0]
        meta = executor.select_by(sid, meta_row[:, 0])
        cops_w = [executor.select_by(sid, meta_row[:, w + 1])
                  for w in range(3)]
        cini_w = [executor.select_by(sid, meta_row[:, w + 4])
                  for w in range(3)]
        cacc_l = (meta >> 2) & 15
        cfro_l = (meta >> 6) & 15
        ub = (meta >> 10) & 255
        act = ((meta & 1) == 1) & alive
        sd = (meta >> 1) & 1
        rngs = jnp.where(act[:, None], r, 0)
        children = extend.extend_all(index, rngs, sd)
        is_b = sd == 0
        prev = jnp.where(is_b[:, None], bd[:, 0], bd[:, 1])
        pc = pchars[idv % (2 * C)]
        newD = _band_row_update(prev, pc, bw)
        cm0, cm1 = cm[:, 0], cm[:, 1]
        cm_sd = jnp.where(is_b[:, None], cm0, cm1)
        cm_other = jnp.where(is_b[:, None], cm1, cm0)
        regs = []
        for w_ in range(W):
            op = (cops_w[w_ // 4] >> (7 * (w_ % 4))) & 127
            cell = op & 63
            rst = (op & 64) == 64
            ini = ((cini_w[w_ // 4] >> (7 * (w_ % 4))) & 127).astype(jnp.int8)
            base = jnp.where(rst, jnp.minimum(jnp.int8(INF), ini),
                             cm_sd[:, w_])
            acc = jnp.full((C, 4), INF, jnp.int8)
            for o_ in range(bw):
                acc = jnp.where((cell == o_)[:, None], newD[:, :, o_], acc)
            regs.append(jnp.where(
                (cell < 63)[:, None],
                jnp.minimum(base[:, None], acc), cm_sd[:, w_][:, None]))
        new_cm_sd = jnp.stack(regs, axis=2)
        widthc = children[..., 1] - children[..., 0]
        rowmin = jnp.min(newD, axis=-1)
        col_contrib = jnp.full((C, 4), INF, jnp.int8)
        cm_other_v = jnp.zeros((C,), jnp.int8)
        for w_ in range(W):
            col_contrib = jnp.where((cacc_l == w_)[:, None],
                                    new_cm_sd[:, :, w_], col_contrib)
            cm_other_v = jnp.where(cfro_l == w_, cm_other[:, w_], cm_other_v)
        bound = (jnp.minimum(rowmin, col_contrib).astype(jnp.int32)
                 + cm_other_v.astype(jnp.int32)[:, None])
        ok = act[:, None] & (widthc > 0) & (bound <= ub[:, None])
        return children, newD, new_cm_sd, ok, act, is_b, alive, cm0, cm1

    def expand_pack(r, bd, cm, idv, children, newD, new_cm_sd, ok, act,
                    is_b, alive, cm0, cm1):
        ch_alive = jnp.where(
            act[:, None], ok,
            jnp.concatenate([alive[:, None], jnp.zeros((C, 3), bool)],
                            axis=1))
        ch_ranges = jnp.where(ch_alive[..., None],
                              jnp.where(act[:, None, None], children,
                                        jnp.broadcast_to(r[:, None],
                                                         (C, 4, 4))), 0)
        band_b = jnp.where((is_b & act)[:, None, None], newD,
                           jnp.broadcast_to(bd[:, None, 0], (C, 4, bw)))
        band_f = jnp.where(((~is_b) & act)[:, None, None], newD,
                           jnp.broadcast_to(bd[:, None, 1], (C, 4, bw)))
        ch_band = jnp.stack([band_b, band_f], axis=2)
        cm_b = jnp.where((is_b & act)[:, None, None], new_cm_sd,
                         jnp.broadcast_to(cm0[:, None], (C, 4, W)))
        cm_f = jnp.where(((~is_b) & act)[:, None, None], new_cm_sd,
                         jnp.broadcast_to(cm1[:, None], (C, 4, W)))
        ch_colmin = jnp.stack([cm_b, cm_f], axis=2)
        ch_packed = executor._pack_state(
            ch_ranges, jnp.broadcast_to(idv[:, None], (C, 4)),
            ch_band, ch_colmin, bw, W)
        return ch_alive, ch_packed

    def compact_scatter(ch_alive, ch_packed, unique=False):
        flat_alive = ch_alive.reshape(-1)
        pos = jnp.cumsum(flat_alive.astype(jnp.int32)) - 1
        dest = jnp.where(flat_alive & (pos < C), pos, C)
        src = jnp.full((C + 1,), 4 * C, jnp.int32)
        src = src.at[dest].set(jnp.arange(4 * C, dtype=jnp.int32),
                               mode="drop", unique_indices=unique)[:C]
        live = src < 4 * C
        srcc = jnp.where(live, src, 0)
        nw = ch_packed.shape[-1]
        return jnp.where(live[:, None],
                         ch_packed.reshape(4 * C, nw)[srcc], 0)

    def compact_sort(ch_alive, ch_packed):
        flat_alive = ch_alive.reshape(-1)
        ar = jnp.arange(4 * C, dtype=jnp.uint32)
        keys = jnp.where(flat_alive, ar, jnp.uint32(4 * C) + ar)
        _, src = jax.lax.sort_key_val(keys, ar)
        src = src[:C].astype(jnp.int32)
        live = src < 4 * C  # always true unless < C alive... mask via keys
        kept = keys[:0]  # unused
        nw = ch_packed.shape[-1]
        alive_c = flat_alive[src]
        return jnp.where(alive_c[:, None],
                         ch_packed.reshape(4 * C, nw)[src], 0)

    def mk_scan(kind):
        def body(c, xs):
            meta_row, t = xs
            r, bd, cm, idv = c
            out = compute_block(r, bd, cm, idv, meta_row)
            if kind == "c":
                children = out[0]
                return (children[:, 0, :], bd, cm, idv), None
            ch_alive, ch_packed = expand_pack(r, bd, cm, idv, *out)
            if kind == "d":
                st = compact_scatter(ch_alive, ch_packed)
            elif kind == "d_u":
                st = compact_scatter(ch_alive, ch_packed, unique=True)
            elif kind == "d_s":
                st = compact_sort(ch_alive, ch_packed)
            elif kind == "e":
                st = compact_scatter(ch_alive, ch_packed)
                # harvest-style scatter priced on top
                died = out[4] & out[6] & ~jnp.any(ch_alive, axis=1)
                hpos = jnp.cumsum(died.astype(jnp.int32)) - 1
                dest_h = jnp.where(died, jnp.minimum(hpos, M), M)
                hrows = jnp.stack([r[:, 0], r[:, 1],
                                   idv.astype(jnp.uint32),
                                   idv.astype(jnp.uint32)], axis=1)
                buf = jnp.zeros((M + 1, 4), jnp.uint32)
                buf = buf.at[dest_h].set(hrows, mode="drop")
                st = st.at[0, 0].add(buf[0, 0] * 0)
            r2, i2, b2, c2 = executor._unpack_state(st, bw, W, 4)
            return (r2, b2, c2, i2), None

        def scan(r, bd, cm, idv):
            out, _ = jax.lax.scan(body, (r, bd, cm, idv),
                                  (mrow, jnp.arange(T)))
            return out[0]
        return scan

    for kind in ("a", "c", "d", "d_u", "d_s", "e"):
        if kind == "a":
            def f_(r):
                def body(c, t):
                    ch = extend.extend_all(index, c,
                                           jnp.zeros((C,), jnp.int32))
                    return ch[:, 0, :], None
                out, _ = jax.lax.scan(body, r, jnp.arange(T))
                return out
            f = jax.jit(f_)
            dt = timed(f, ranges0)
        else:
            f = jax.jit(mk_scan(kind))
            dt = timed(f, ranges0, band0, colmin0, ids0)
        print(f"{kind:>4}: {dt*1e3:8.1f} ms  ({dt/T*1e3:6.2f} ms/step)",
              flush=True)


if __name__ == "__main__":
    main()
