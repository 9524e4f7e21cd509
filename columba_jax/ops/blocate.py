"""Batched locate on the b-move index: bounded LF-walk to an SA sample.

SA[row] = SA[LF^t(row)] + t for the first t at which the walk lands on a
sampled row. Samples sit at every run head and tail (the reference's
.smpf/.smpl, src/bmove/bmove.cpp:45-189) AND at every LOCATE_STRIDE-th BWT
row (index/bmove.py), so t <= LOCATE_STRIDE no matter how long the runs
are — on the repetitive pan-genomes RLC exists for (r << n, huge runs),
boundary samples alone would make the expected walk (run length)/2. The
reference instead maintains a toehold through every extension and
enumerates ranges by phi-walking bounded by PLCP (bmove.cpp:503-547,
plcp.h:59-130); that is a sequential pointer chase per occurrence list,
while bounded per-row LF-walks are uniform lanes a batch runs in lockstep.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from columba_jax.index.bmove import (
    BMoveIndex, START, END, LF_POS, LF_RUN, SA_FIRST, SA_LAST,
)


def run_of_rows(index: BMoveIndex, rows: jax.Array) -> jax.Array:
    """Binary-search the fwd run interval containing each row."""
    rows = rows.astype(jnp.uint32)
    R = index.r_fwd
    steps = max(1, (R + 1).bit_length())
    lo = jnp.zeros(rows.shape, jnp.int32)
    hi = jnp.full(rows.shape, R - 1, jnp.int32)
    for _ in range(steps):
        mid = (lo + hi + 1) >> 1
        go = index.fused[mid, START] <= rows
        lo = jnp.where(go, mid, lo)
        hi = jnp.where(go, hi, mid - 1)
    return lo


def locate_rows(index: BMoveIndex, rows: jax.Array) -> jax.Array:
    """Text position for each fwd-BWT row (bounded LF-walks), uint32."""
    rows = rows.astype(jnp.uint32)
    runs = run_of_rows(index, rows)
    smask = jnp.uint32(index.stride - 1)

    def at_boundary(pos, run):
        row = index.fused[run]
        head = pos == row[..., START]
        tail = pos == row[..., END] - 1
        strided = (pos & smask) == 0
        val = jnp.where(head, row[..., SA_FIRST], row[..., SA_LAST])
        val = jnp.where(
            strided & ~(head | tail),
            index.sa_stride[(pos >> index.stride.bit_length() - 1
                             ).astype(jnp.int32)],
            val)
        return head | tail | strided, val

    def cond(c):
        pos, run, steps, done, val = c
        return jnp.any(~done)

    def body(c):
        pos, run, steps, done, val = c
        row = index.fused[run]
        new_pos = row[..., LF_POS] + (pos - row[..., START])
        new_run = row[..., LF_RUN].astype(jnp.int32)
        # fast-forward (bounded by interval overlap)
        def ffc(cc):
            r, _ = cc
            return jnp.any(index.fused[r, END]
                           <= jnp.where(done, jnp.uint32(0), new_pos))

        def ffb(cc):
            r, it = cc
            adv = (index.fused[r, END]
                   <= jnp.where(done, jnp.uint32(0), new_pos))
            return jnp.where(adv, r + 1, r), it + 1

        new_run, _ = jax.lax.while_loop(
            ffc, ffb, (jnp.where(done, 0, new_run), jnp.zeros((), jnp.int32)))
        pos = jnp.where(done, pos, new_pos)
        run = jnp.where(done, run, new_run)
        steps = jnp.where(done, steps, steps + 1)
        bnd, v = at_boundary(pos, run)
        nd = done | bnd
        val = jnp.where(done, val, jnp.where(bnd, v + steps, val))
        return pos, run, steps, nd, val

    bnd0, v0 = at_boundary(rows, runs)
    init = (rows, runs, jnp.zeros(rows.shape, jnp.uint32), bnd0,
            jnp.where(bnd0, v0, jnp.uint32(0)))
    _, _, _, _, val = jax.lax.while_loop(cond, body, init)
    n = index.n_arr[0]
    # row for suffix '$' (pos n) maps to n; clamp like the FM path
    return jnp.minimum(val, n)
