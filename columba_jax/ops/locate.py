"""Batched locate: SA row -> text position via LF-walk to a sampled row.

Batched replacement for the reference's ``findSA``
(reference: src/fmindex/fmindex.cpp:53-60): every lane walks LF until it hits
a marked row (SA[i] % f == 0 sampling guarantees <= f-1 steps), then reads
the sample; all lanes run the fixed f-1 iterations with done-masking.

Rows and text positions are uint32 (see ops/rank.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from columba_jax.index.fmindex import FMIndex
from columba_jax.ops import rank


def lf_step(index: FMIndex, rows: jax.Array) -> jax.Array:
    """LF(row) on the forward BWT, batched.

    The row's own character is decoded from the same block-row fetch that
    serves the occ counts (one 64B gather per lane total)."""
    rows = rows.astype(jnp.uint32)
    occ4, c = rank.occ_all_and_char(index.occ_fused, rows)
    d = rank.cnt_dollar(index.dollar[0], rows)
    occ4 = occ4.at[..., 0].add(-d)  # wrap-safe: occ[0] >= d
    occ_c = occ4[..., 0]
    cnt_c = index.counts[0]
    for i in range(1, 4):
        occ_c = jnp.where(c == i, occ4[..., i], occ_c)
        cnt_c = jnp.where(c == i, index.counts[i], cnt_c)
    lf = cnt_c + occ_c
    return jnp.where(rows == index.dollar[0], jnp.uint32(0), lf)


def locate_rows(index, rows: jax.Array) -> jax.Array:
    """Text position SA[row] for each lane (uint32)."""
    if not isinstance(index, FMIndex):
        from columba_jax.ops import blocate

        return blocate.locate_rows(index, rows)
    rows = rows.astype(jnp.uint32)
    f = index.sa_sparseness
    if f == 1:
        # dense SA: sa_samples IS the suffix array in row order — locate is
        # one gather, no LF-walk (4B/char of device memory buys back
        # ~(f-1) chained gathers per candidate)
        return index.sa_samples[rows]
    steps = jnp.zeros(rows.shape, jnp.uint32)
    cur = rows

    def body(_, state):
        cur, steps = state
        sampled = rank.get_bit(index.sa_bits, cur)
        nxt = lf_step(index, cur)
        cur = jnp.where(sampled, cur, nxt)
        steps = jnp.where(sampled, steps, steps + 1)
        return cur, steps

    cur, steps = jax.lax.fori_loop(0, max(f - 1, 0), body, (cur, steps))
    idx = rank.rank_bits(index.sa_bits, index.sa_bits_rank, cur)
    sval = index.sa_samples[idx]
    return sval + steps
